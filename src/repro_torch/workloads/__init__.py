"""Scenario subsystem of the port (counterpart of `repro.workloads`):
declarative time-varying workloads, fault injection, and trace-driven
replay.

Consumed by the dense simulator (a compiled `Schedule` on the device),
the serving engine (`HostPlayback`) and the drift study.  See
`repro_torch.workloads.scenario` for the model,
`repro_torch.workloads.library` for the built-in synthetic scenarios,
`repro_torch.workloads.trace` for recorded-trace replay and
`repro_torch.workloads.ingest` for the public cluster-trace loaders.
"""

from repro_torch.workloads.scenario import (  # noqa: F401
    HostPlayback,
    Scenario,
    ScenarioConfig,
    ScenarioLike,
    Schedule,
    Segment,
    SlotKnobs,
    arrival_steps,
    available_scenarios,
    compile_schedule,
    first_doc_line,
    host_playback,
    make_scenario,
    mean_lam_mult_over,
    register_scenario,
    scenario_descriptions,
    slot_knobs,
)
from repro_torch.workloads.trace import (  # noqa: F401
    Incident,
    Trace,
    bundled_traces,
    load_bundled,
    load_trace,
    save_trace,
    synthesize_trace,
    trace_from_arrivals,
    trace_to_scenario,
)
from repro_torch.workloads.ingest import (  # noqa: F401
    ALIBABA_BATCH_TASK_COLUMNS,
    ALIBABA_CONTAINER_COLUMNS,
    GOOGLE_V2_TASK_EVENT_COLUMNS,
    load_alibaba_cluster_csv,
    load_google_cluster_csv,
    save_alibaba_cluster_csv,
    save_google_cluster_csv,
)
