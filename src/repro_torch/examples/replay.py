"""Scenario replay on the live serving engine: the two functions of
`benchmarks/bench_serving.py` that `trace_replay` drives.

`replay_trace` plays one Scenario (by default the bundled
"diurnal_week" trace) through the continuous-batching engine with
chatglm3-6b's smoke config: the scenario's arrival track times the
submissions (`workloads.arrival_steps`) and its fault track inflates the
observed service times; with ``export_path`` the run is re-recorded
through `ServingEngine.recorded_trace` and saved, closing the record ->
replay loop.  The rest of the bench module (`bench`,
`bench_scenarios`, `bench_control`) comes with the port's benchmark.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device

ARCH = "chatglm3_6b"


def _run_scenario_once(cfg, prm, prompts, scheduler, spec, label,
                       max_steps=800, device=None):
    """One engine run with scenario-timed arrivals; returns (row, engine)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
    from repro_torch.workloads import arrival_steps

    ecfg = EngineConfig(num_replicas=4, replicas_per_pod=2,
                        slots_per_replica=2, max_len=64,
                        prefill_buckets=(16,), scheduler=scheduler,
                        scenario=spec, scenario_horizon=200)
    eng = ServingEngine(cfg, prm, ecfg, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4, prefix_id=i % 5)
            for i, p in enumerate(prompts)]
    # The scenario's arrival track times the submissions; its fault track
    # (engine playback) inflates observed service times.
    when = arrival_steps(eng.playback, len(reqs),
                         base_per_step=len(reqs) / 60.0)
    nxt = 0
    while any(r.finish_time == 0.0 for r in reqs):
        while nxt < len(reqs) and when[nxt] <= eng.steps:
            eng.submit(reqs[nxt])
            nxt += 1
        eng.step()
        if eng.steps > max_steps:
            raise RuntimeError(
                f"scenario replay did not drain ({scheduler}, {label})")
    row = (f"serve_{scheduler}_scn_{label}", float(eng.steps),
           f"tiers={eng.assign_tiers}")
    return row, eng


def replay_trace(spec=None, scheduler: str = "balanced_pandas",
                 fast: bool = True, export_path: Optional[str] = None,
                 device=None):
    """Replay one trace-compiled Scenario through the live engine.

    `spec` is anything `make_scenario` accepts (default: the bundled
    "diurnal_week" trace).  12 requests of 10 prompt tokens (48 with
    ``fast=False``), weights drawn from ``torch.Generator(dev)`` seeded
    0.  Returns the rows ``[(name, engine steps, tier mix)]``.
    ``device=None`` runs on the card.
    """
    from repro_torch.configs import registry
    from repro_torch.models import params as P
    from repro_torch.workloads import ScenarioConfig, make_scenario, save_trace

    dev = resolve_device(device)
    cfg = registry.get_smoke_config(ARCH)
    prm = P.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    n_req = 12 if fast else 48
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
               for _ in range(n_req)]
    scn = make_scenario(spec if spec is not None
                        else ScenarioConfig("trace", {"max_segments": 32}))
    row, eng = _run_scenario_once(cfg, prm, prompts, scheduler, scn,
                                  scn.name.replace(":", "_"),
                                  max_steps=1200, device=dev)
    if export_path is not None:
        Path(export_path).parent.mkdir(parents=True, exist_ok=True)
        save_trace(eng.recorded_trace(name=scn.name), export_path)
    return [row]
