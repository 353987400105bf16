"""Scheduling core of the port: the locality model, the draw seam, the
policy registry and the five dense policies, the simulator entry points
(dense and fleet paths) and the robustness study.  Re-exports the
reference core's public names."""

from repro_torch.core.locality import (  # noqa: F401
    LOCAL, RACK_LOCAL, REMOTE, Rates, Topology, Traffic, capacity_hot_rack,
    pair_tiers, server_tiers, tier_masks,
)
from repro_torch.core.policy import (  # noqa: F401
    Claim, Decision, PolicyConfig, Router, SlotPolicy,
    available_policies, available_routers, get_policy_cls, get_router_cls,
    make_policy, make_router, register_policy, register_router,
)
from repro_torch.core.simulator import (  # noqa: F401
    SimConfig, default_config, make_estimates, simulate, sweep,
)
from repro_torch.core.cluster import (  # noqa: F401
    BalancedPandasRouter, ClusterSpec, FifoRouter, JsqMaxWeightRouter,
    PandasPoDRouter, tier_of,
)
from repro_torch.core.estimator import (  # noqa: F401
    EwmaRateEstimator, ewma_time_update, ewma_update,
)
from repro_torch.core.robustness import (  # noqa: F401
    DRIFT_SCENARIOS, StudyConfig, default_study, drift_study, run_study,
    sensitivity, summarize, summarize_drift,
)
