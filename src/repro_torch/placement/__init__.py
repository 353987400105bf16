"""Replica-placement subsystem of the port (counterpart of
`repro.placement`): hierarchy-aware chunk placement driving locality on
the dense simulator and the serving engine.

`PlacementPolicy` (`repro_torch.placement.policy`) projects one placement
rule onto both substrates: a fixed-shape per-task replica sampler for the
dense simulator, fed by the draw seam (`core.rng`), and a deterministic
host-side placement map for the serving engine.  Built-ins
(`repro_torch.placement.policies`): ``uniform`` (the run without a
placement, bit for bit), ``hdfs`` (rack-aware primary/same-rack/off-rack),
``spread`` (greedy max-distance anti-affinity), ``hot_aware``
(popularity-skewed replication factor with deterministic rebalance).
`placement_capacity` (`repro_torch.placement.capacity`) computes the
fluid capacity a placement induces via a sampled-type LP.
"""

from repro_torch.placement.policy import (  # noqa: F401
    PlacementConfig,
    PlacementLike,
    PlacementPolicy,
    available_placements,
    get_placement_cls,
    make_placement,
    placement_descriptions,
    register_placement,
)
from repro_torch.placement.capacity import (  # noqa: F401
    placement_capacity,
    sample_placement_types,
)
from repro_torch.placement.policies import (  # noqa: F401
    UniformPlacement,
    chunk_replicas,
    hrw_ranking,
)
