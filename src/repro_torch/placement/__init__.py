"""Replica placement of the port (counterpart of `repro.placement`):
the host-side uniform rendezvous placement the serving engine uses by
default.  The other placements (hdfs, spread, hot_aware), the simulator
samplers and the capacity LP come with the placement slice of the port."""

from repro_torch.placement.policies import (  # noqa: F401
    UniformPlacement,
    chunk_replicas,
    hrw_ranking,
    make_placement,
)
