"""Host-side replica placement (counterpart of the host half of
`repro.placement.policies`; copied: stdlib hashing, no JAX).

Each chunk (a prefix id, for the serving engine) lives on the hosts at
the top of its rendezvous (HRW) ranking, so any two hosts agree on every
chunk's placement without coordination.
"""

from __future__ import annotations

import hashlib
from typing import List

from repro_torch.core.locality import Topology


def hrw_ranking(chunk_id: int, num_hosts: int, seed: int) -> List[int]:
    """Rendezvous (HRW) ranking of all hosts for one chunk: placement
    stays stable under fleet resizes (only chunks whose top ranks change
    move).  The first `replication` entries, sorted, are exactly the
    classic `chunk_replicas` assignment."""
    scores = []
    for h in range(num_hosts):
        digest = hashlib.blake2s(
            f"{seed}:{chunk_id}:{h}".encode(), digest_size=8).digest()
        scores.append((int.from_bytes(digest, "big"), h))
    scores.sort(reverse=True)
    return [h for _, h in scores]


def chunk_replicas(chunk_id: int, num_hosts: int, replication: int,
                   seed: int) -> List[int]:
    """Classic uniform rendezvous placement."""
    return sorted(hrw_ranking(chunk_id, num_hosts, seed)[:replication])


class UniformPlacement:
    """I.i.d.-uniform replicas: the host side takes the top rendezvous
    ranks (the reference's default placement, host projection)."""

    name = "uniform"

    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        return chunk_replicas(chunk_id, spec.num_servers, replication, seed)


def make_placement(spec=None) -> UniformPlacement:
    """None or "uniform" (or a `UniformPlacement`) -> the uniform
    placement; anything else raises until the placement slice of the port
    adds the other placements."""
    if spec is None or spec == "uniform":
        return UniformPlacement()
    if isinstance(spec, UniformPlacement):
        return spec
    raise NotImplementedError(
        f"placement {spec!r} is not ported yet: only 'uniform' is; the "
        f"others come with the placement slice of the port")
