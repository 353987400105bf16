"""Built-in replica-placement policies (counterpart of
`repro.placement.policies`): uniform (the run without a placement, bit for
bit), HDFS-style rack-aware, max-distance spread, and popularity-aware
variable replication.

Each policy is one class with the two projections of
`repro_torch.placement.policy.PlacementPolicy`:

  * the **simulator sampler** draws a task's replica set per arrival lane
    with fixed shapes (Gumbel-argmax picks over masked logits, Gumbel
    top-k for without-replacement pools) from the draw seam's numbers, for
    any leading cell dimensions, under the slot's scenario knobs
    (``p_hot``, ``hot_rack``, ``rack_weights``), so hot-rack drift moves
    the placement too.  Given the reference's draws (the tests' replay of
    its key splits) each sampler gives the reference's types bit for bit;
  * the **host rule** derives a deterministic replica list per chunk from
    the rendezvous (HRW) ranking, walked against the `Topology` ancestor
    table: stdlib and numpy, copied line for line.

Draws.  ``uniform`` and ``hot_aware`` read the uniform draw's type
Gumbels ``g_type`` (the reference's ``hot_aware`` draws its Gumbels from
the same key); ``hdfs`` and ``spread`` read three blocks of ``g_place``,
one a replica (the reference's ``split(k_rest, 3)``, ``k_rest`` being
uniform's Gumbel key).  Counts and hot uniforms are the same under every
placement.

A kept difference: ``hot_aware`` takes the float32 ``log`` of its
per-server weights ``3 / n_hot`` and ``(r_hot - 3) / n_cold``.  XLA's CPU
``log`` is one ulp off the correctly rounded value at about 8% of float32
inputs, torch's at a few in ten thousand (tools/xla_log_ulp.py), so at
some weights the two logits differ by one ulp: none of the weights of
Topology(24, 6) or (24, (4, 12)), two of the smallest topologies'.  A
one-ulp logit can flip a top-3 only where two lanes' sums lie within
that ulp.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Set

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import locality as loc
from repro_torch.core.locality import NUM_REPLICAS, Topology
from repro_torch.placement.policy import PlacementPolicy, register_placement

_NEG_INF = float("-inf")

# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------


def hrw_ranking(chunk_id: int, num_hosts: int, seed: int) -> List[int]:
    """Rendezvous (HRW) ranking of all hosts for one chunk: every placement
    policy walks this ranking, so placement stays stable under fleet
    resizes (only chunks whose top ranks change move).  The first
    `replication` entries, sorted, are exactly the classic
    `chunk_replicas` assignment."""
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


def _hot_split(u_hot: torch.Tensor, p_hot, hot_rack, rack_of: torch.Tensor,
               rack_weights: Optional[torch.Tensor],
               g_rack: Optional[torch.Tensor]):
    """Shared hot-task assignment: (hot (..., B) bool, in_hot_rack, (M,)
    for one hot rack or (..., B, M) under per-rack weights).  A hot
    lane's rack is `hot_rack`, or under `rack_weights` (R,) the argmax of
    ``log w + g_rack`` over the lane's (..., B, R) Gumbels, as the
    reference's ``categorical`` draws it."""
    hot = u_hot < p_hot
    if rack_weights is None:
        return hot, rack_of == hot_rack
    racks = torch.argmax(g_rack + torch.log(rack_weights), dim=-1)
    return hot, rack_of == racks[..., None]


def _pick(gumbel: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(..., B) Gumbel-argmax draw per row of (..., B, M) logits (uniform
    over the 0-logit support when the rest is masked with -inf)."""
    return torch.argmax(logits + gumbel, dim=-1)


def _primary_logits(hot: torch.Tensor,
                    in_hot_rack: torch.Tensor) -> torch.Tensor:
    """(..., B, M) logits of the primary replica: uniform over the hot
    rack for hot lanes, uniform over the fleet otherwise (the mixture the
    classic sampler applies to all three replicas at once)."""
    inside = torch.where(in_hot_rack, 0.0, _NEG_INF)
    return torch.where(hot[..., None], inside, 0.0)


# ---------------------------------------------------------------------------
# uniform — the run without a placement, bit for bit
# ---------------------------------------------------------------------------


@register_placement
class UniformPlacement(PlacementPolicy):
    """I.i.d.-uniform replicas (the pre-placement default, bitwise-pinned):
    the simulator draws all replicas from the hot-rack mixture at once and
    the host side takes the top rendezvous ranks."""

    name = "uniform"

    def build_sampler(self, topo: Topology, device=None):
        rack_of = torch.as_tensor(np.array(topo.rack_of),
                                  device=resolve_device(device))

        def sample(u_hot, g_type, p_hot, hot_rack=0, rack_weights=None,
                   g_rack=None, g_place=None):
            # the same ops on the same numbers: the run without a placement
            return loc.sample_task_types_at(u_hot, g_type, rack_of, p_hot,
                                            hot_rack, rack_weights, g_rack)
        return sample

    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        return chunk_replicas(chunk_id, spec.num_servers, replication, seed)


# ---------------------------------------------------------------------------
# hdfs — primary + same-rack second + off-rack third
# ---------------------------------------------------------------------------


def _hdfs_expressible(topo: Topology) -> bool:
    return topo.num_racks >= 2 and topo.min_rack_size >= 2


@register_placement
class HdfsPlacement(PlacementPolicy):
    """HDFS-style rack-aware placement: primary, a second replica in the
    primary's rack, and a third off-rack (fault-domain isolation), rack
    meaning the level-0 group of the `Topology` ancestor table at any K.

    A hot task's primary lands in the hot rack, so one replica of every
    hot chunk escapes the hot rack.  On a topology that cannot express
    the rule (a single rack, or a rack of one server) the sampler is
    `uniform`'s and draws no blocks of its own (decided when it is
    built).  Host side: the primary is the chunk's top rendezvous rank;
    the second/third are the top ranks inside / outside its rack;
    replication factors beyond 3 follow the remaining ranking.
    """

    name = "hdfs"

    def gumbel_blocks(self, topo: Topology) -> int:
        return 3 if _hdfs_expressible(topo) else 0

    def build_sampler(self, topo: Topology, device=None):
        if not _hdfs_expressible(topo):
            return UniformPlacement().build_sampler(topo, device)
        dev = resolve_device(device)
        rack_of = torch.as_tensor(np.array(topo.rack_of), device=dev)
        sid = torch.arange(topo.num_servers, device=dev)

        def sample(u_hot, g_type, p_hot, hot_rack=0, rack_weights=None,
                   g_rack=None, g_place=None):
            hot, in_hot_rack = _hot_split(u_hot, p_hot, hot_rack, rack_of,
                                          rack_weights, g_rack)
            g = g_place.unbind(dim=-3)   # one (..., B, M) block a replica
            primary = _pick(g[0], _primary_logits(hot, in_hot_rack))
            same = rack_of == rack_of[primary][..., None]
            not_prim = sid != primary[..., None]
            second = _pick(g[1], torch.where(same & not_prim, 0.0, _NEG_INF))
            third = _pick(g[2], torch.where(same, _NEG_INF, 0.0))
            types = torch.stack([primary, second, third], dim=-1)
            return torch.sort(types, dim=-1).values.to(torch.int32)
        return sample

    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        ranking = hrw_ranking(chunk_id, spec.num_servers, seed)
        if spec.num_racks < 2 or spec.min_rack_size < 2:
            return sorted(ranking[:replication])
        rack = np.asarray(spec.rack_of)
        primary = ranking[0]
        chosen = [primary]
        second = next((h for h in ranking[1:] if rack[h] == rack[primary]),
                      None)
        third = next((h for h in ranking[1:] if rack[h] != rack[primary]),
                     None)
        for h in (second, third):
            if h is not None and len(chosen) < replication:
                chosen.append(h)
        for h in ranking[1:]:  # replication > 3 follows the ranking
            if len(chosen) >= replication:
                break
            if h not in chosen:
                chosen.append(h)
        return sorted(chosen)


# ---------------------------------------------------------------------------
# spread — greedy max-distance anti-affinity
# ---------------------------------------------------------------------------


@register_placement
class SpreadPlacement(PlacementPolicy):
    """Max-distance anti-affinity: after the primary, each replica lands
    uniformly among the servers *farthest* (highest locality tier w.r.t.
    the partial replica set) from the replicas placed so far.

    On the flat-rack topology the three replicas occupy three distinct
    racks; on a pod topology the second crosses pods and the third takes
    the deepest level that still has room; at K=2 it reduces to distinct
    uniform servers.  Host side: walk the chunk's rendezvous ranking
    greedily, accepting each host iff it maximizes the tier w.r.t. the
    hosts already chosen.
    """

    name = "spread"

    def gumbel_blocks(self, topo: Topology) -> int:
        return NUM_REPLICAS

    def build_sampler(self, topo: Topology, device=None):
        dev = resolve_device(device)
        rack_of = torch.as_tensor(np.array(topo.rack_of), device=dev)
        anc = torch.as_tensor(np.array(topo.ancestors), device=dev)

        def sample(u_hot, g_type, p_hot, hot_rack=0, rack_weights=None,
                   g_rack=None, g_place=None):
            hot, in_hot_rack = _hot_split(u_hot, p_hot, hot_rack, rack_of,
                                          rack_weights, g_rack)
            g = g_place.unbind(dim=-3)   # one (..., B, M) block a replica
            chosen = _pick(g[0], _primary_logits(hot, in_hot_rack))[..., None]
            for i in range(1, NUM_REPLICAS):
                # uniform among the servers farthest from the partial set:
                # its (..., B, M) tiers, (..., B, M, i) comparisons a level
                nxt = loc.random_argmax(g[i], loc.server_tiers(chosen, anc))
                chosen = torch.cat([chosen, nxt[..., None]], dim=-1)
            return torch.sort(chosen, dim=-1).values.to(torch.int32)
        return sample

    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        from repro_torch.core.cluster import tier_of
        ranking = hrw_ranking(chunk_id, spec.num_servers, seed)
        chosen = [ranking[0]]
        while len(chosen) < replication:
            best = max(ranking, key=lambda h: (-1 if h in chosen
                                               else tier_of(spec, chosen, h),
                                               -ranking.index(h)))
            if best in chosen:
                break
            chosen.append(best)
        for h in ranking:  # degenerate fleets: fill by rank
            if len(chosen) >= replication:
                break
            if h not in chosen:
                chosen.append(h)
        return sorted(chosen)


# ---------------------------------------------------------------------------
# hot_aware — popularity-skewed replication factor + wider spread
# ---------------------------------------------------------------------------


@register_placement
class HotAwarePlacement(PlacementPolicy):
    """Popularity-aware placement: hot chunks carry a higher replication
    factor ``r_hot`` whose extra replicas are rebalanced off the home
    rack, so a hot task's replica set occasionally escapes the hot rack.

    Simulator projection: a hot chunk keeps `NUM_REPLICAS` home replicas
    in the hot rack plus ``r_hot - NUM_REPLICAS`` rebalanced ones spread
    uniformly over the other racks; a task's type is `NUM_REPLICAS`
    distinct replicas drawn without replacement from that pool (Gumbel
    top-k over the induced per-server weights, on the uniform draw's
    Gumbels).  Cold tasks stay uniform.  Host projection: hot chunks'
    extra replicas walk the rendezvous ranking greedily into racks the
    chunk does not cover yet, padded to ``r_hot`` in the placement map.
    Popularity starts from a deterministic hash prior (`hot_frac` of
    chunks) and `rebalance()` re-derives the hot set from the read counts
    observed via `note_read`.
    """

    name = "hot_aware"

    def __init__(self, r_hot: int = 6, hot_frac: float = 0.125):
        if r_hot < NUM_REPLICAS:
            raise ValueError(f"r_hot must be >= {NUM_REPLICAS}, got {r_hot}")
        if not 0.0 < hot_frac <= 1.0:
            raise ValueError(f"hot_frac must be in (0, 1], got {hot_frac}")
        self.r_hot = int(r_hot)
        self.hot_frac = float(hot_frac)
        self._counts: dict = {}
        self._hot: Optional[Set[int]] = None  # None -> hash prior

    # -- simulator ------------------------------------------------------------
    def build_sampler(self, topo: Topology, device=None):
        dev = resolve_device(device)
        rack_of = torch.as_tensor(np.array(topo.rack_of), device=dev)
        m = topo.num_servers
        f32 = dict(dtype=torch.float32, device=dev)
        # float32 numerators, divided tensor by tensor: ``x / t`` with a
        # Python x is a reciprocal times x in torch, not x's quotient
        home = torch.tensor(float(NUM_REPLICAS), **f32)
        extra = torch.tensor(float(self.r_hot - NUM_REPLICAS), **f32)

        def sample(u_hot, g_type, p_hot, hot_rack=0, rack_weights=None,
                   g_rack=None, g_place=None):
            hot, in_hot_rack = _hot_split(u_hot, p_hot, hot_rack, rack_of,
                                          rack_weights, g_rack)
            n_hot = in_hot_rack.sum(dim=-1, keepdim=True)
            n_cold = torch.clamp(m - n_hot, min=1).to(torch.float32)
            # per-server replica mass: NUM_REPLICAS home replicas share the
            # hot rack, the rebalanced extras share everything else
            w = torch.where(in_hot_rack, home / n_hot.to(torch.float32),
                            torch.where(m - n_hot > 0, extra / n_cold, 0.0))
            logits = torch.where(hot[..., None], torch.log(w), 0.0)
            idx = torch.topk(logits + g_type, NUM_REPLICAS, dim=-1).indices
            return torch.sort(idx, dim=-1).values.to(torch.int32)
        return sample

    # -- host -----------------------------------------------------------------
    def _is_hot(self, chunk_id: int, seed: int) -> bool:
        if self._hot is not None:
            return chunk_id in self._hot
        digest = hashlib.blake2s(f"hot:{seed}:{chunk_id}".encode(),
                                 digest_size=4).digest()
        return int.from_bytes(digest, "big") % 10_000 < self.hot_frac * 10_000

    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        base = chunk_replicas(chunk_id, spec.num_servers, replication, seed)
        if not self._is_hot(chunk_id, seed):
            return base
        rack = np.asarray(spec.rack_of)
        target = max(self.r_hot, replication)
        chosen = list(base)
        for h in hrw_ranking(chunk_id, spec.num_servers, seed):
            if len(chosen) >= target:
                break
            if h not in chosen and rack[h] not in {rack[c] for c in chosen}:
                chosen.append(h)  # rebalanced extras land in uncovered racks
        for h in hrw_ranking(chunk_id, spec.num_servers, seed):
            if len(chosen) >= target:
                break
            if h not in chosen:  # racks exhausted: fill by rank
                chosen.append(h)
        return sorted(chosen)

    def max_replication(self, replication: int) -> int:
        return max(self.r_hot, replication)

    def note_read(self, chunk_id: int) -> None:
        # a plain int: numpy integers as keys would make state_dict() fail
        # json.dumps
        chunk_id = int(chunk_id)
        self._counts[chunk_id] = self._counts.get(chunk_id, 0) + 1

    def state_dict(self):
        # parallel lists keep the chunk ids intact through JSON (dict keys
        # would come back as strings)
        keys = sorted(self._counts)
        return {"count_ids": [int(c) for c in keys],
                "counts": [int(self._counts[c]) for c in keys],
                "hot": None if self._hot is None
                else [int(c) for c in sorted(self._hot)]}

    def load_state_dict(self, s) -> None:
        self._counts = {int(c): int(n)
                        for c, n in zip(s["count_ids"], s["counts"])}
        self._hot = None if s["hot"] is None else {int(c) for c in s["hot"]}

    def rebalance(self) -> int:
        """Recompute the hot set from the observed read counts: the top
        ``hot_frac`` fraction of *observed* chunks (ties broken toward the
        smaller id) become hot.  Deterministic in the count history."""
        if not self._counts:
            return 0
        n_hot = max(1, int(round(self.hot_frac * len(self._counts))))
        ranked = sorted(self._counts, key=lambda c: (-self._counts[c], c))
        new_hot = set(ranked[:n_hot])
        old = self._hot
        self._hot = new_hot
        if old is None:
            return len(new_hot)
        return len(new_hot.symmetric_difference(old))
