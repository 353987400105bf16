"""Tier-generic locality model of a data center (paper §2, System Model).

Port of `repro.core.locality`.  The structural parts are numpy and are
copied as they are: `Topology` (a K-level hierarchy server -> rack ->
pod -> ... whose normalized form is the ``(depth, M)`` ancestor table),
`Rates` (strictly decreasing ``(K,)`` tier rates), `Traffic`, and the
hot-rack fluid capacity `capacity_hot_rack` with its `hot_rack_tiers`.
The tensor helpers (`as_ancestors`, `per_server_rates`) are torch.

Capacity (hot-rack traffic).  With a fraction ``p_hot`` of arrivals drawn
with all three local servers inside one rack ("hot" types) and the rest
uniform over all servers, the K-tier fluid capacity is the greedy
water-filling over tier pools: the hot rack serves hot tasks at
``rates[0]``, overflow hot traffic spills to the tier-2 pool at
``rates[2]``, then tier-3, ...; uniform tasks are served locally at
``rates[0]`` anywhere.  For the regime in which pools ``i < j`` are
hot-saturated,

    Lambda_j = (M - sum_{i<j} n_i + sum_{i<j} n_i r_i / r_j)
               / (p_hot / r_j + (1 - p_hot) / rates[0])

and the capacity is the unique consistent regime.

The tier seam of the dense path (`server_tiers`, `tier_masks`,
`pair_tiers`, `pair_rate`, `class_of`, and the legacy `locality_masks`
and `rate_vector`) broadcasts over leading batch dimensions: the dense
simulator carries one row per (load, error, seed) cell.  The samplers
take their random numbers as arguments from the draw seam (`core.rng`):
uniforms for Bernoullis (``u < p``) and Gumbels for the top-k type draw
and the random tie-breaks.  So the reference's key-taking samplers
`sample_task_types` and `sample_arrivals` are left out on purpose: their
draw-seam forms `sample_task_types_at` and `sample_arrivals_at` replace
them.
"""

from __future__ import annotations

import dataclasses
import numbers
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

LOCAL, RACK_LOCAL, REMOTE = 1, 2, 3  # K=3 service classes; 0 == idle / none
NUM_REPLICAS = 3  # Hadoop default: each chunk lives on 3 servers

# One hierarchy level: a uniform group size (int, in servers) or explicit
# per-group sizes (heterogeneous, must tile the fleet).
LevelSpec = Union[int, Sequence[int]]


def _normalize_levels(num_servers: int, spec) -> Tuple[Tuple[int, ...], ...]:
    """Canonical per-level group-size tuples for a `Topology` spec.

    `spec` is the legacy rack size (int), or a sequence of `LevelSpec`s
    ordered from the finest grouping (racks) outward (pods, cores, ...).
    Every level must tile ``num_servers`` exactly and nest inside the next
    (each pod is a union of whole racks).
    """
    if isinstance(spec, numbers.Integral):
        spec = (int(spec),)
    levels = []
    for li, level in enumerate(spec):
        if isinstance(level, numbers.Integral):
            size = int(level)
            if size < 1 or num_servers % size != 0:
                raise ValueError(
                    f"level {li}: group size {size} does not tile "
                    f"num_servers={num_servers}")
            sizes = (size,) * (num_servers // size)
        else:
            sizes = tuple(int(s) for s in level)
            if any(s < 1 for s in sizes):
                raise ValueError(f"level {li}: group sizes must be >= 1, "
                                 f"got {sizes}")
            if sum(sizes) != num_servers:
                raise ValueError(
                    f"level {li}: group sizes {sizes} sum to {sum(sizes)}, "
                    f"do not tile num_servers={num_servers}")
        levels.append(sizes)
    # nesting: every group boundary at level l+1 must align with level l
    for li in range(1, len(levels)):
        inner = np.cumsum(levels[li - 1])
        outer = np.cumsum(levels[li])
        if not set(outer).issubset(set(inner)):
            raise ValueError(
                f"level {li} groups {levels[li]} do not nest on level "
                f"{li - 1} boundaries {levels[li - 1]}")
        if len(levels[li]) >= len(levels[li - 1]):
            raise ValueError(
                f"level {li} must coarsen level {li - 1}: "
                f"{len(levels[li])} groups vs {len(levels[li - 1])}")
    return tuple(levels)


@lru_cache(maxsize=64)
def _ancestor_table(num_servers: int,
                    levels: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    """(depth, M) int32 ancestor-group id per server per level."""
    table = np.empty((len(levels), num_servers), np.int32)
    for li, sizes in enumerate(levels):
        table[li] = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    table.setflags(write=False)
    return table


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static K-level hierarchy of ``num_servers`` servers.

    ``group_sizes`` orders the levels from finest (racks) outward; each
    entry is a uniform size in servers or explicit per-group sizes.  The
    number of locality tiers is ``depth + 2`` (local, one per level,
    remote): ``Topology(M, g)`` is the classic 3-tier rack model,
    ``Topology(M, ())`` a flat 2-tier fleet, ``Topology(M, (g, p))`` a
    4-tier fat-tree pod topology.
    """

    num_servers: int
    group_sizes: Union[int, Sequence[LevelSpec]] = ()

    def __post_init__(self):
        if self.num_servers < 1:
            raise ValueError(f"need num_servers >= 1, got {self.num_servers}")
        levels = _normalize_levels(self.num_servers, self.group_sizes)
        object.__setattr__(self, "group_sizes", levels)

    @property
    def depth(self) -> int:
        """Hierarchy levels above the server (1 for the flat-rack model)."""
        return len(self.group_sizes)

    @property
    def num_tiers(self) -> int:
        """K: local + one tier per level + remote."""
        return self.depth + 2

    @property
    def ancestors(self) -> np.ndarray:
        """(depth, M) int32 ancestor-group id of each server at each level
        (level 0 = rack)."""
        return _ancestor_table(self.num_servers, self.group_sizes)

    def groups_at(self, level: int) -> Tuple[int, ...]:
        """Group sizes (in servers) at hierarchy `level` (0 = rack)."""
        return self.group_sizes[level]

    @property
    def num_racks(self) -> int:
        return len(self.group_sizes[0]) if self.depth else 1

    @property
    def rack_of(self) -> np.ndarray:
        """(M,) rack id of each server (all zero for a depth-0 fleet)."""
        if self.depth:
            return self.ancestors[0]
        return np.zeros(self.num_servers, np.int32)

    @property
    def servers_per_rack(self) -> int:
        """Uniform rack size (raises for heterogeneous racks)."""
        sizes = set(self.group_sizes[0]) if self.depth \
            else {self.num_servers}
        if len(sizes) != 1:
            raise ValueError(f"racks are heterogeneous: "
                             f"{self.group_sizes[0]}; use groups_at(0)")
        return next(iter(sizes))

    @property
    def min_rack_size(self) -> int:
        return min(self.group_sizes[0]) if self.depth else self.num_servers

    # -- legacy host-side aliases (the retired ClusterSpec vocabulary) ------
    @property
    def num_workers(self) -> int:
        """The host-side routers' name for ``num_servers``."""
        return self.num_servers

    @property
    def pod_of(self) -> np.ndarray:
        return self.rack_of


class Rates:
    """Strictly-decreasing service rates per locality tier
    (completion prob/slot): ``Rates(alpha, beta, gamma)`` or
    ``Rates((r0, r1, ..., r_{K-1}))``."""

    __slots__ = ("values",)

    def __init__(self, *values):
        if not values:
            values = (0.5, 0.45, 0.25)  # the paper's defaults
        elif len(values) == 1 and not isinstance(values[0], numbers.Real):
            values = tuple(values[0])
        values = tuple(float(v) for v in values)
        if len(values) < 2:
            raise ValueError(f"need >= 2 tier rates, got {values}")
        ok = all(0.0 < v <= 1.0 for v in values) and \
            all(a > b for a, b in zip(values, values[1:]))
        if not ok:
            raise ValueError(f"need 1 >= r0 > r1 > ... > r_K-1 > 0, "
                             f"got {self.__class__.__name__}{values}")
        object.__setattr__(self, "values", values)

    def __setattr__(self, name, value):  # frozen, like a dataclass
        raise dataclasses.FrozenInstanceError(f"cannot assign to {name!r}")

    @property
    def num_tiers(self) -> int:
        return len(self.values)

    @property
    def alpha(self) -> float:
        return self.values[0]

    @property
    def beta(self) -> float:
        return self.values[1]

    @property
    def gamma(self) -> float:
        return self.values[-1]

    @property
    def heavy_traffic_optimal(self) -> bool:
        """Balanced-PANDAS heavy-traffic delay optimality condition (paper
        §3.2), on the (fastest, second, slowest) tiers."""
        return self.values[1] ** 2 > self.values[0] * self.values[-1]

    def scaled(self, mult: float) -> "Rates":
        """Mis-estimated rates: every tier off by the same multiplier
        (paper §4); clamped into (0, 1] and re-validated."""
        return Rates(tuple(min(v * mult, 1.0) for v in self.values))

    def as_array(self, device=None) -> torch.Tensor:
        """(K,) float32 tensor of the rates (on `device`, CPU by default)."""
        return torch.tensor(self.values, dtype=torch.float32, device=device)

    def __repr__(self) -> str:
        return f"Rates{self.values}"

    def __eq__(self, other) -> bool:
        return isinstance(other, Rates) and self.values == other.values

    def __hash__(self) -> int:
        return hash(("Rates", self.values))


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Arrival process: truncated-Poisson(lam_total) arrivals/slot, each task's
    type = 3 distinct servers sampled from a hot-rack mixture."""

    lam_total: float  # mean arrivals per slot (all types)
    p_hot: float = 0.5  # fraction of tasks whose locals all live in rack 0
    max_arrivals: int = 24  # C_A bound of the paper's model

    def __post_init__(self):
        if not 0.0 <= float(self.p_hot) <= 1.0:
            raise ValueError(f"p_hot must be in [0, 1], got {self.p_hot}")
        if self.max_arrivals < 1:
            raise ValueError(
                f"max_arrivals must be >= 1, got {self.max_arrivals}")
        if float(self.lam_total) < 0.0:
            raise ValueError(f"lam_total must be >= 0, got {self.lam_total}")


# ---------------------------------------------------------------------------
# K-tier fluid capacity (hot-rack traffic)
# ---------------------------------------------------------------------------


def hot_rack_tiers(topo: Topology, hot_rack: int = 0) -> np.ndarray:
    """(M,) tier of each server w.r.t. a task local to rack ``hot_rack``.

    Rack members come out as tier <= 1 (they serve hot tasks at
    ``rates[0]`` under the balanced-scheduler argument in the module
    docstring); everyone else at the tier of their deepest shared group.
    """
    anc = topo.ancestors
    reps = np.flatnonzero(topo.rack_of == hot_rack)
    if reps.size == 0:
        raise ValueError(f"hot_rack={hot_rack} is empty "
                         f"(topology has {topo.num_racks} racks)")
    tier = np.full(topo.num_servers, topo.num_tiers - 1, np.int64)
    for lvl in range(topo.depth - 1, -1, -1):
        tier[np.isin(anc[lvl], np.unique(anc[lvl][reps]))] = lvl + 1
    return tier


def capacity_hot_rack(topo: Topology, rates: Union[Rates, Sequence[float]],
                      p_hot: float, hot_rack: int = 0) -> float:
    """K-tier fluid capacity Lambda* (tasks/slot) for the hot-rack pattern:
    greedy water-filling over tier pools (see module docstring)."""
    r = np.asarray(rates.values if isinstance(rates, Rates) else rates,
                   np.float64)
    k = r.size
    if k != topo.num_tiers:
        raise ValueError(f"rates have {k} tiers but topology has "
                         f"{topo.num_tiers}")
    m = topo.num_servers
    if p_hot <= 0.0:
        return float(m * r[0])
    tier = hot_rack_tiers(topo, hot_rack)
    pools = [(float(r[0]), int(np.sum(tier <= 1)))]
    pools += [(float(r[lvl]), int(np.sum(tier == lvl)))
              for lvl in range(2, k) if np.sum(tier == lvl) > 0]
    used_n = 0.0   # servers in hot-saturated pools
    used_c = 0.0   # hot service capacity of those pools
    for rate_j, n_j in pools:
        lam = (m - used_n + used_c / rate_j) \
            / (p_hot / rate_j + (1.0 - p_hot) / r[0])
        x_j = p_hot * lam - used_c  # hot traffic landing in pool j
        if -1e-9 <= x_j <= n_j * rate_j + 1e-9:
            return float(lam)
        used_n += n_j
        used_c += n_j * rate_j
    raise AssertionError("no consistent fluid regime found")  # unreachable


# ---------------------------------------------------------------------------
# Tensor helpers
# ---------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    """A tensor keeps its device; an array is copied to the CPU."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def as_ancestors(x) -> torch.Tensor:
    """Normalize a legacy (M,) rack map to a (depth, M) int32 ancestor
    table."""
    a = _tensor(x).to(torch.int32)
    return a[None, :] if a.ndim == 1 else a


def per_server_rates(rates, num_servers: int) -> torch.Tensor:
    """Broadcast true service rates to per-server form: (..., M, K)
    float32.

    Accepts the shared ``(K,)`` vector, an ``(M, K)`` matrix, or
    ``(..., M, K)`` rates with leading (cell) dimensions, as the dense
    simulator's replication seam gives them; K is inferred from the
    input.
    """
    r = _tensor(rates).to(torch.float32)
    r = r[None, :] if r.ndim == 1 else r
    return r.expand(*r.shape[:-2], num_servers, r.shape[-1])


# ---------------------------------------------------------------------------
# Tier seam (batched over leading dimensions)
# ---------------------------------------------------------------------------


def server_tiers(task_locals: torch.Tensor,
                 ancestors: torch.Tensor) -> torch.Tensor:
    """(..., M) int32 tier 0..K-1 of every server for each task.

    task_locals: (..., 3) server ids (the task's replicas)
    ancestors:   (depth, M) table (or a legacy (M,) rack map)
    Deepest level first, so the finest shared group wins; a local
    overrides.
    """
    anc = as_ancestors(ancestors).long()
    d, m = anc.shape
    locs = task_locals.long()
    tier = torch.full(locs.shape[:-1] + (m,), d + 1, dtype=torch.int32,
                      device=locs.device)
    for lvl in range(d - 1, -1, -1):
        row = anc[lvl]
        share = (row[:, None] == row[locs][..., None, :]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
    sid = torch.arange(m, device=locs.device)
    local = (sid[:, None] == locs[..., None, :]).any(dim=-1)
    return torch.where(local, 0, tier)


def tier_masks(task_locals: torch.Tensor,
               ancestors: torch.Tensor) -> torch.Tensor:
    """(..., K, M) bool one-hot tier masks (row k: servers at tier k)."""
    anc = as_ancestors(ancestors)
    tiers = server_tiers(task_locals, anc)
    k = torch.arange(anc.shape[0] + 2, dtype=torch.int32,
                     device=tiers.device)
    return tiers[..., None, :] == k[:, None]


def locality_masks(task_locals: torch.Tensor, rack_of: torch.Tensor):
    """Legacy 3-tier view: (local_mask, rack_mask) over (..., M) servers;
    rack_mask excludes locals.  Derived from `server_tiers`."""
    tiers = server_tiers(task_locals, rack_of)
    return tiers == 0, tiers == 1


def rate_vector(task_locals: torch.Tensor, ancestors: torch.Tensor,
                rates_k) -> torch.Tensor:
    """(..., M) per-server service rate for each task under a (K,) rate
    vector."""
    tiers = server_tiers(task_locals, ancestors)
    return _tensor(rates_k).to(tiers.device, torch.float32)[tiers.long()]


def class_of(task_locals: torch.Tensor, ancestors: torch.Tensor,
             server: torch.Tensor) -> torch.Tensor:
    """Service class 1..K of `server` for the task `task_locals`:
    task_locals (..., 3) and server (...) broadcast elementwise."""
    anc = as_ancestors(ancestors).long()
    d = anc.shape[0]
    locs, srv = task_locals.long(), server.long()
    tier = torch.full(torch.broadcast_shapes(locs.shape[:-1], srv.shape),
                      d + 1, dtype=torch.int32, device=locs.device)
    for lvl in range(d - 1, -1, -1):
        row = anc[lvl]
        share = (row[srv][..., None] == row[locs]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
    local = (srv[..., None] == locs).any(dim=-1)
    return torch.where(local, 0, tier) + 1


def pair_tiers(m: torch.Tensor, n: torch.Tensor,
               ancestors: torch.Tensor) -> torch.Tensor:
    """(m,n)-relation tier 0..K-1: 0 if m == n, else 1 + the finest shared
    level, else K-1.  Broadcasts over m and n."""
    anc = as_ancestors(ancestors).long()
    d = anc.shape[0]
    m, n = _tensor(m).long(), _tensor(n).long()
    tier = torch.full(torch.broadcast_shapes(m.shape, n.shape), d + 1,
                      dtype=torch.int32, device=anc.device)
    for lvl in range(d - 1, -1, -1):
        tier = torch.where(anc[lvl][m] == anc[lvl][n], lvl + 1, tier)
    return torch.where(m == n, 0, tier)


def pair_rate(m: torch.Tensor, n: torch.Tensor, ancestors: torch.Tensor,
              rates_k: torch.Tensor) -> torch.Tensor:
    """(m,n)-relation rate: server m pulling from server n's queue at the
    rate of their pair tier.  `rates_k` is a (K,) vector, or (..., K)
    rows whose leading dimensions match the broadcast of m and n."""
    tiers = pair_tiers(m, n, ancestors).long()
    if rates_k.ndim == 1:
        return rates_k[tiers]
    return torch.gather(rates_k, -1, tiers)


# ---------------------------------------------------------------------------
# Arrivals and random tie-breaks, from the draw seam's numbers
# ---------------------------------------------------------------------------


def sample_task_types_at(u_hot: torch.Tensor, gumbel: torch.Tensor,
                         rack_of: torch.Tensor, p_hot, hot_rack=0,
                         rack_weights: Optional[torch.Tensor] = None,
                         g_rack: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(..., B, 3) int32 task types, 3 distinct servers each, sorted.

    u_hot (..., B) uniforms: task b is hot iff ``u_hot < p_hot``; a hot
    task draws its replicas from rack `hot_rack` (an int or a device
    scalar), the rest from all servers.  gumbel (..., B, M): Gumbel top-3
    over the allowed servers (sampling without replacement), as the
    reference does.  With `rack_weights` (R,) a hot task's rack is drawn
    per lane from those weights instead: the argmax of ``log w + g_rack``
    over the lane's (..., B, R) Gumbels, which is how the reference's
    ``categorical`` draws it.
    """
    hot = u_hot < p_hot
    if rack_weights is None:
        in_hot_rack = rack_of == hot_rack                     # (M,)
    else:
        racks = torch.argmax(g_rack + torch.log(rack_weights), dim=-1)
        in_hot_rack = rack_of == racks[..., None]             # (..., B, M)
    inside = torch.where(in_hot_rack, 0.0, float("-inf"))
    logits = torch.where(hot[..., None], inside, 0.0)         # (..., B, M)
    idx = torch.topk(logits + gumbel, NUM_REPLICAS, dim=-1).indices
    return torch.sort(idx, dim=-1).values.to(torch.int32)


def sample_arrivals_at(n: torch.Tensor, u_hot: torch.Tensor,
                       gumbel: torch.Tensor, rack_of: torch.Tensor, p_hot,
                       hot_rack=0, rack_weights: Optional[torch.Tensor] = None,
                       g_rack: Optional[torch.Tensor] = None,
                       type_sampler=None,
                       g_place: Optional[torch.Tensor] = None):
    """One slot of arrivals under the slot's knobs: (types (..., B, 3)
    int32, active (..., B) bool).  `n` (...) is the truncated-Poisson
    count of the slot, drawn by the seam at the slot's rate; lanes
    ``b < n`` are active.

    `type_sampler` is the replica-placement seam (`repro_torch.placement`):
    a compiled ``sample(u_hot, gumbel, p_hot, hot_rack, rack_weights,
    g_rack, g_place)`` that replaces the default i.i.d.-uniform draw,
    reading the placement's Gumbel blocks `g_place`.  The count is the
    same either way, so every placement sees the same offered traffic."""
    batch = u_hot.shape[-1]
    active = torch.arange(batch, device=u_hot.device) < n[..., None]
    if type_sampler is None:
        types = sample_task_types_at(u_hot, gumbel, rack_of, p_hot, hot_rack,
                                     rack_weights, g_rack)
    else:
        types = type_sampler(u_hot, gumbel, p_hot, hot_rack, rack_weights,
                             g_rack, g_place)
    return types, active


def random_argmin(gumbel: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """(...,) int64 argmin over the last dimension with a uniformly random
    tie-break among exact minima: the largest Gumbel among them (paper:
    ties are broken randomly)."""
    is_min = score == score.amin(dim=-1, keepdim=True)
    return torch.argmax(torch.where(is_min, gumbel, float("-inf")), dim=-1)


def random_argmax(gumbel: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """argmax over the last dimension, random tie-break as `random_argmin`."""
    is_max = score == score.amax(dim=-1, keepdim=True)
    return torch.argmax(torch.where(is_max, gumbel, float("-inf")), dim=-1)
