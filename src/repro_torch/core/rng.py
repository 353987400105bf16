"""The one seam every random draw of the simulators goes through.

Fleet path.  A `DrawSource` yields one `SlotDraws` per slot for N cells
at once (a sweep's (load, error, seed) grid; N = 1 for one run):

    n        -- (N,) the truncated-Poisson arrival count, int64
    u_hot    -- (N, B) uniforms in [0, 1): task b is hot iff u_hot < p_hot
    r        -- (N, B, 3) uniforms for the distinct-3 replica offsets
    u_serve  -- (N, M) uniforms: server m completes iff u_serve < rate_m
    u_cand   -- (N, B, d) uniforms of power-of-d's candidates, or None

Bernoullis are ``u < p``, which is how `jax.random.bernoulli` is built, so
a source that recomputes the reference's uniforms from its key schedule
(the tests' replay source) drives the port through the reference's exact
sample path.  The default `DeviceSource` draws from seeded
`torch.Generator`s on the device (Philox4x32 on CUDA; PyTorch's CPU
generator is a Mersenne twister): one generator per distinct seed and
one block a seed a slot, so a cell's draws depend only on its seed and
the slot, as the reference's keys ``fold_in(PRNGKey(seed), t)`` do.  Its
load enters only through the count, the inverse CDF of its Poisson law
at one uniform.  Cells that share a seed share their arrivals across
loads and errors, and ``fleet_sweep(...)[l, e, s]`` equals
`fleet_simulate` of that cell exactly.

Dense path.  A `DenseSource` yields one `DenseDraws` per slot for N
cells at once (the dense simulator's leading (load, error, seed)
dimension): the arrivals (count, hot uniforms, type Gumbels) and the
draws its policy's `DrawPlan` asks for.  `DenseDeviceSource` keeps three
properties of the reference's key schedule:

1. common random numbers: a seed's arrivals come from a generator that
   policy draws never advance, so they are the same for every policy and
   every error setting, and under every scenario of the same rack-weight
   layout;
2. grid independence: a cell's draws depend only on its seed, the slot
   and its load.  Each seed owns two generators (arrivals, policy) and
   draws a fixed-size block from each per slot; the Poisson count is the
   inverse CDF of the cell's load at one uniform, so it consumes the
   same numbers at every load.  Hence ``sweep(...)[l, e, s]`` equals
   ``simulate(..., seed=seeds[s])`` exactly.  Launch cost per slot: one
   `torch.rand` per generator (2 x the number of distinct seeds) plus
   about 15 launches to gather and transform;
3. nothing is read back to the host inside the slot loop (on both
   paths).

Under a scenario (`workloads.Schedule`) the count's law in slot t is
Poisson(lam x lam_mult) of t's segment: the source keeps one CDF a
(cell, segment), at the float32 product the reference draws its count
at, and picks the slot's row on the device by the schedule's per-slot
segment index; the single uniform and the properties stay.  When the
schedule has per-rack arrival weights (a Python-level fact) the
arrival block grows by the rack Gumbels, (B, R) a cell at its end;
weight-free runs keep their block layout and sample paths bit for bit.

Under a replica placement that draws Gumbels of its own (``hdfs`` and
``spread``: `PlacementPolicy.gumbel_blocks`, three (B, M) blocks, one a
replica) the arrival block grows by those blocks after the rack
Gumbels.  Counts, hot uniforms, type and rack Gumbels keep their places,
so every placement sees the same offered traffic, and policy draws never
advance the arrival generator; ``uniform`` and ``hot_aware`` draw nothing
more, and ``uniform`` is the run without a placement bit for bit.

When the run's replication machinery is engaged (a Python-level fact:
a dynamic controller, or a schedule with a failure track) the source
also yields the chunk each arrival lane reads, ``read`` (N, B): one
uniform a lane through the inverse CDF of the static Zipf law over chunk
ids (float64, computed once a run on the host, as the Poisson CDFs are),
from a third generator per distinct seed, seeded apart from the arrival
and policy generators.  Those two never move, so every other draw keeps
its place, as the reference's dedicated key fold for the reads keeps
its bits.

Under a control plane's load generator (`repro_torch.control`) the count
follows the loadgen, and nothing else moves.  Open loop's
``extra_mult`` folds into each CDF at the reference's float32 product
``(lam x lam_mult) x extra_mult``.  Closed loop's rate in slot t is
``thinking / think_time``, thinking the users not in the system, a
value of the carry: the source cannot know it before the slot.  But it
can only be k / think_time for an integer k in 0..U, U the largest user
count over the schedule, so the source yields ``n_by_k`` (N, U+1), the
count at each k from the slot's one count uniform (U+1 CDFs, built once
a run on the host), and the step gathers the entry at thinking on the
device.  A run without a loadgen keeps its block layout and sample path
bit for bit.
"""

from __future__ import annotations

import abc
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.telemetry import span


def poisson_cdf(lam: float, batch: int) -> np.ndarray:
    """(batch,) float64 P(N <= k), k = 0..batch-1, of Poisson(lam): a
    uniform u gives the truncated count min(N, batch) as
    ``#{k : cdf[k] <= u}``."""
    k = np.arange(batch)
    if lam <= 0.0:
        return np.ones(batch)
    logpmf = k * math.log(lam) - lam - np.array([math.lgamma(i + 1.0)
                                                 for i in k])
    return np.minimum(np.cumsum(np.exp(logpmf)), 1.0)


def _cell_cdf(cells, batch: int, device, lam_mult=None,
              extra_mult: float = 1.0) -> torch.Tensor:
    """(N, batch) Poisson CDFs of the cells' loads; given the S
    multipliers `lam_mult`, (N, S, batch) at the loads times each, the
    product formed in float32 as the reference forms
    ``lam_total * lam_mult``, then times `extra_mult` in float32 (open
    loop's ``(lam_total * lam_mult) * extra_mult``; 1.0 leaves it)."""
    if lam_mult is None:
        return torch.tensor(np.stack([poisson_cdf(float(lam), batch)
                                      for _, lam in cells]), device=device)
    mult = np.asarray(lam_mult, np.float32)
    extra = np.float32(extra_mult)

    def rate(lam, m):
        r = np.float32(lam) * m
        return float(r if extra_mult == 1.0 else r * extra)

    return torch.tensor(np.stack([
        [poisson_cdf(rate(lam, m), batch) for m in mult]
        for _, lam in cells]), device=device)


def closed_loop_rates(users: int, think_time: float) -> np.ndarray:
    """(U+1,) float32 closed-loop rates ``float32(k) / float32(think_time)``
    for k = 0..U, as the reference's compiled step forms them: a product
    with the float32 reciprocal of the float32 think time."""
    recip = np.float32(1.0) / np.float32(think_time)
    return np.arange(users + 1, dtype=np.float32) * recip


def _seed_generators(cells, device, stride: int, offset: int):
    """One generator per distinct seed s of the cells ``[(seed, lam),
    ...]``, seeded ``stride * s + offset``, and each cell's index into
    them (None when cell i draws from generator i)."""
    seeds = sorted({int(s) for s, _ in cells})
    gens = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(stride * s + offset)
        gens.append(g)
    index = [seeds.index(int(s)) for s, _ in cells]
    if index == list(range(len(seeds))):
        return gens, None
    return gens, torch.tensor(index, device=device)


def _cell_block(gens, index: Optional[torch.Tensor], size: int,
                device) -> torch.Tensor:
    """(N, size) uniforms: one `torch.rand` block a generator, gathered
    per cell."""
    rows = [torch.rand((size,), generator=g, device=device) for g in gens]
    blk = rows[0][None] if len(rows) == 1 else torch.stack(rows)
    return blk if index is None else blk[index]


# ---------------------------------------------------------------------------
# Fleet path
# ---------------------------------------------------------------------------


class SlotDraws(NamedTuple):
    """One fleet slot's draws for N cells (see the module docstring)."""

    n: torch.Tensor                 # (N,) int64 arrivals, <= B
    u_hot: torch.Tensor             # (N, B) float32
    r: torch.Tensor                 # (N, B, 3) float32
    u_serve: torch.Tensor           # (N, M) float32
    u_cand: Optional[torch.Tensor] = None  # (N, B, d) float32 (po-d)


class DrawSource(abc.ABC):
    """Per-slot random draws of the fleet simulator."""

    @abc.abstractmethod
    def slot(self, t: int) -> SlotDraws:
        """The draws of slot `t` (slots are asked for in increasing order)."""


class DeviceSource(DrawSource):
    """Draws for the cells ``[(seed, lam), ...]`` from one generator per
    distinct seed on `device`.  Per slot each generator draws one block
    [u_n | u_hot (B) | r (B*3) | u_serve (M) | u_cand (B*cand)], which is
    gathered per cell; a cell's count is the inverse CDF of its load at
    u_n.  `cand` is power-of-d's d (0: no candidates).  The CDFs are
    built in the span ``fleet.setup.cdf``."""

    def __init__(self, cells: Sequence[Tuple[int, float]], batch: int,
                 num_servers: int, device, cand: int = 0):
        dev = self.device = torch.device(device)
        self.gens, self.cell_seed = _seed_generators(cells, dev, 1, 0)
        with span("fleet.setup.cdf"):
            self.cdf = _cell_cdf(cells, batch, dev)
        self.batch, self.m, self.cand = batch, num_servers, cand
        self.size = 1 + 4 * batch + num_servers + batch * cand

    def slot(self, t: int) -> SlotDraws:
        b, m = self.batch, self.m
        blk = _cell_block(self.gens, self.cell_seed, self.size, self.device)
        n = (self.cdf <= blk[:, :1].double()).sum(dim=1)
        u_hot = blk[:, 1:1 + b]
        r = blk[:, 1 + b:1 + 4 * b].view(-1, b, 3)
        u_serve = blk[:, 1 + 4 * b:1 + 4 * b + m]
        u_cand = (blk[:, 1 + 4 * b + m:].view(-1, b, self.cand)
                  if self.cand else None)
        return SlotDraws(n, u_hot, r, u_serve, u_cand)


# ---------------------------------------------------------------------------
# Dense path
# ---------------------------------------------------------------------------


class DrawPlan(NamedTuple):
    """The per-slot draws a dense policy consumes besides the arrivals.

    route -- Gumbels per arrival lane for its random tie-break: "" none,
             "locals" (B, 3) over the task's replicas, "servers" (B, M)
    cand  -- candidates per lane sampled without replacement (po-d); 0 none
    perm  -- a random permutation of the M servers (claim or pop order)
    claim -- (M, M) Gumbels: row i breaks the ties of the i-th claim
    Every plan draws (M,) service uniforms.
    """

    route: str = ""
    cand: int = 0
    perm: bool = False
    claim: bool = False


class DenseDraws(NamedTuple):
    """One slot's draws for N cells (None where the plan has no such
    draw)."""

    n: torch.Tensor                   # (N,) int64 arrivals, <= B
    u_hot: torch.Tensor               # (N, B) float32
    g_type: torch.Tensor              # (N, B, M) type Gumbels
    u_serve: torch.Tensor             # (N, M) float32
    route: Optional[torch.Tensor]     # (N, B, 3) or (N, B, M) Gumbels
    cand: Optional[torch.Tensor]      # (N, B, d) int64 distinct servers
    perm: Optional[torch.Tensor]      # (N, M) int64 permutation
    claim: Optional[torch.Tensor]     # (N, M, M) Gumbels
    g_rack: Optional[torch.Tensor] = None  # (N, B, R) rack Gumbels
    g_place: Optional[torch.Tensor] = None  # (N, P, B, M) placement Gumbels
    read: Optional[torch.Tensor] = None     # (N, B) int64 chunk read a lane
    n_by_k: Optional[torch.Tensor] = None   # (N, U+1) int64 closed-loop count


class DenseSource(abc.ABC):
    """Per-slot random draws of the dense simulator."""

    @abc.abstractmethod
    def slot(self, t: int) -> DenseDraws:
        """The draws of slot `t` (slots are asked for in increasing order)."""


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbels from uniforms in [0, 1) (clamped to (tiny, 1))."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


# seeds of the read generators: ``READ_SEED_BASE + s``, above every
# arrival (2s) and policy (2s + 1) seed of a seed s below 2**61
READ_SEED_BASE = 1 << 62


class DenseDeviceSource(DenseSource):
    """Draws for the cells ``[(seed, lam), ...]`` from seeded generators
    on `device`: per distinct seed, one generator for the arrivals and
    one for the policy (see the module docstring).  `sched` is the run's
    compiled scenario (`workloads.Schedule`), None for the static one;
    `place_blocks` the (B, M) Gumbel blocks the run's placement draws
    (`PlacementPolicy.gumbel_blocks`); `read_cdf` the (C,) float64 CDF of
    the chunk-read law when the replication machinery is engaged (None:
    no reads drawn); `extra_mult` open loop's rate factor and `users`
    closed loop's ``(U, think_time)`` (`count_law` of the run's
    `control.SimControl`; then ``n`` is None and ``n_by_k`` the count
    table)."""

    def __init__(self, cells: Sequence[Tuple[int, float]], plan: DrawPlan,
                 batch: int, num_servers: int, device, sched=None,
                 place_blocks: int = 0, read_cdf=None,
                 extra_mult: float = 1.0, users=None):
        dev = self.device = torch.device(device)
        self.arr_gens, self.cell_seed = _seed_generators(cells, dev, 2, 0)
        self.pol_gens, _ = _seed_generators(cells, dev, 2, 1)
        self.read_gens, self.read_cdf = None, None
        if read_cdf is not None:
            self.read_gens, _ = _seed_generators(cells, dev, 1,
                                                 READ_SEED_BASE)
            self.read_cdf = torch.as_tensor(np.asarray(read_cdf, np.float64),
                                            device=dev)
        self.seg = None   # one CDF a cell (None) or a segment index a slot
        self.cdf_k = None  # closed loop: one CDF a user count k
        if users is not None:
            self.cdf_k = torch.tensor(np.stack([
                poisson_cdf(float(r), batch)
                for r in closed_loop_rates(*users)]), device=dev)
        elif sched is None and extra_mult == 1.0:
            self.cdf = _cell_cdf(cells, batch, dev)
        else:
            mult = [1.0] if sched is None else sched.lam_mult.cpu().numpy()
            self.cdf = _cell_cdf(cells, batch, dev, mult,
                                 extra_mult)  # (N, S, B)
            if sched is None or sched.num_segments == 1:
                self.cdf = self.cdf[:, 0]
            else:
                self.seg = sched.seg
        self.plan, self.batch, self.m = plan, batch, num_servers
        b, m = batch, num_servers
        self.n_rack = (0 if sched is None or sched.rack_weights is None
                       else b * sched.rack_weights.shape[-1])
        self.place_blocks = place_blocks
        # per-slot block layout: arrivals [u_n | u_hot | type Gumbels |
        # rack Gumbels (weighted schedules only) | placement Gumbels];
        # policy [u_serve | route Gumbels | claim Gumbels | perm | cand]
        self.n_route = {"": 0, "locals": b * 3, "servers": b * m}[plan.route]
        self.n_claim = m * m if plan.claim else 0
        self.n_perm = m if plan.perm else 0
        self.n_cand = b * m if plan.cand else 0
        self.n_arr = 1 + b + b * m + self.n_rack + place_blocks * b * m
        self.n_pol = (m + self.n_route + self.n_claim + self.n_perm
                      + self.n_cand)

    def _block(self, gens, size: int) -> torch.Tensor:
        """(N, size) uniforms of one slot: a block from each of `gens`
        (one a distinct seed), gathered per cell."""
        return _cell_block(gens, self.cell_seed, size, self.device)

    def slot(self, t: int) -> DenseDraws:
        b, m, plan = self.batch, self.m, self.plan
        arr = self._block(self.arr_gens, self.n_arr)
        n = n_by_k = None
        if self.cdf_k is not None:
            n_by_k = (self.cdf_k <= arr[:, :1, None].double()).sum(dim=-1)
        else:
            cdf = self.cdf if self.seg is None else \
                self.cdf.index_select(1, self.seg[t:t + 1])[:, 0]
            n = (cdf <= arr[:, :1].double()).sum(dim=1)
        u_hot = arr[:, 1:1 + b]
        g_type = gumbel(arr[:, 1 + b:1 + b + b * m]).view(-1, b, m)
        off = 1 + b + b * m
        g_rack = (gumbel(arr[:, off:off + self.n_rack]).view(len(arr), b, -1)
                  if self.n_rack else None)
        g_place = (gumbel(arr[:, off + self.n_rack:]).view(
            len(arr), self.place_blocks, b, m) if self.place_blocks else None)
        pol = self._block(self.pol_gens, self.n_pol)
        u_serve, rest = pol[:, :m], pol[:, m:]
        nc = len(u_hot)
        g = gumbel(rest[:, :self.n_route + self.n_claim])
        route = g[:, :self.n_route].view(nc, b, -1) if plan.route else None
        claim = g[:, self.n_route:].view(nc, m, m) if plan.claim else None
        rest = rest[:, self.n_route + self.n_claim:]
        perm = torch.argsort(rest[:, :self.n_perm], dim=1, stable=True) \
            if plan.perm else None
        cand = None
        if plan.cand:
            keys = rest[:, self.n_perm:].view(nc, b, m)
            cand = torch.topk(keys, plan.cand, dim=-1).indices
        read = None
        if self.read_gens is not None:
            u = self._block(self.read_gens, b)
            read = torch.clamp(torch.searchsorted(
                self.read_cdf, u.double(), right=True),
                max=len(self.read_cdf) - 1)
        return DenseDraws(n, u_hot, g_type, u_serve, route, cand, perm, claim,
                          g_rack, g_place, read, n_by_k)
