"""The one seam every random draw of the simulators goes through.

Fleet path.  A `DrawSource` yields, per slot and in this order:

    n        -- the truncated-Poisson arrival count, an int64 scalar tensor
    u_hot    -- (B,) uniforms in [0, 1): task b is hot iff u_hot[b] < p_hot
    r        -- (B, 3) uniforms for the distinct-3 replica offsets
    u_serve  -- (M,) uniforms: server m completes iff u_serve[m] < rate_m

Bernoullis are ``u < p``, which is how `jax.random.bernoulli` is built, so
a source that recomputes the reference's uniforms from its key schedule
(the tests' replay source) drives the port through the reference's exact
sample path.  The default `DeviceSource` draws from a seeded
`torch.Generator` on the device: Philox4x32 on CUDA (PyTorch's CPU
generator is a Mersenne twister).  All draws stay on the device; nothing
is read back to the host.

Dense path.  A `DenseSource` yields one `DenseDraws` per slot for N
cells at once (the dense simulator's leading (load, error, seed)
dimension): the arrivals (count, hot uniforms, type Gumbels) and the
draws its policy's `DrawPlan` asks for.  `DenseDeviceSource` keeps three
properties of the reference's key schedule:

1. common random numbers: a seed's arrivals come from a generator that
   policy draws never advance, so they are the same for every policy and
   every error setting;
2. grid independence: a cell's draws depend only on its seed, the slot
   and its load.  Each seed owns two generators (arrivals, policy) and
   draws a fixed-size block from each per slot; the Poisson count is the
   inverse CDF of the cell's load at one uniform, so it consumes the
   same numbers at every load.  Hence ``sweep(...)[l, e, s]`` equals
   ``simulate(..., seed=seeds[s])`` exactly.  Launch cost per slot: one
   `torch.rand` per generator (2 x the number of distinct seeds) plus
   about 15 launches to gather and transform;
3. nothing is read back to the host inside the slot loop.
"""

from __future__ import annotations

import abc
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class SlotDraws(NamedTuple):
    n: torch.Tensor        # () int64 arrivals this slot, <= B
    u_hot: torch.Tensor    # (B,) float32
    r: torch.Tensor        # (B, 3) float32
    u_serve: torch.Tensor  # (M,) float32


class DrawSource(abc.ABC):
    """Per-slot random draws of the fleet simulator."""

    @abc.abstractmethod
    def slot(self, t: int) -> SlotDraws:
        """The draws of slot `t` (slots are asked for in increasing order)."""


class DeviceSource(DrawSource):
    """Draws from one seeded `torch.Generator` on `device`, in slot order."""

    def __init__(self, seed: int, lam: float, batch: int, num_servers: int,
                 device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.lam = torch.tensor(float(lam), dtype=torch.float32,
                                device=self.device)
        self.batch = batch
        self.num_servers = num_servers

    def slot(self, t: int) -> SlotDraws:
        g, dev = self.gen, self.device
        n = torch.poisson(self.lam, generator=g)
        n = torch.clamp(n, max=self.batch).to(torch.int64)
        u_hot = torch.rand((self.batch,), generator=g, device=dev)
        r = torch.rand((self.batch, 3), generator=g, device=dev)
        u_serve = torch.rand((self.num_servers,), generator=g, device=dev)
        return SlotDraws(n, u_hot, r, u_serve)


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


class DenseSource(abc.ABC):
    """Per-slot random draws of the dense simulator."""

    @abc.abstractmethod
    def slot(self, t: int) -> DenseDraws:
        """The draws of slot `t` (slots are asked for in increasing order)."""


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


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbels from uniforms in [0, 1) (clamped to (tiny, 1))."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class DenseDeviceSource(DenseSource):
    """Draws for the cells ``[(seed, lam), ...]`` from seeded generators
    on `device`: per distinct seed, one generator for the arrivals and
    one for the policy (see the module docstring)."""

    def __init__(self, cells: Sequence[Tuple[int, float]], plan: DrawPlan,
                 batch: int, num_servers: int, device):
        dev = self.device = torch.device(device)
        seeds = sorted({int(s) for s, _ in cells})
        self.arr_gens, self.pol_gens = [], []
        for s in seeds:
            for gens, salt in ((self.arr_gens, 0), (self.pol_gens, 1)):
                g = torch.Generator(device=dev)
                g.manual_seed(2 * s + salt)
                gens.append(g)
        self.cell_seed = torch.tensor([seeds.index(int(s)) for s, _ in cells],
                                      device=dev)
        self.cdf = torch.tensor(np.stack([poisson_cdf(float(lam), batch)
                                          for _, lam in cells]), device=dev)
        self.plan, self.batch, self.m = plan, batch, num_servers
        b, m = batch, num_servers
        # per-slot block layout: arrivals [u_n | u_hot | type Gumbels];
        # policy [u_serve | route Gumbels | claim Gumbels | perm | cand]
        self.n_route = {"": 0, "locals": b * 3, "servers": b * m}[plan.route]
        self.n_claim = m * m if plan.claim else 0
        self.n_perm = m if plan.perm else 0
        self.n_cand = b * m if plan.cand else 0
        self.n_arr = 1 + b + b * m
        self.n_pol = (m + self.n_route + self.n_claim + self.n_perm
                      + self.n_cand)

    def _block(self, gens, size: int) -> torch.Tensor:
        rows = [torch.rand((size,), generator=g, device=self.device)
                for g in gens]
        return torch.stack(rows)[self.cell_seed]          # (N, size)

    def slot(self, t: int) -> DenseDraws:
        b, m, plan = self.batch, self.m, self.plan
        arr = self._block(self.arr_gens, self.n_arr)
        n = (self.cdf <= arr[:, :1].double()).sum(dim=1)
        u_hot = arr[:, 1:1 + b]
        g_type = gumbel(arr[:, 1 + b:]).view(-1, b, m)
        pol = self._block(self.pol_gens, self.n_pol)
        u_serve, rest = pol[:, :m], pol[:, m:]
        nc = len(self.cell_seed)
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
        return DenseDraws(n, u_hot, g_type, u_serve, route, cand, perm, claim)
