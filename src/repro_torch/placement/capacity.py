"""Fluid capacity under an arbitrary replica placement (counterpart of
`repro.placement.capacity`).

`locality.capacity_hot_rack` has a water-filling closed form because the
uniform placement confines every hot task's replicas to one rack.  A
placement policy breaks that structure (an `hdfs` hot chunk keeps one
replica off-rack; `spread` scatters all three), so the capacity region is
computed from the *distribution of replica sets* the placement induces:
sample task types from the placement's simulator sampler, collapse them
into type classes, and solve the fluid LP

    max Λ  s.t.  Σ_m x[t, m] = freq_t · Λ          (demand split)
                 Σ_t x[t, m] / r[t, m] ≤ 1          (server utilisation)

where ``r[t, m] = rates[tier of m w.r.t. type t]``.

The port's `sample_placement_types` draws from a seeded `torch.Generator`
on the caller's device; it does not replay JAX's ``PRNGKey(seed)``, so its
capacities agree with the reference's within Monte-Carlo error on the
type frequencies, not bit for bit.  On the same types, `_fluid_lp` is the
reference's LP.

Needs scipy (the LP); callers that may run without it should pass
``strict=False`` and handle the ``None``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.placement.policy import PlacementLike, make_placement

if TYPE_CHECKING:  # annotation-only: `core` imports this package
    from repro_torch.core.locality import Rates, Topology


def sample_placement_types(topo: Topology, placement: PlacementLike,
                           p_hot: float, n_samples: int = 2000,
                           hot_rack: int = 0, seed: int = 0,
                           device=None) -> np.ndarray:
    """(n_samples, NUM_REPLICAS) replica sets drawn from the placement's
    simulator sampler under static knobs, on `device` (None: the card),
    from a generator seeded `seed`: the hot uniforms, then the type
    Gumbels, then the placement's own Gumbel blocks."""
    from repro_torch.core.rng import gumbel
    dev = resolve_device(device)
    plc = make_placement(placement)
    b, m = int(n_samples), topo.num_servers
    blocks = plc.gumbel_blocks(topo)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand((b + (1 + blocks) * b * m,), generator=gen, device=dev)
    g = gumbel(u[b:])
    types = plc.build_sampler(topo, dev)(
        u[:b], g[:b * m].view(b, m), p_hot, hot_rack,
        g_place=g[b * m:].view(blocks, b, m) if blocks else None)
    return types.cpu().numpy()


def _fluid_lp(topo: Topology, rates: np.ndarray, types: np.ndarray) -> float:
    """The fluid LP's Λ* over the sampled `types` (n, NUM_REPLICAS) under
    the (K,) float64 `rates` (needs scipy)."""
    import scipy.optimize as sopt
    import scipy.sparse as ssp

    from repro_torch.core.cluster import worker_tiers
    uniq, counts = np.unique(types, axis=0, return_counts=True)
    freq = counts / counts.sum()
    t_count, m = uniq.shape[0], topo.num_servers
    # (T, M) service rate of each server for each type class
    rate_tm = np.stack([rates[worker_tiers(topo, row.tolist())]
                        for row in uniq])

    # variables: [Λ, x[0,0..M-1], x[1,:], ...] — maximize Λ
    nvar = 1 + t_count * m
    c = np.zeros(nvar)
    c[0] = -1.0
    # demand split: Σ_m x[t, m] - freq_t Λ = 0
    rows = np.repeat(np.arange(t_count), m + 1)
    cols = np.concatenate([np.concatenate(([0], 1 + t * m + np.arange(m)))
                           for t in range(t_count)])
    vals = np.concatenate([np.concatenate(([-freq[t]], np.ones(m)))
                           for t in range(t_count)])
    a_eq = ssp.csr_matrix((vals, (rows, cols)), shape=(t_count, nvar))
    # utilisation: Σ_t x[t, m] / r[t, m] <= 1
    rows = np.tile(np.arange(m), t_count)
    cols = 1 + np.arange(t_count * m)
    vals = (1.0 / rate_tm).ravel()
    a_ub = ssp.csr_matrix((vals, (rows, cols)), shape=(m, nvar))
    res = sopt.linprog(c, A_ub=a_ub, b_ub=np.ones(m), A_eq=a_eq,
                       b_eq=np.zeros(t_count), bounds=(0, None),
                       method="highs")
    if not res.success:
        raise RuntimeError(f"placement fluid LP failed: {res.message}")
    return float(-res.fun)


def placement_capacity(topo: Topology, rates: Union[Rates, Sequence[float]],
                       p_hot: float, placement: PlacementLike,
                       n_samples: int = 2000, hot_rack: int = 0,
                       seed: int = 0, strict: bool = True,
                       device=None) -> Optional[float]:
    """Monte-Carlo fluid capacity Λ* (tasks/slot) under `placement`, its
    types sampled on `device` (None: the card).

    Returns None (instead of raising) when scipy is unavailable and
    ``strict=False``.
    """
    try:
        import scipy.optimize  # noqa: F401
    except ImportError as e:
        if strict:
            raise ImportError(
                "placement_capacity solves a fluid LP and needs scipy, "
                "which is an *optional* dependency of "
                "repro_torch.placement.  Install scipy, or pass "
                "strict=False to get None instead.") from e
        return None
    from repro_torch.core.locality import Rates

    r = np.asarray(rates.values if isinstance(rates, Rates) else rates,
                   np.float64)
    if r.size != topo.num_tiers:
        raise ValueError(f"rates have {r.size} tiers but topology has "
                         f"{topo.num_tiers}")
    types = sample_placement_types(topo, placement, p_hot, n_samples,
                                   hot_rack, seed, device)
    return _fluid_lp(topo, r, types)
