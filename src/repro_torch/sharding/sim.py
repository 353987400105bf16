"""Fleet-scale path of the discrete-time simulator (10k+ servers).

Port of `repro.sharding.sim`: the same discrete-time model and metrics
keys as the dense simulator, with O(B + M·depth) work per slot.

* **Arrivals** — O(B) distinct-3 sampler (uniform-offset trick) instead
  of (B, M) Gumbel top-k; same task-type law as the dense path.
* **Routing** — one workload snapshot per round.  The private phase (every
  tier better than remote) is either the fused CUDA kernel
  (`kernels.ops.fleet_route`) or the exact per-level segment-min
  (`_private_route_segmin`); both equal the dense oracle
  `kernels.ref.fleet_route` bit for bit, ties to the lowest index.
* **The remote pool** — solved as a water-filling fixed point: server m
  enters the pool at score p_m = W_m/r_m - r_m*1e-6 and each absorbed
  task raises it by d_m = 1/r_m^2; the water level is bisected, and the
  r-th private claimant of a server stays private only while
  s_priv + r/rate^2 <= y (the rank clamp).  `FleetConfig.rounds` retry
  passes let collision overflow land on its next-best private option.
* **Randomness** — every draw comes from a `core.rng.DrawSource`, in the
  order n, u_hot, r, u_serve per slot; the replay source of the tests
  recomputes the reference's draws, which makes the whole carry equal to
  the reference's after every slot.

The slot loop runs on the host, one slot per iteration, with no host
read of a device value inside it (no `.item()`, no Python branch on a
tensor), so chunks of slots can later be captured in CUDA graphs.
Supported: Balanced-PANDAS, static scenario, uniform placement, static
replication, no telemetry.  `pandas_po2` (`_route_batch_po2`) and
`fleet_sweep` come with a later slice and raise until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import balanced_pandas as bp
from repro_torch.core import locality as loc
from repro_torch.core.policy import PolicyLike, policy_name
from repro_torch.core.rng import DeviceSource, DrawSource, SlotDraws
from repro_torch.kernels import ops as kops
from repro_torch.kernels.slot_step import check_anc_ranges

# Auto-engagement floor for core.simulator's ``fleet=None``: paper-scale
# configurations stay on the dense path; fleet-sized topologies switch.
FLEET_AUTO_THRESHOLD = 1024

_SUPPORTED_POLICIES = ("balanced_pandas", "pandas_po2")
_LATER = "comes with a later slice of the port"

# carry = (q (M,K) int32, serving (M,) int32, mean_n f32, n_meas f32,
#          completions int32), the reference's fleet carry
Carry = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of the fleet path.

    rounds     -- private-routing retry passes per slot: each pass commits
                  the clamp winners and the losers re-route against the
                  updated workload
    fill_iters -- bisection iterations for the pool water level
    use_kernel -- force the CUDA `fleet_route` kernel on/off (None: on
                  exactly when the device is CUDA; off, the private phase
                  is the segment-min form)
    """

    rounds: int = 2
    fill_iters: int = 32
    use_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.fill_iters < 8:
            raise ValueError(f"fill_iters must be >= 8 for a usable water "
                             f"level, got {self.fill_iters}")


FleetLike = Union[None, bool, FleetConfig]


def as_fleet_config(spec: FleetLike) -> FleetConfig:
    """None/True -> defaults; a FleetConfig passes through."""
    if isinstance(spec, FleetConfig):
        return spec
    return FleetConfig()


@dataclasses.dataclass(frozen=True)
class FleetCtx:
    """Static per-topology constants of the slot loop, on its device."""

    num_servers: int
    num_tiers: int
    depth: int
    group_counts: Tuple[int, ...]   # groups per level
    hot_rack_size: int              # rack 0 size (M for a depth-0 fleet)
    anc: torch.Tensor               # (depth, M) int32, the kernel's input
    gids: Tuple[torch.Tensor, ...]  # per-level (M,) int64 group-id rows


def make_ctx(topo: loc.Topology, device) -> FleetCtx:
    table = np.array(topo.ancestors)
    check_anc_ranges(table)   # the fleet_route kernel's precondition
    anc = torch.as_tensor(table, device=device)  # int32
    return FleetCtx(
        num_servers=topo.num_servers,
        num_tiers=topo.num_tiers,
        depth=topo.depth,
        group_counts=tuple(len(topo.group_sizes[l])
                           for l in range(topo.depth)),
        hot_rack_size=(topo.group_sizes[0][0] if topo.depth
                       else topo.num_servers),
        anc=anc,
        gids=tuple(anc[l].long() for l in range(topo.depth)),
    )


def fleet_supported(policy_like: PolicyLike, cfg, scenario=None,
                    placement=None, replication=None,
                    telemetry=None) -> Optional[str]:
    """None when the fleet path can run this configuration, else the
    reason it cannot (the dense path must be used).  The default seams
    may be given by name ("static", "uniform", "fixed")."""
    name = policy_name(policy_like)
    if name not in _SUPPORTED_POLICIES:
        return (f"policy {name!r} has no fleet step "
                f"(supported: {_SUPPORTED_POLICIES})")
    if telemetry is not None and telemetry is not False:
        return "telemetry recorders require the dense in-scan step"
    if scenario not in (None, "static"):
        return "only the static scenario is fleet-compiled"
    if placement not in (None, "uniform"):
        return "only uniform placement has a fleet sampler"
    if replication not in (None, "fixed"):
        return "dynamic replication rides the dense scan carry"
    if cfg.topo.num_servers < loc.NUM_REPLICAS:
        return "need at least NUM_REPLICAS servers"
    return None


# ---------------------------------------------------------------------------
# O(B) arrival sampling (distinct-3 via the uniform-offset trick)
# ---------------------------------------------------------------------------


def _sample_arrivals(draws: SlotDraws, ctx: FleetCtx, p_hot: torch.Tensor,
                     batch: int):
    """(types (B,3) int32 sorted, active (B,) bool) — the reference's
    arrival law (truncated Poisson count; hot tasks replica-set inside
    rack 0, the rest uniform) from this slot's uniforms."""
    dev = draws.u_hot.device
    active = torch.arange(batch, device=dev) < draws.n
    hot = draws.u_hot < p_hot
    size = torch.where(hot, ctx.hot_rack_size, ctx.num_servers
                       ).to(torch.float32)
    r = draws.r
    x0 = torch.minimum(torch.floor(r[:, 0] * size), size - 1)
    x1 = torch.minimum(torch.floor(r[:, 1] * (size - 1)), size - 2)
    x1 = x1 + (x1 >= x0)
    lo, hi = torch.minimum(x0, x1), torch.maximum(x0, x1)
    x2 = torch.minimum(torch.floor(r[:, 2] * (size - 2)), size - 3)
    x2 = x2 + (x2 >= lo)
    x2 = x2 + (x2 >= hi)
    types = torch.stack([x0, x1, x2], dim=1).to(torch.int32)
    return torch.sort(types, dim=1).values, active


# ---------------------------------------------------------------------------
# Private-phase routing: exact per-level segment-min / fused kernel
# ---------------------------------------------------------------------------


def _segment_argmin(score: torch.Tensor, gid: torch.Tensor, ngroups: int,
                    m: int):
    """Per-group (min, lowest index achieving it) by scatter-reduce amin."""
    dev = score.device
    gmin = torch.full((ngroups,), float("inf"), dtype=score.dtype,
                      device=dev).scatter_reduce(0, gid, score, "amin")
    hit = score == gmin[gid]
    sid = torch.arange(score.shape[0], device=dev)
    gidx = torch.full((ngroups,), m, dtype=torch.int64, device=dev
                      ).scatter_reduce(0, gid,
                                       torch.where(hit, sid, m), "amin")
    return gmin, gidx


def _private_route_segmin(w: torch.Tensor, est: torch.Tensor, ctx: FleetCtx,
                          locs: torch.Tensor):
    """Exact private argmin per task from per-level group minima.

    Level l's candidate scores every member of a local's level-l group at
    the tier-(l+1) rate.  A member whose true tier is shallower scores
    strictly lower at its true tier (rates decrease in the tier, and the
    -rate*1e-6 term favours the faster tier), and that score is itself a
    candidate at the shallower level; so combining levels, locals first,
    by lexicographic (score, server) reproduces the dense oracle's
    lowest-index argmin exactly, cross-tier ties included.
    """
    m = ctx.num_servers
    locs = locs.long()
    e0 = est[:, 0]
    sc_loc = w[locs] / e0[locs] - e0[locs] * 1e-6            # (B, 3)
    best_v = sc_loc.min(dim=1).values
    hit = sc_loc == best_v[:, None]
    best_i = torch.where(hit, locs, m).min(dim=1).values
    best_t = torch.zeros_like(best_i)
    for lvl in range(ctx.depth):
        rate = est[:, lvl + 1]
        sc = w / rate - rate * 1e-6                          # (M,)
        gmin, gidx = _segment_argmin(sc, ctx.gids[lvl],
                                     ctx.group_counts[lvl], m)
        tg = ctx.gids[lvl][locs]                             # (B, 3)
        cand_v = gmin[tg]
        cand_i = gidx[tg]
        cv = cand_v.min(dim=1).values
        chit = cand_v == cv[:, None]
        ci = torch.where(chit, cand_i, m).min(dim=1).values
        better = (cv < best_v) | ((cv == best_v) & (ci < best_i))
        best_v = torch.where(better, cv, best_v)
        best_i = torch.where(better, ci, best_i)
        best_t = torch.where(better, lvl + 1, best_t)
    return best_i.to(torch.int32), best_t.to(torch.int32), best_v


def _water_level(p, d, demand_fn, hi0, batch: int, iters: int):
    """Smallest y with sum_m c_m(y) >= demand(y), by bisection.

    c_m(y) = clip(ceil((y - p_m)/d_m), 0, B).  demand_fn must be
    non-increasing in y; returns the upper end (capacity >= demand
    guaranteed there).  All on the device: no host read per iteration."""
    lo = p.min()
    hi = torch.maximum(p.max(), hi0) + batch * d.max()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cap = torch.clamp(torch.ceil((mid - p) / d), 0.0, float(batch)).sum()
        ok = cap >= demand_fn(mid)
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi


def _add_at(q: torch.Tensor, srv: torch.Tensor, tier: torch.Tensor,
            inc: torch.Tensor) -> torch.Tensor:
    """q with inc[b] added at (srv[b], tier[b]) (integer, exact)."""
    k = q.shape[1]
    flat = srv.long() * k + tier.long()
    return q.reshape(-1).index_add(0, flat, inc.to(q.dtype)).reshape(q.shape)


def _route_batch_pandas(s: bp.PandasState, est, ctx: FleetCtx, locs, active,
                        fc: FleetConfig, use_kernel: bool):
    """One slot of Balanced-PANDAS fleet routing: `fc.rounds` retry passes
    of (private argmin + rank clamp) with the workload recomputed between
    passes, then one pool water-fill for whatever is left."""
    m, k = ctx.num_servers, ctx.num_tiers
    batch = locs.shape[0]
    dev = locs.device
    ar = torch.arange(batch, device=dev)
    pending = active
    for r in range(fc.rounds):
        w = bp.workload(s, est)
        if use_kernel:
            best_i, best_t, best_v = kops.fleet_route(s.q, s.serving, est,
                                                      ctx.anc, locs)
        else:
            best_i, best_t, best_v = _private_route_segmin(w, est, ctx, locs)

        # pool (remote tier) water-fill parameters from the same snapshot
        pr = est[:, k - 1]
        p = w / pr - pr * 1e-6
        d = 1.0 / (pr * pr)
        s_priv = torch.where(pending, best_v, -3e38)  # a scalar: no copy

        def demand(y, pending=pending, best_v=best_v):
            return (pending & (best_v > y)).to(torch.float32).sum()

        y1 = _water_level(p, d, demand, s_priv.max(), batch, fc.fill_iters)

        # private rank clamp: the r-th claimant of a server stays private
        # only while its filled score is still under the water level
        go_raw = pending & (best_v <= y1)
        key_m = torch.where(go_raw, best_i.long(), m)
        order = torch.argsort(key_m, stable=True)
        sk = key_m[order]
        first = torch.searchsorted(sk, sk, side="left")
        rank = torch.empty_like(ar).index_put_((order,), ar - first)
        e_at = est[best_i.long(), best_t.long()]
        stay = go_raw & (best_v + rank.to(torch.int32) / (e_at * e_at) <= y1)

        if r < fc.rounds - 1:
            # commit this pass's winners; losers retry against updated W
            s = bp.PandasState(q=_add_at(s.q, best_i, best_t, stay),
                               serving=s.serving)
            pending = pending & ~stay

    # final pass: pool assignment at the re-raised level
    pool = pending & ~stay
    n_pool = pool.to(torch.float32).sum()
    y2 = _water_level(p, d, lambda y: n_pool, s_priv.max(), batch,
                      fc.fill_iters)
    caps = torch.clamp(torch.ceil((y2 - p) / d), 0.0, float(batch)
                       ).to(torch.int64)
    cum = torch.cumsum(caps, dim=0)
    pool_rank = torch.cumsum(pool.to(torch.int64), dim=0) - 1
    pool_srv = torch.clamp(torch.searchsorted(cum, pool_rank, side="right"),
                           0, m - 1)

    srv = torch.where(stay, best_i.long(), pool_srv)
    tier = torch.where(stay, best_t.long(), k - 1)
    return bp.PandasState(q=_add_at(s.q, srv, tier, pending),
                          serving=s.serving)


# ---------------------------------------------------------------------------
# Slot runner
# ---------------------------------------------------------------------------


def _build_fleet_step(policy_like: PolicyLike, cfg, fc: FleetConfig,
                      device):
    """Returns (init() -> carry, step(carry, t, est, draws) -> carry), the
    counterpart of the reference's `_build_fleet_chunk` at one slot.

    carry = (q (M,K) int32, serving (M,) int32, mean_n f32, n_meas f32,
    completions int32); `step` advances slot `t` with this slot's draws.
    """
    name = policy_name(policy_like)
    if name == "pandas_po2":
        raise NotImplementedError(f"the pandas_po2 fleet step "
                                  f"(_route_batch_po2) {_LATER}")
    if name not in _SUPPORTED_POLICIES:
        raise ValueError(f"policy {name!r} has no fleet step "
                         f"(supported: {_SUPPORTED_POLICIES})")
    dev = torch.device(device)
    ctx = make_ctx(cfg.topo, dev)
    m, k = ctx.num_servers, ctx.num_tiers
    batch = cfg.max_arrivals
    true_k = cfg.true_rates.as_array(dev)
    p_hot = torch.tensor(cfg.p_hot, dtype=torch.float32, device=dev)
    warmup = cfg.warmup
    use_kernel = (dev.type == "cuda") if fc.use_kernel is None \
        else fc.use_kernel

    def init() -> Carry:
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.zeros((m, k), dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.int32, device=dev),
                torch.zeros((), **f32), torch.zeros((), **f32),
                torch.zeros((), dtype=torch.int32, device=dev))

    @torch.inference_mode()  # no autograd bookkeeping: less host time a op
    def step(carry: Carry, t: int, est: torch.Tensor,
             draws: SlotDraws) -> Carry:
        q, serving, mean_n, n_meas, compl = carry
        s = bp.PandasState(q, serving)
        types, active = _sample_arrivals(draws, ctx, p_hot, batch)
        s = _route_batch_pandas(s, est, ctx, types, active, fc, use_kernel)
        s, compl_t = bp.serve_and_schedule(s, draws.u_serve, true_k)
        n = bp.num_in_system(s).to(torch.float32)
        in_w = float(t >= warmup)
        n_meas2 = n_meas + in_w
        mean_n2 = mean_n + in_w * (n - mean_n) / torch.clamp(n_meas2,
                                                             min=1.0)
        compl2 = compl + compl_t * int(t >= warmup)
        return (s.q, s.serving, mean_n2, n_meas2, compl2)

    return init, step


def carry_from_reference(arrays, device=None) -> Carry:
    """The port's carry from the reference's fleet carry ``(q, serving,
    mean_n, n_meas, completions)`` given as numpy, so both implementations
    can start from one mid-run state."""
    dev = resolve_device(device)
    q, serving, mean_n, n_meas, compl = (np.asarray(a) for a in arrays)
    return (torch.as_tensor(q.astype(np.int32), device=dev),
            torch.as_tensor(serving.astype(np.int32), device=dev),
            torch.tensor(float(mean_n), dtype=torch.float32, device=dev),
            torch.tensor(float(n_meas), dtype=torch.float32, device=dev),
            torch.tensor(int(compl), dtype=torch.int32, device=dev))


def _finalize(carry_np, lam_total) -> Dict[str, Any]:
    """Metrics dict (same keys as the dense path) from a final carry."""
    q, serving, mean_n, n_meas, compl = carry_np
    denom = np.float32(lam_total)  # static scenario: lam_scale == 1
    mean_delay = np.where(denom > 0, mean_n / denom, np.nan)
    return {
        "mean_n": mean_n,
        "mean_delay": mean_delay,
        "throughput": compl / np.maximum(n_meas, 1.0),
        "final_n": (q.sum(axis=(-2, -1))
                    + (serving > 0).sum(axis=-1)).astype(np.float32),
    }


def fleet_simulate(policy: PolicyLike, cfg, lam_total: float, est,
                   seed: int = 0, fleet: FleetLike = None, device=None,
                   rng: Optional[DrawSource] = None) -> Dict[str, Any]:
    """Fleet-path analogue of `core.simulator.simulate` (static scenario,
    uniform placement).  Same metrics keys; scalars come back as floats.

    `rng` replaces the default `DeviceSource(seed, ...)` (the tests pass
    a source that replays the reference's draws)."""
    if lam_total < 0:
        raise ValueError(f"lam_total must be >= 0, got {lam_total}")
    dev = resolve_device(device)
    fc = as_fleet_config(fleet)
    init, step = _build_fleet_step(policy, cfg, fc, dev)
    if not isinstance(est, torch.Tensor):
        est = torch.from_numpy(np.array(est, np.float32))
    est_t = est.to(device=dev, dtype=torch.float32).contiguous()
    if rng is None:
        rng = DeviceSource(seed, np.float32(lam_total), cfg.max_arrivals,
                           cfg.topo.num_servers, dev)
    carry = init()
    for t in range(cfg.horizon):
        carry = step(carry, t, est_t, rng.slot(t))
    out = _finalize(tuple(x.cpu().numpy() for x in carry), lam_total)
    return {k: float(v) for k, v in out.items()}


def fleet_sweep(policy: PolicyLike, cfg, lam_grid, est_stack, seeds,
                fleet: FleetLike = None, device=None):
    """(load x error x seed) grids as a batch dimension."""
    raise NotImplementedError(f"fleet_sweep {_LATER}")
