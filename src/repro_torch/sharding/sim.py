"""Fleet-scale path of the discrete-time simulator (10k+ servers).

Port of `repro.sharding.sim`: the same discrete-time model and metrics
keys as the dense simulator, with O(B + M·depth) work per slot.

* **Cells** — every state tensor carries a leading cell axis N: the
  (load x error x seed) grid of `fleet_sweep`, the counterpart of the
  reference's vmap of its fleet chunk (N = 1 for `fleet_simulate`).  One
  slot advances every cell with the same launches, each launch N cells
  wide; each cell's arithmetic is the one-cell arithmetic, so a sweep
  cell equals `fleet_simulate` of that cell bit for bit.
* **Arrivals** — O(B) distinct-3 sampler (uniform-offset trick) instead
  of (B, M) Gumbel top-k; same task-type law as the dense path.
* **Routing** — one workload snapshot per round.  Balanced-PANDAS's
  private phase (every tier better than remote) is either the fused CUDA
  kernel (`kernels.ops.fleet_route`, one launch for all cells) or the
  exact per-level segment-min (`_private_route_segmin`); both equal the
  dense oracle `kernels.ref.fleet_route` bit for bit, ties to the lowest
  index.  Power-of-d (`_route_batch_po2`) argmins over each task's three
  locals and d uniform candidates at once.
* **The remote pool** — solved as a water-filling fixed point: server m
  enters the pool at score p_m = W_m/r_m - r_m*1e-6 and each absorbed
  task raises it by d_m = 1/r_m^2; each cell's water level is bisected,
  and the r-th private claimant of a server stays private only while
  s_priv + r/rate^2 <= y (the rank clamp).  `FleetConfig.rounds` retry
  passes let collision overflow land on its next-best private option.
* **Randomness** — every draw comes from a `core.rng.DrawSource`, one
  `SlotDraws` for all cells a slot; the replay source of the tests
  recomputes the reference's draws, which makes the whole carry equal to
  the reference's after every slot.

The slot loop runs on the host, one slot per iteration, with no host
read of a device value inside it (no `.item()`, no Python branch on a
tensor), so chunks of slots can later be captured in CUDA graphs.
Supported: Balanced-PANDAS and power-of-d, static scenario, uniform
placement, static replication, no telemetry.

Spans and counters (`repro_torch.telemetry.span` / `count`, live only
while a profiler runs or a recorder is installed): ``fleet.setup``
(``.estimates``, ``.step``, ``.cdf``), ``fleet.loop``, a slot's
``fleet.draws``, ``fleet.arrivals``, ``fleet.route`` (Balanced-PANDAS:
a pass's ``.private`` and ``.rank_clamp``, a ``fleet.route.water_level``
a bisection, ``fleet.route.pool_fill``) and ``fleet.serve``, then
``fleet.finalize``.  A run counts inside its own `collecting` block: the
counter ``fleet.tasks_arrived`` keeps the slots' device counts, summed
once the carry is on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import balanced_pandas as bp
from repro_torch.core import locality as loc
from repro_torch.core.policy import PolicyLike, make_policy, policy_name
from repro_torch.core.rng import DeviceSource, DrawSource, SlotDraws
from repro_torch.core.simulator import _as_numpy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.slot_step import check_anc_ranges
from repro_torch.telemetry import collecting, count, flush_counts, span

# Auto-engagement floor for core.simulator's ``fleet=None``: paper-scale
# configurations stay on the dense path; fleet-sized topologies switch.
FLEET_AUTO_THRESHOLD = 1024

_SUPPORTED_POLICIES = ("balanced_pandas", "pandas_po2")

# carry = (q (N,M,K) int32, serving (N,M) int32, mean_n (N,) f32,
#          n_meas (N,) f32, completions (N,) int32): the reference's fleet
#          carry with a leading cell axis
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
    may be given by name ("static", "uniform", "fixed"); replication by
    name, `ReplicationConfig` or controller, as in the reference."""
    name = policy_name(policy_like)
    if name not in _SUPPORTED_POLICIES:
        return (f"policy {name!r} has no fleet step "
                f"(supported: {_SUPPORTED_POLICIES})")
    if telemetry is not None and telemetry is not False:
        return "telemetry recorders require the dense in-scan step"
    if scenario not in (None, "static"):
        return "only the static scenario is fleet-compiled"
    from repro_torch.placement import make_placement
    if make_placement(placement).name != "uniform":
        return "only uniform placement has a fleet sampler"
    from repro_torch.replication import make_replication
    if not make_replication(replication).is_static:
        return "dynamic replication rides the dense scan carry"
    if cfg.topo.num_servers < loc.NUM_REPLICAS:
        return "need at least NUM_REPLICAS servers"
    return None


# ---------------------------------------------------------------------------
# O(B) arrival sampling (distinct-3 via the uniform-offset trick)
# ---------------------------------------------------------------------------


def _sample_arrivals(draws: SlotDraws, ctx: FleetCtx, p_hot: torch.Tensor,
                     batch: int):
    """(types (..., B, 3) int32 sorted, active (..., B) bool) — the
    reference's arrival law (truncated Poisson count; hot tasks
    replica-set inside rack 0, the rest uniform) from this slot's
    uniforms, for any leading cell dimensions of the draws."""
    dev = draws.u_hot.device
    active = torch.arange(batch, device=dev) < draws.n[..., None]
    hot = draws.u_hot < p_hot
    size = torch.where(hot, ctx.hot_rack_size, ctx.num_servers
                       ).to(torch.float32)
    r = draws.r
    x0 = torch.minimum(torch.floor(r[..., 0] * size), size - 1)
    x1 = torch.minimum(torch.floor(r[..., 1] * (size - 1)), size - 2)
    x1 = x1 + (x1 >= x0)
    lo, hi = torch.minimum(x0, x1), torch.maximum(x0, x1)
    x2 = torch.minimum(torch.floor(r[..., 2] * (size - 2)), size - 3)
    x2 = x2 + (x2 >= lo)
    x2 = x2 + (x2 >= hi)
    types = torch.stack([x0, x1, x2], dim=-1).to(torch.int32)
    return torch.sort(types, dim=-1).values, active


# ---------------------------------------------------------------------------
# Private-phase routing: exact per-level segment-min / fused kernel
# ---------------------------------------------------------------------------


def _segment_argmin(score: torch.Tensor, gid: torch.Tensor, ngroups: int,
                    m: int):
    """Per-group (min, lowest server index achieving it) by scatter-reduce
    amin; `score` and `gid` are (N, M), the group ids already distinct
    across cells."""
    dev = score.device
    flat_gid = gid.reshape(-1)
    gmin = torch.full((ngroups,), float("inf"), dtype=score.dtype,
                      device=dev).scatter_reduce(0, flat_gid,
                                                 score.reshape(-1), "amin")
    hit = score == gmin[gid]
    sid = torch.arange(m, device=dev).expand_as(score)
    gidx = torch.full((ngroups,), m, dtype=torch.int64, device=dev
                      ).scatter_reduce(0, flat_gid,
                                       torch.where(hit, sid, m).reshape(-1),
                                       "amin")
    return gmin, gidx


def _private_route_segmin(w: torch.Tensor, est: torch.Tensor, ctx: FleetCtx,
                          locs: torch.Tensor):
    """Exact private argmin per task from per-level group minima.

    w (..., M), est (..., M, K), locs (..., B, 3) for any leading cell
    dimensions; each cell's group ids are offset past the previous
    cell's, so one scatter per level serves every cell.

    Level l's candidate scores every member of a local's level-l group at
    the tier-(l+1) rate.  A member whose true tier is shallower scores
    strictly lower at its true tier (rates decrease in the tier, and the
    -rate*1e-6 term favours the faster tier), and that score is itself a
    candidate at the shallower level; so combining levels, locals first,
    by lexicographic (score, server) reproduces the dense oracle's
    lowest-index argmin exactly, cross-tier ties included.
    """
    m = ctx.num_servers
    lead = w.shape[:-1]
    w = w.reshape(-1, m)
    nc = w.shape[0]
    est = est.reshape(nc, m, -1)
    locs = locs.reshape(nc, -1, 3).long()
    cell = torch.arange(nc, device=w.device)[:, None, None]
    flat = locs.reshape(nc, -1)
    w_l = torch.gather(w, 1, flat).view_as(locs)
    e_l = torch.gather(est[..., 0], 1, flat).view_as(locs)
    sc_loc = w_l / e_l - e_l * 1e-6                          # (N, B, 3)
    best_v = torch.amin(sc_loc, dim=-1)
    hit = sc_loc == best_v[..., None]
    best_i = torch.amin(torch.where(hit, locs, m), dim=-1)
    best_t = torch.zeros_like(best_i)
    for lvl in range(ctx.depth):
        rate = est[..., lvl + 1]
        sc = w / rate - rate * 1e-6                          # (N, M)
        ng = ctx.group_counts[lvl]
        gmin, gidx = _segment_argmin(sc, ctx.gids[lvl] + cell[:, 0] * ng,
                                     nc * ng, m)
        tg = ctx.gids[lvl][locs] + cell * ng                 # (N, B, 3)
        cand_v = gmin[tg]
        cand_i = gidx[tg]
        cv = torch.amin(cand_v, dim=-1)
        chit = cand_v == cv[..., None]
        ci = torch.amin(torch.where(chit, cand_i, m), dim=-1)
        better = (cv < best_v) | ((cv == best_v) & (ci < best_i))
        best_v = torch.where(better, cv, best_v)
        best_i = torch.where(better, ci, best_i)
        best_t = torch.where(better, lvl + 1, best_t)
    shape = lead + best_v.shape[-1:]
    return (best_i.to(torch.int32).view(shape),
            best_t.to(torch.int32).view(shape), best_v.view(shape))


def _water_level(p, d, demand_fn, hi0, batch: int, iters: int):
    """Per cell, the smallest y with sum_m c_m(y) >= demand(y), by
    bisection.

    p, d (N, M); c_m(y) = clip(ceil((y - p_m)/d_m), 0, B).  demand_fn maps
    (N, 1) levels to (N, 1) demands and must be non-increasing in y; hi0
    is (N, 1).  Returns the (N, 1) upper ends (capacity >= demand
    guaranteed there).  All on the device: no host read per iteration."""
    with span("fleet.route.water_level"):
        lo = torch.amin(p, dim=-1, keepdim=True)
        hi = (torch.maximum(torch.amax(p, dim=-1, keepdim=True), hi0)
              + batch * torch.amax(d, dim=-1, keepdim=True))
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            cap = torch.clamp(torch.ceil((mid - p) / d), 0.0, float(batch)
                              ).sum(dim=-1, keepdim=True)
            ok = cap >= demand_fn(mid)
            lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
        return hi


def _add_at(q: torch.Tensor, srv: torch.Tensor, tier: torch.Tensor,
            inc: torch.Tensor) -> torch.Tensor:
    """q (N, M, K) with inc[c, b] added at flat server srv[c, b] (that
    is c * M + server) and tier tier[c, b] (integer, exact)."""
    flat = (srv * q.shape[-1] + tier).view(-1)
    return q.view(-1).index_add(0, flat, inc.to(q.dtype).view(-1)
                                ).view(q.shape)


def _route_batch_pandas(s: bp.PandasState, est, ctx: FleetCtx, locs, active,
                        fc: FleetConfig, use_kernel: bool):
    """One slot of Balanced-PANDAS fleet routing for N cells: `fc.rounds`
    retry passes of (private argmin + rank clamp) with the workload
    recomputed between passes, then one pool water-fill for whatever is
    left.  locs (N, B, 3), active (N, B), est (N, M, K)."""
    nc, m, k = s.q.shape
    batch = locs.shape[-2]
    dev = locs.device
    cell_m = torch.arange(nc, device=dev)[:, None] * m   # flat server base
    ar = torch.arange(nc * batch, device=dev)
    est2 = est.reshape(nc * m, k)
    pending = active
    for r in range(fc.rounds):
        w = bp.workload(s, est)
        with span("fleet.route.private"):
            if use_kernel:
                best_i, best_t, best_v = kops.fleet_route(
                    s.q, s.serving, est, ctx.anc, locs)
            else:
                best_i, best_t, best_v = _private_route_segmin(w, est, ctx,
                                                               locs)

        # pool (remote tier) water-fill parameters from the same snapshot
        pr = est[..., k - 1]
        p = w / pr - pr * 1e-6
        d = 1.0 / (pr * pr)
        s_priv = torch.where(pending, best_v, -3e38)  # a scalar: no copy

        def demand(y, pending=pending, best_v=best_v):
            return (pending & (best_v > y)).to(torch.float32
                                               ).sum(dim=-1, keepdim=True)

        hi0 = torch.amax(s_priv, dim=-1, keepdim=True)
        y1 = _water_level(p, d, demand, hi0, batch, fc.fill_iters)

        # private rank clamp: the r-th claimant of a server stays private
        # only while its filled score is still under the water level; one
        # stable sort of the flat server ids ranks every cell's claimants
        with span("fleet.route.rank_clamp"):
            go_raw = pending & (best_v <= y1)
            flat_i = best_i.long() + cell_m
            key_m = torch.where(go_raw, flat_i, nc * m).reshape(-1)
            order = torch.argsort(key_m, stable=True)
            sk = key_m[order]
            first = torch.searchsorted(sk, sk, side="left")
            rank = torch.empty_like(ar).index_put_((order,), ar - first
                                                   ).view(nc, batch)
            e_at = est2[flat_i, best_t.long()]
            stay = go_raw & (best_v + rank.to(torch.int32)
                             / (e_at * e_at) <= y1)

        if r < fc.rounds - 1:
            # commit this pass's winners; losers retry against updated W
            s = bp.PandasState(q=_add_at(s.q, flat_i, best_t, stay),
                               serving=s.serving)
            pending = pending & ~stay

    # final pass: pool assignment at the re-raised level
    with span("fleet.route.pool_fill"):
        pool = pending & ~stay
        n_pool = pool.to(torch.float32).sum(dim=-1, keepdim=True)
        y2 = _water_level(p, d, lambda y: n_pool, hi0, batch, fc.fill_iters)
        caps = torch.clamp(torch.ceil((y2 - p) / d), 0.0, float(batch)
                           ).to(torch.int64)
        cum = torch.cumsum(caps, dim=-1)
        pool_rank = torch.cumsum(pool.to(torch.int64), dim=-1) - 1
        pool_srv = torch.clamp(torch.searchsorted(cum, pool_rank,
                                                  side="right"), 0, m - 1)

        srv = torch.where(stay, flat_i, pool_srv + cell_m)
        tier = torch.where(stay, best_t.long(), k - 1)
        return bp.PandasState(q=_add_at(s.q, srv, tier, pending),
                              serving=s.serving)


def _route_batch_po2(s: bp.PandasState, est, ctx: FleetCtx, locs, active,
                     u_cand: torch.Tensor):
    """One snapshot round of power-of-d fleet routing for N cells: each
    task argmins over {3 locals} and {d uniform candidates, floor(u * M)}
    directly (remote candidates allowed: no pool is needed, the d samples
    spread load by construction).  A candidate's tier is the deepest
    level whose group it shares with a local (0 for a local); the argmin
    takes the first of equal scores, as `jnp.argmin` does."""
    nc, m, k = s.q.shape
    w = bp.workload(s, est)
    cand = torch.clamp(torch.floor(u_cand * m), max=m - 1).long()
    lk = locs.long()
    cset = torch.cat([lk, cand], dim=-1)                    # (N, B, 3+d)
    tier = torch.full(cset.shape, k - 1, dtype=torch.int64,
                      device=cset.device)
    for lvl in range(ctx.depth - 1, -1, -1):
        row = ctx.gids[lvl]
        share = (row[cset][..., None] == row[lk][..., None, :]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
    tier = torch.where((cset[..., None] == lk[..., None, :]).any(dim=-1),
                       0, tier)
    flat = cset + torch.arange(nc, device=cset.device)[:, None, None] * m
    rate = est.reshape(nc * m, k)[flat, tier]
    wc = w.reshape(-1)[flat]
    score = wc / rate - rate * 1e-6
    j = torch.argmin(score, dim=-1, keepdim=True)
    return bp.PandasState(q=_add_at(s.q, torch.gather(flat, -1, j)[..., 0],
                                    torch.gather(tier, -1, j)[..., 0],
                                    active),
                          serving=s.serving)


# ---------------------------------------------------------------------------
# Slot runner
# ---------------------------------------------------------------------------


def _build_fleet_step(policy_like: PolicyLike, cfg, fc: FleetConfig,
                      device):
    """Returns (init(n_cells=1) -> carry, step(carry, t, est, draws) ->
    carry), the counterpart of the reference's `_build_fleet_chunk` at one
    slot, vmapped over cells.

    carry = (q (N,M,K) int32, serving (N,M) int32, mean_n (N,) f32,
    n_meas (N,) f32, completions (N,) int32); `step` advances slot `t` of
    every cell with this slot's draws and the cells' (N,M,K) estimates.
    """
    name = policy_name(policy_like)
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

    def init(n_cells: int = 1) -> Carry:
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.zeros((n_cells, m, k), dtype=torch.int32, device=dev),
                torch.zeros((n_cells, m), dtype=torch.int32, device=dev),
                torch.zeros((n_cells,), **f32), torch.zeros((n_cells,), **f32),
                torch.zeros((n_cells,), dtype=torch.int32, device=dev))

    @torch.inference_mode()  # no autograd bookkeeping: less host time a op
    def step(carry: Carry, t: int, est: torch.Tensor,
             draws: SlotDraws) -> Carry:
        q, serving, mean_n, n_meas, compl = carry
        s = bp.PandasState(q, serving)
        with span("fleet.arrivals"):
            types, active = _sample_arrivals(draws, ctx, p_hot, batch)
        with span("fleet.route"):
            if name == "pandas_po2":
                s = _route_batch_po2(s, est, ctx, types, active,
                                     draws.u_cand)
            else:
                s = _route_batch_pandas(s, est, ctx, types, active, fc,
                                        use_kernel)
        with span("fleet.serve"):
            s, compl_t = bp.serve_and_schedule(s, draws.u_serve, true_k)
            n = bp.num_in_system(s).to(torch.float32)
            in_w = float(t >= warmup)
            n_meas2 = n_meas + in_w
            mean_n2 = mean_n + in_w * (n - mean_n) / torch.clamp(n_meas2,
                                                                 min=1.0)
            compl2 = compl + compl_t * int(t >= warmup)
        return (s.q, s.serving, mean_n2, n_meas2, compl2)

    return init, step


def candidates(policy_like: PolicyLike) -> int:
    """Uniform candidates a task draws per slot on the fleet path: the
    power-of-d policy's d, else 0."""
    if policy_name(policy_like) != "pandas_po2":
        return 0
    return int(make_policy(policy_like).d)


def carry_from_reference(arrays, device=None) -> Carry:
    """The port's carry from the reference's fleet carry ``(q, serving,
    mean_n, n_meas, completions)`` given as numpy (one run, or vmapped
    over cells), so both implementations can start from one mid-run
    state."""
    dev = resolve_device(device)
    q, serving, mean_n, n_meas, compl = (np.asarray(a) for a in arrays)
    if q.ndim == 2:   # one run: a cell axis of 1
        q, serving = q[None], serving[None]
    cells = lambda x, dtype: torch.as_tensor(  # noqa: E731
        x.astype(dtype).reshape(-1), device=dev)
    return (torch.as_tensor(q.astype(np.int32), device=dev),
            torch.as_tensor(serving.astype(np.int32), device=dev),
            cells(mean_n, np.float32), cells(n_meas, np.float32),
            cells(compl, np.int32))


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


def _fleet_run(policy: PolicyLike, cfg, cells: Sequence[Tuple[int, float]],
               est_stack: np.ndarray, est_index: Sequence[int],
               fleet: FleetLike, device,
               rng: Optional[DrawSource]) -> Dict[str, np.ndarray]:
    """Runs the cells ``[(seed, lam), ...]`` as one batch, cell i at the
    (M, K) estimates ``est_stack[est_index[i]]``; returns (N,) metric
    arrays."""
    dev = resolve_device(device)
    with collecting():
        with span("fleet.setup"):
            with span("fleet.setup.estimates"):
                est_t = torch.as_tensor(est_stack[est_index],
                                        device=dev).contiguous()
            with span("fleet.setup.step"):
                init, step = _build_fleet_step(policy, cfg,
                                               as_fleet_config(fleet), dev)
            if rng is None:
                rng = DeviceSource(cells, cfg.max_arrivals,
                                   cfg.topo.num_servers, dev,
                                   candidates(policy))
            carry = init(len(cells))
        with span("fleet.loop"):
            for t in range(cfg.horizon):
                with span("fleet.draws"):
                    draws = rng.slot(t)
                    count("fleet.tasks_arrived", draws.n)
                carry = step(carry, t, est_t, draws)
        with span("fleet.finalize"):
            carry_np = tuple(x.cpu().numpy() for x in carry)
            flush_counts()
            lam = np.asarray([lam for _, lam in cells], np.float32)
            return _finalize(carry_np, lam)


def fleet_simulate(policy: PolicyLike, cfg, lam_total: float, est,
                   seed: int = 0, fleet: FleetLike = None, device=None,
                   rng: Optional[DrawSource] = None) -> Dict[str, Any]:
    """Fleet-path analogue of `core.simulator.simulate` (static scenario,
    uniform placement): a one-cell `fleet_sweep`.  Same metrics keys;
    scalars come back as floats.

    `rng` replaces the default `DeviceSource([(seed, lam_total)], ...)`
    (the tests pass a source that replays the reference's draws)."""
    if lam_total < 0:
        raise ValueError(f"lam_total must be >= 0, got {lam_total}")
    out = _fleet_run(policy, cfg, [(int(seed), np.float32(lam_total))],
                     _as_numpy(est)[None], [0], fleet, device, rng)
    return {k: float(v[0]) for k, v in out.items()}


def fleet_sweep(policy: PolicyLike, cfg, lam_grid, est_stack, seeds,
                fleet: FleetLike = None, device=None,
                rng: Optional[DrawSource] = None) -> Dict[str, np.ndarray]:
    """Fleet-path analogue of `core.simulator.sweep`: (L, E, S) metrics.

    lam_grid (L,), est_stack (E, M, K), seeds (S,).  The grid runs as one
    batch of N = L*E*S cells, cell (l, e, s) at flat index
    ``(l*E + e)*S + s`` (the reference's order); a cell equals
    `fleet_simulate` at its load, estimates and seed, bit for bit.  `rng`
    gives the N cells' draws in that order."""
    lam_grid = np.asarray(lam_grid, np.float32).reshape(-1)
    if np.any(lam_grid < 0):
        raise ValueError(f"lam_grid must be >= 0, got {lam_grid}")
    est_stack = _as_numpy(est_stack)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    shape = (len(lam_grid), len(est_stack), len(seeds))
    grid = [(lam, e, s) for lam in lam_grid
            for e in range(shape[1]) for s in seeds]
    out = _fleet_run(policy, cfg, [(s, lam) for lam, _, s in grid],
                     est_stack, [e for _, e, _ in grid], fleet, device, rng)
    return {k: np.asarray(v).reshape(shape) for k, v in out.items()}
