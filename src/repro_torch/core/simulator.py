"""Discrete-time simulator entry point (port of `repro.core.simulator`).

`simulate` and `sweep` keep the reference's signatures and its
``fleet=`` engage rule: configurations the fleet path supports run there
when the topology has at least `sharding.sim.FLEET_AUTO_THRESHOLD`
servers (or when ``fleet=True``/a `FleetConfig` forces it); everything
else runs the dense path.

Dense path.  The reference is one `lax.scan` over slots per
configuration, vmapped over the (load x error x seed) grid.  Here the
grid is one leading cell dimension N = L*E*S on every state tensor, and
the slot loop runs on the host, one slot per iteration, with no read of a
device value inside it.  Each cell's draws depend only on its seed, the
slot and its load (`core.rng.DenseDeviceSource`), so ``sweep(...)[l, e,
s]`` equals ``simulate(..., seed=seeds[s])`` exactly.

Scenarios (`repro_torch.workloads`): every dense run plays back a
compiled `Schedule` (None -> ``"static"``), as the reference's scan does.
Each slot gathers its segment's knobs on the device (`slot_knobs`): the
arrival count's rate ``lam_total * lam_mult`` (drawn by the source, one
Poisson CDF a cell and segment), ``p_hot``, ``hot_rack``,
``rack_weights``, and the true rates ``true_k[None, :] * rate_mult``,
(M, K), shared by every cell.  A one-segment schedule's knobs are
gathered once.  ``"static"`` gives the run without a scenario bit for
bit.  The fleet path stays static-only, as in the reference.

Replication (`repro_torch.replication`: a name, `ReplicationConfig` or
controller; None -> ``"fixed"``): the lifecycle machinery engages exactly
when the reference's does, when the controller is dynamic or the
schedule has a failure track (``down_servers``/``down_racks``:
``server_loss``, ``rack_loss``, traces with incident windows of that
kind), a Python-level fact.  Engaged, its state (`SimReplication`,
batched over the cells) rides the carry: each slot it runs after the
arrivals and before the policy, on the schedule's ``alive`` track and
the draw seam's chunk reads, and its (N, M) ``fg_mult`` scales the true
rates, which become per cell, (N, M, K): dead servers serve at rate 0
and migration endpoints at the contention multiplier.  Its
availability, data-loss and migration metrics join the output.
``"fixed"`` with no failure track builds nothing and is the run without
replication bit for bit.

Replica placement (`repro_torch.placement`): a name, `PlacementConfig` or
instance (None -> ``"uniform"``) compiles to the per-task replica
sampler the arrival stream draws task types from, built once a run and
called every slot on the draw seam's numbers; a placement that draws
Gumbels of its own (``hdfs``, ``spread``) widens the arrival block by
them (`core.rng`), so counts and hot uniforms stay the same under every
placement.  ``"uniform"`` gives the run without a placement bit for bit.
The fleet path stays uniform-only, as in the reference: ``fleet=True``
with another placement raises its ``ValueError``, ``fleet=None`` runs it
on the dense path.

Telemetry (`repro_torch.telemetry`: None / True / `TelemetryConfig`)
builds the recorder into the dense step: a FIFO-coupled sojourn
histogram (-> ``delay_p50/p95/p99``), a queue-length histogram and
downsampled time series (the base tracks, then ``alive_servers`` and
``open_lanes`` when replication is engaged, then the policy's sorted
`telemetry_gauges`), per cell.  Its state rides the carry after the
replication slice.  The recorder draws nothing, so every metric of the
run without it stays bit for bit; a policy that `uses_signals`
(``slo_pandas``) reads the recorder's live p99 of the slot before as
``signals``.  Array metrics (the histograms, the series) come back as
arrays: (L, E, S, ...) from `sweep`.  The fleet path refuses telemetry,
as the reference's does.

Control (`repro_torch.control`: None, a controller name, `ControlConfig`,
instance or a sequence, at most one a kind) engages the control plane
on the dense path (with ``fleet=True`` it raises, as the reference's
does).  Its state (`CtlState`, per cell) rides the carry between the
replication and telemetry slices.  Each slot the loadgen shapes the
offered rate before the arrivals (open loop's ``extra_mult`` folded
into the count law, closed loop's count gathered from the draw seam's
``n_by_k`` at the thinking population); after them and before the
replication lifecycle and the routing, admission trims the lane mask
(shed tasks never touch a queue or the sojourn pairing) and the
autoscaler hands a mask-aware policy (``supports_server_mask``) an
(N, M) routable-server mask; an autoscaler on another policy raises the
reference's ``ValueError``.  The controllers draw nothing.  ``ctl_*``
metrics join the output, before telemetry's, and ``mean_delay``'s
Little's-law denominator becomes the measured admitted rate.  ``None``
builds nothing: the run without control bit for bit.

Mean task completion time is measured via Little's law:
``W = mean(N_in_system over measurement window) / (lambda_total x the
window's mean lam_mult)`` (slots).

Error models for the estimated rates (`make_estimates`):
  - "uniform":    est = true * (1 +/- eps) for every tier (a no-op for
                  PANDAS decisions: the scale-invariance control arm);
  - "network":    the local rate exact, every other tier off by
                  (1 +/- eps) — mis-estimated network depreciation;
  - "per_server": each server's estimates carry iid multipliers in
                  [1-eps, 1] (sign<0) or [1, 1+eps] (sign>0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, workloads as wl
from repro_torch.control import resolve_control
from repro_torch.core import locality as loc
from repro_torch.core.policy import PolicyLike, make_policy
from repro_torch.core.rng import DenseDeviceSource, DenseSource
from repro_torch.placement import make_placement
from repro_torch.replication import make_replication
from repro_torch.telemetry import SimTelemetry, as_telemetry_config


@dataclasses.dataclass(frozen=True)
class SimConfig:
    topo: loc.Topology
    true_rates: loc.Rates
    p_hot: float = 0.5
    max_arrivals: int = 24
    horizon: int = 40_000
    warmup: int = 10_000

    def __post_init__(self):
        if not 0.0 <= self.p_hot <= 1.0:
            raise ValueError(f"p_hot must be in [0, 1], got {self.p_hot}")
        if self.max_arrivals < 1:
            raise ValueError(
                f"max_arrivals must be >= 1, got {self.max_arrivals}")
        if not 0 <= self.warmup < self.horizon:
            raise ValueError(f"need 0 <= warmup < horizon, got "
                             f"warmup={self.warmup} horizon={self.horizon}")
        if self.true_rates.num_tiers != self.topo.num_tiers:
            raise ValueError(
                f"true_rates have {self.true_rates.num_tiers} tiers but the "
                f"topology has {self.topo.num_tiers}")
        if self.topo.min_rack_size < loc.NUM_REPLICAS:
            raise ValueError(
                f"every rack needs >= {loc.NUM_REPLICAS} servers for "
                f"hot-rack types; smallest rack has "
                f"{self.topo.min_rack_size}")


def default_config(**kw) -> SimConfig:
    """Paper-scale default: 24 servers in 4 racks, hot-rack traffic."""
    return SimConfig(topo=loc.Topology(24, 6), true_rates=loc.Rates(), **kw)


def make_estimates(cfg: SimConfig, mode: str, eps: float, sign: int,
                   seed: int = 0) -> np.ndarray:
    """(M, K) float32 estimated rates for one error setting.
    sign: -1 lower, +1 higher."""
    m = cfg.topo.num_servers
    k = cfg.true_rates.num_tiers
    true_k = np.asarray(cfg.true_rates.values, np.float32)
    if mode == "uniform":
        mult = np.full((m, k), 1.0 + sign * eps, np.float32)
    elif mode == "network":
        mult = np.ones((m, k), np.float32)
        mult[:, 1:] = 1.0 + sign * eps
    elif mode == "per_server":
        rng = np.random.default_rng(seed)
        u = rng.uniform(0.0, eps, size=(m, k)).astype(np.float32)
        mult = 1.0 + sign * u
    else:
        raise ValueError(f"unknown error mode {mode!r}")
    est = true_k[None, :] * mult
    return np.clip(est, 1e-3, 1.0)


def _merge_metrics(out: Dict[str, Any], extra: Dict[str, Any],
                   source: str) -> None:
    """Merge `extra` into the metrics dict, refusing to overwrite a key
    another layer already produced."""
    for k in extra:
        if k in out:
            raise ValueError(
                f"{source} metric key {k!r} collides with an existing "
                f"metrics key; rename it (existing keys: {sorted(out)})")
    out.update(extra)


def build_control(control, cfg: SimConfig, sched, device):
    """The run's `control.SimControl` on `device` (None for
    ``control=None``: nothing is built)."""
    plane = resolve_control(control)
    if plane is None:
        return None
    return plane.build_sim(cfg.topo, cfg, sched,
                           float(np.asarray(cfg.true_rates.values)[0]),
                           device)


# dense carry: (policy state, mean_n (N,) f32, n_meas (N,) f32,
#               completions (N,) int32)[, RepState when replication is
#               engaged][, CtlState under a control plane][, TelState
#               when telemetry is on], as in the reference
DenseCarry = Tuple[Any, ...]


def _build_dense_step(policy_like: PolicyLike, cfg: SimConfig,
                      est: torch.Tensor, device, sched=None, placement=None,
                      replication=None, telemetry=None, ctl=None, lam=None):
    """Returns (policy, init() -> carry, step(carry, t, draws) -> carry,
    rep, tel) for the N cells whose (N, M, K) estimated rates are `est`
    under the compiled scenario `sched` (None: static), `placement`
    (None: uniform), `replication` (None: fixed), `telemetry` (None:
    off) and the control plane `ctl` (a `control.SimControl` from
    `build_control`; None: none): the counterpart of the reference's
    scan body, one slot per call.  The draws' counts already follow the
    slot's arrival rate (closed loop: the ``n_by_k`` table), and they
    carry the placement's Gumbel blocks and, when the lifecycle
    machinery is engaged, the chunk reads (`core.rng`).  `lam` is the
    cells' (N,) float32 configured rates, which an autoscaler reads.
    `rep` is the run's `SimReplication`, None when the machinery is not
    engaged; `tel` its `SimTelemetry`, None when telemetry is off."""
    pol = make_policy(policy_like)
    dev = torch.device(device)
    topo = cfg.topo
    plc = make_placement(placement)
    sample_types = plc.build_sampler(topo, dev)
    if sched is None:
        sched = wl.compile_schedule(wl.make_scenario(None), topo,
                                    cfg.horizon, cfg.p_hot, device=dev)
    ctrl = make_replication(replication)
    rep = None
    if not (ctrl.is_static and sched.alive is None):
        rep = ctrl.build_sim(topo, np.asarray(cfg.true_rates.values), plc,
                             dev)
        all_alive = torch.ones(topo.num_servers, dtype=torch.float32,
                               device=dev)
    n_cells = est.shape[0]
    tel = None
    if telemetry is not None and telemetry is not False:
        tracks = ["alive_servers", "open_lanes"] if rep is not None else []
        tracks += sorted(pol.telemetry_gauges(
            pol.init_state(topo, device=dev, batch=(1,))))
        tel = SimTelemetry(as_telemetry_config(telemetry), cfg.horizon,
                           cfg.warmup, topo.num_servers, cfg.max_arrivals,
                           tracks, device=dev)
    if ctl is not None and ctl.has_mask and not pol.supports_server_mask:
        raise ValueError(
            f"control plane {ctl.plane.describe()!r} autoscales, but policy "
            f"{pol.name!r} does not accept a server mask "
            f"(supports_server_mask=False); drop the autoscale "
            f"controller or pick a mask-aware policy")
    if ctl is not None and ctl.has_mask:
        lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    uses_signals = pol.uses_signals and tel is not None
    i_rep = 4 if rep is not None else None
    i_ctl = 4 + (rep is not None) if ctl is not None else None
    i_tel = 4 + (rep is not None) + (ctl is not None) \
        if tel is not None else None
    anc = torch.as_tensor(np.array(topo.ancestors), device=dev)
    rack_of = torch.as_tensor(np.array(topo.rack_of), device=dev)
    true_k = cfg.true_rates.as_array(dev)
    warmup = cfg.warmup

    def knobs_at(t):
        """The slot's knobs and its (M, K) true rates."""
        knobs = wl.slot_knobs(sched, t)
        return knobs, true_k[None, :] * knobs.rate_mult

    # a one-segment schedule's knobs are constant: gathered once
    const = knobs_at(0) if sched.num_segments == 1 else None

    def init() -> DenseCarry:
        f32 = dict(dtype=torch.float32, device=dev)
        carry = (pol.init_state(topo, device=dev, batch=(n_cells,)),
                 torch.zeros((n_cells,), **f32),
                 torch.zeros((n_cells,), **f32),
                 torch.zeros((n_cells,), dtype=torch.int32, device=dev))
        if rep is not None:
            carry += (rep.init(n_cells),)
        if ctl is not None:
            carry += (ctl.init(n_cells),)
        if tel is not None:
            carry += (tel.init(n_cells),)
        return carry

    @torch.inference_mode()  # no autograd bookkeeping: less host time a op
    def step(carry: DenseCarry, t: int, draws) -> DenseCarry:
        state, mean_n, n_meas, compl = carry[:4]
        if tel is not None or ctl is not None:
            # observed BEFORE this slot's arrivals and service touch it
            n_prev = pol.num_in_system(state).to(torch.int32)
        knobs, true_mk = const if const is not None else knobs_at(t)
        count = draws.n
        if ctl is not None:
            # the loadgen shapes the offered rate (closed loop gates on
            # the policy's in-system count); its count is the draw
            # seam's table entry at the thinking population
            lam_t, arr_cap = ctl.offered_lam(n_prev, lam, knobs)
            if ctl.closed_loop:
                if draws.n_by_k is None:
                    raise ValueError("a closed-loop control plane needs "
                                     "the draws' n_by_k table")
                count = draws.n_by_k.gather(
                    1, arr_cap.long()[:, None])[:, 0]
        types, active = loc.sample_arrivals_at(
            count, draws.u_hot, draws.g_type, rack_of, knobs.p_hot,
            knobs.hot_rack, knobs.rack_weights, draws.g_rack,
            type_sampler=sample_types, g_place=draws.g_place)
        step_kw = {}
        if ctl is not None:
            # admission trims the lane mask BEFORE routing; the
            # autoscaler computes this slot's routable-server mask
            ctl_state, active, server_mask = ctl.pre(
                carry[i_ctl], active, arr_cap, n_prev, lam_t, t >= warmup)
            if server_mask is not None:
                step_kw["server_mask"] = server_mask
        if rep is not None:
            alive = knobs.alive if knobs.alive is not None else all_alive
            rep_state, fg_mult = rep.step(carry[i_rep], alive, draws.read,
                                          active, t >= warmup)
            true_mk = true_mk * fg_mult[..., None]   # (N, M, K)
        if uses_signals:  # the recorder as the previous slot left it
            step_kw["signals"] = {
                "delay_p99": tel.live_quantile(carry[i_tel], 0.99)}
        state, compl_t = pol.slot_step(state, draws, types, active, est,
                                       true_mk, anc, **step_kw)
        n_now = pol.num_in_system(state)
        n = n_now.to(torch.float32)
        in_w = float(t >= warmup)
        n_meas = n_meas + in_w
        mean_n = mean_n + in_w * (n - mean_n) / torch.clamp(n_meas, min=1.0)
        compl = compl + compl_t * int(t >= warmup)
        out = (state, mean_n, n_meas, compl)
        if rep is not None:
            out += (rep_state,)
        if ctl is not None:
            out += (ctl_state,)
        if tel is not None:
            # admissions inferred from the state delta, so arrivals the
            # policy rejected (FIFO's drops) never enter the pairing
            n_now = n_now.to(torch.int32)
            extras = dict(pol.telemetry_gauges(state))
            if rep is not None:
                extras["alive_servers"] = (alive > 0.5).sum().to(
                    torch.float32).expand(n_cells)
                extras["open_lanes"] = (rep_state.lane_left > 0.0).sum(
                    dim=-1).to(torch.float32)
            out += (tel.record(carry[i_tel], t, n_now - n_prev + compl_t,
                               compl_t, n_now, extras),)
        return out

    return pol, init, step, rep, tel


def _dense_metrics(pol, carry: DenseCarry, lam: torch.Tensor,
                   rep=None, tel=None, ctl=None) -> Dict[str, np.ndarray]:
    """(N, ...) metrics per cell from a final carry: Little's law over the
    measurement window, as the reference computes it in float32; `lam`
    is each cell's offered rate over the window; `rep` the run's
    `SimReplication`, `ctl` its `SimControl` and `tel` its
    `SimTelemetry` (None: not engaged), whose metrics join.  Under
    control, Little's law divides by the measured admitted rate."""
    state, mean_n, n_meas, compl = carry[:4]
    out = {
        "mean_n": mean_n,
        "mean_delay": torch.where(lam > 0, mean_n / lam,
                                  torch.full_like(mean_n, float("nan"))),
        "throughput": compl.to(torch.float32) / torch.clamp(n_meas, min=1.0),
        "final_n": pol.num_in_system(state).to(torch.float32),
    }
    if ctl is not None:
        ctl_state = carry[4 + (rep is not None)]
        out["mean_delay"] = ctl.mean_delay(ctl_state, mean_n, n_meas)
    _merge_metrics(out, pol.extra_metrics(state), "SlotPolicy.extra_metrics")
    if rep is not None:
        _merge_metrics(out, rep.metrics(carry[4]), "replication lifecycle")
    if ctl is not None:
        _merge_metrics(out, ctl.metrics(ctl_state), "control plane")
    if tel is not None:
        _merge_metrics(out, tel.metrics(carry[-1]), "telemetry")
    return {k: v.cpu().numpy() for k, v in out.items()}


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _dense_run(policy, cfg: SimConfig, cells: Sequence[Tuple[int, float]],
               est_cells: np.ndarray, device, rng: DenseSource = None,
               scenario=None, placement=None, replication=None,
               telemetry=None, control=None) -> Dict[str, np.ndarray]:
    """Runs the cells ``[(seed, lam), ...]`` with (N, M, K) estimates as
    one batch under `scenario`, `placement`, `replication`, `telemetry`
    and `control`; returns (N, ...) metric arrays."""
    dev = resolve_device(device)
    est = torch.as_tensor(est_cells, device=dev).contiguous()
    sched = wl.compile_schedule(wl.make_scenario(scenario), cfg.topo,
                                cfg.horizon, cfg.p_hot, device=dev)
    plc = make_placement(placement)
    ctl = build_control(control, cfg, sched, dev)
    lam = torch.tensor([lam for _, lam in cells], dtype=torch.float32,
                       device=dev)
    pol, init, step, rep, tel = _build_dense_step(
        policy, cfg, est, dev, sched, plc, replication, telemetry, ctl, lam)
    if rng is None:
        rng = DenseDeviceSource(cells, pol.draw_plan(cfg.topo.num_servers),
                                cfg.max_arrivals, cfg.topo.num_servers, dev,
                                sched, plc.gumbel_blocks(cfg.topo),
                                None if rep is None else rep.read_cdf,
                                **({} if ctl is None else ctl.count_law()))
    carry = init()
    for t in range(cfg.horizon):
        carry = step(carry, t, rng.slot(t))
    # Little's law over the window: the offered rate is lam_total x the
    # window's mean arrival multiplier (1.0 for the static scenario)
    lam_scale = wl.mean_lam_mult_over(sched, cfg.warmup, cfg.horizon)
    return _dense_metrics(pol, carry, lam * lam_scale, rep, tel, ctl)


def _fleet_engaged(fleet, policy, cfg, scenario, placement, replication,
                   telemetry, control=None) -> bool:
    """The reference's ``fleet=`` rule.  ``False`` -> dense.  ``True`` / a
    FleetConfig -> fleet, raising if unsupported.  ``None`` -> fleet only
    when supported and the topology has >= FLEET_AUTO_THRESHOLD servers.
    A control plane always pins the dense path."""
    if control is not None:
        if fleet is True or (fleet is not None and fleet is not False):
            raise ValueError("fleet=True is not supported with control=; "
                             "the fleet step has no control-plane seam yet")
        return False
    if fleet is False:
        return False
    from repro_torch.sharding import sim as fleet_sim  # lazy: no cycle
    reason = fleet_sim.fleet_supported(policy, cfg, scenario, placement,
                                       replication, telemetry)
    if fleet is None:
        return (reason is None and cfg.topo.num_servers
                >= fleet_sim.FLEET_AUTO_THRESHOLD)
    if reason is not None:
        raise ValueError(f"fleet=True requested but unsupported: {reason}")
    return True


def simulate(policy, cfg: SimConfig, lam_total: float, est, seed: int = 0,
             scenario=None, placement=None, replication=None,
             telemetry=None, control=None, fleet=None, device=None,
             rng=None) -> Dict[str, Any]:
    """Single-configuration run; scalar metrics come back as floats,
    array-valued telemetry metrics (histograms, the series) as numpy
    arrays.

    ``lam_total == 0`` yields ``mean_delay = NaN``; negative loads raise.
    ``control`` engages the control plane on the dense path (the module
    docstring); with ``fleet=True`` it raises, as in the reference.
    ``device=None`` runs on the card (raising when there is none);
    ``rng`` overrides the default draw source: a `core.rng.DrawSource` on
    the fleet path, a `core.rng.DenseSource` on the dense path.
    """
    if lam_total < 0:
        raise ValueError(f"lam_total must be >= 0, got {lam_total}")
    if _fleet_engaged(fleet, policy, cfg, scenario, placement, replication,
                      telemetry, control):
        from repro_torch.sharding import sim as fleet_sim
        return fleet_sim.fleet_simulate(policy, cfg, lam_total, est, seed,
                                        fleet, device=device, rng=rng)
    out = _dense_run(policy, cfg, [(int(seed), np.float32(lam_total))],
                     _as_numpy(est)[None], device, rng, scenario, placement,
                     replication, telemetry, control)
    return {k: float(v[0]) if v.ndim == 1 else v[0] for k, v in out.items()}


def sweep(policy, cfg: SimConfig, lam_grid, est_stack, seeds,
          scenario=None, placement=None, replication=None, telemetry=None,
          control=None, fleet=None, device=None,
          rng=None) -> Dict[str, np.ndarray]:
    """Full cartesian sweep: results have shape (L, E, S).

    lam_grid: (L,) loads; est_stack: (E, M, K); seeds: (S,).  The grid
    runs as one batch of N = L*E*S cells, cell (l, e, s) at flat index
    ``(l*E + e)*S + s``; a cell's result equals `simulate` at its load,
    estimates and seed.  Telemetry metrics batch like everything else:
    histograms (L, E, S, bins+1), the series (L, E, S, T_s, n_tracks).
    """
    lam_grid = np.asarray(lam_grid, np.float32).reshape(-1)
    if np.any(lam_grid < 0):
        raise ValueError(f"lam_grid must be >= 0, got {lam_grid}")
    if _fleet_engaged(fleet, policy, cfg, scenario, placement, replication,
                      telemetry, control):
        from repro_torch.sharding import sim as fleet_sim
        return fleet_sim.fleet_sweep(policy, cfg, lam_grid, est_stack,
                                     seeds, fleet, device=device, rng=rng)
    est_stack = _as_numpy(est_stack)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    shape = (len(lam_grid), len(est_stack), len(seeds))
    grid = [(lam, e, s) for lam in lam_grid
            for e in range(shape[1]) for s in seeds]
    out = _dense_run(policy, cfg, [(s, lam) for lam, _, s in grid],
                     est_stack[[e for _, e, _ in grid]], device, rng,
                     scenario, placement, replication, telemetry, control)
    return {k: v.reshape(shape + v.shape[1:]) for k, v in out.items()}
