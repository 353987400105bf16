"""The dense simulator's projection of a control plane (counterpart of
`repro.control.simproj`), batched over the N cells of a sweep: fixed
shapes, no draw, no read of a device value.

The step seam (`core.simulator._build_dense_step`) is two hooks around
the slot's arrival -> route -> serve order:

  1. `offered_lam` (before the arrivals): the loadgen shapes the offered
     rate — closed loop derives it from the thinking population, open
     loop replays the scenario track — and may cap the admitted count.
     The rate reaches the arrival count through the draw seam
     (`core.rng.DenseDeviceSource`): open loop's ``extra_mult`` is
     folded into each cell's count law, and closed loop's count is the
     seam's ``n_by_k`` table entry at the thinking population;
  2. `pre` (after the arrivals, before the replication lifecycle and the
     routing): the loadgen cap and the admission controller trim the
     fixed-shape lane mask (shedding or deferring before routing, so a
     shed task never touches a queue or the telemetry sojourn pairing),
     the window-gated counters advance, and the autoscaler turns the
     slot's offered rate into an (N, M) routable-server mask through
     the locality-aware `scale_priority` rank.

The conservation identity ``offered == admitted + shed + backlog`` holds
slot by slot over a window that starts at slot 0.  Deferred arrivals
re-enter through the lanes ``[n_admit, n_admit + n_release)`` of the
slot's drawn types (the arrival sampler types every lane B).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.control.plane import ControlPlane, scale_priority


class CtlState(NamedTuple):
    """Control-plane slice of the dense carry, one entry a cell (all
    in-window counters except the bucket and backlog levels, which are
    live)."""

    offered: torch.Tensor     # (N,) i32 candidate arrivals (post loadgen cap)
    admitted: torch.Tensor    # (N,) i32 entered the system (incl. releases)
    shed: torch.Tensor        # (N,) i32 rejected outright
    tokens: torch.Tensor      # (N,) f32 token-bucket level
    backlog: torch.Tensor     # (N,) f32 deferred arrivals awaiting release
    active_sum: torch.Tensor  # (N,) f32 sum of active-server counts
    active_n: torch.Tensor    # (N,) f32 slots accumulated into active_sum
    active_min: torch.Tensor  # (N,) f32 min active-server count seen


class SimControl:
    """A control plane for one (topology, config, schedule) on one
    device; the cell count comes with `init`."""

    def __init__(self, plane: ControlPlane, topo, cfg, sched, rate0: float,
                 device=None):
        self.plane = plane
        self.device = torch.device("cpu" if device is None else device)
        self.max_arrivals = int(cfg.max_arrivals)
        self.num_servers = int(topo.num_servers)
        self.rate0 = float(rate0)
        self.has_mask = plane.autoscale is not None
        # rank r is the r-th server kept on shrink (round-robin across
        # racks, so a shrunken fleet still spans every rack); built once
        self._rank = torch.as_tensor(scale_priority(topo),
                                     device=self.device) \
            if self.has_mask else None
        self._lanes = torch.arange(self.max_arrivals, device=self.device)
        # the draw seam's count law (`count_law`)
        lg = plane.loadgen
        if lg is not None and lg.name not in ("open_loop", "closed_loop"):
            # the count is drawn before the slot from a known law
            raise ValueError(f"loadgen {lg.name!r}: the dense simulator's "
                             f"draw seam knows the count law of open_loop "
                             f"and closed_loop only")
        self.closed_loop = lg is not None and lg.name == "closed_loop"
        users = None if sched is None or sched.users_mult is None \
            else sched.users_mult.cpu().numpy()
        self._law = {}
        if self.closed_loop:
            self._law["users"] = (lg.max_users(users), lg.think_time)
        elif lg is not None and getattr(lg, "extra_mult", 1.0) != 1.0:
            self._law["extra_mult"] = float(lg.extra_mult)
        # a loadgen's constant factor and the autoscaler's headroom /
        # rate0 fold into one float32 constant in the reference's compiled
        # step (`controllers.HeadroomAutoscale.sim_scale`): the autoscaler
        # is then handed the loadgen's base rate and that constant
        self._fold = None
        scale = getattr(plane.autoscale, "sim_scale", None)
        if scale is not None and hasattr(lg, "sim_base"):
            self._fold = scale(self.rate0, lg.rate_factor)

    def count_law(self) -> dict:
        """Keyword arguments of `core.rng.DenseDeviceSource` for this
        plane's arrival count: ``extra_mult`` (open loop) or ``users=(U,
        think_time)``, U the largest user count over the schedule
        (closed loop); empty without a loadgen that moves the count."""
        return dict(self._law)

    # -- carry ------------------------------------------------------------

    def init(self, n_cells: int = 1) -> CtlState:
        adm = self.plane.admission
        tokens, backlog = adm.sim_init() if adm is not None else (0.0, 0.0)
        n = (int(n_cells),)
        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        return CtlState(
            offered=torch.zeros(n, **i32), admitted=torch.zeros(n, **i32),
            shed=torch.zeros(n, **i32),
            tokens=torch.full(n, tokens, **f32),
            backlog=torch.full(n, backlog, **f32),
            active_sum=torch.zeros(n, **f32), active_n=torch.zeros(n, **f32),
            active_min=torch.full(n, float(self.num_servers), **f32))

    # -- per-slot hooks ---------------------------------------------------

    def offered_lam(self, n_prev, lam_total, knobs):
        """The slot's offered rate ((N,) float32; None when no autoscaler
        reads it) and the admitted-count cap ((N,) int32, or None).  Gates
        on the policy's in-system count `n_prev`, so the closed loop stays
        exact even for policies that drop internally (FIFO's cap).  Where
        the loadgen's factor folds into the autoscaler's constant, the
        rate is the loadgen's base (`pre` multiplies it by the fold)."""
        lg = self.plane.loadgen
        if lg is None:
            lam = lam_total * knobs.lam_mult if self.has_mask else None
            return lam, None
        if self._fold is not None:
            return lg.sim_base(n_prev, lam_total, knobs)
        lam, cap = lg.sim_offered(n_prev, lam_total, knobs)
        return (lam if self.has_mask else None), cap

    def pre(self, st: CtlState, active, cap, n_prev, lam_eff,
            in_window: bool
            ) -> Tuple[CtlState, torch.Tensor, Optional[torch.Tensor]]:
        """Trim the (N, B) lane mask (loadgen cap + admission) and compute
        the slot's (N, M) active-server mask (autoscale).  `in_window` is
        a Python bool.  Returns (state', active', server_mask or None)."""
        n_arr = active.sum(dim=-1).to(torch.int32)
        if cap is not None:
            # closed loop: a user still thinking cannot submit, so excess
            # Poisson draws are never offered
            n_arr = torch.minimum(n_arr, cap.to(torch.int32))
        adm = self.plane.admission
        tokens, backlog = st.tokens, st.backlog
        n_release = n_shed = None
        if adm is not None:
            spare = self.max_arrivals - n_arr
            tokens, backlog, n_admit, n_release, n_shed = adm.sim_admit(
                tokens, backlog, n_arr, n_prev, spare)
            n_new = torch.clamp(n_admit + n_release, max=self.max_arrivals)
        else:
            n_new = n_arr
        active = self._lanes < n_new[:, None]
        st = st._replace(tokens=tokens, backlog=backlog)
        if in_window:
            st = st._replace(
                offered=st.offered + n_arr, admitted=st.admitted + n_new,
                shed=st.shed if n_shed is None else st.shed + n_shed)
        mask = None
        if self.has_mask:
            asc = self.plane.autoscale
            count = asc.sim_target(lam_eff, self.num_servers, self.rate0) \
                if self._fold is None else \
                asc.sim_count(lam_eff, self._fold, self.num_servers)
            mask = self._rank < count[:, None]
            if in_window:
                cnt_f = count.to(torch.float32)
                st = st._replace(active_sum=st.active_sum + cnt_f,
                                 active_n=st.active_n + 1.0,
                                 active_min=torch.minimum(st.active_min,
                                                          cnt_f))
        return st, active, mask

    # -- outputs ----------------------------------------------------------

    def measured_rate(self, st: CtlState, n_meas):
        """Admitted tasks per in-window slot — the Little's-law
        denominator once control reshapes the arrival stream."""
        return st.admitted.to(torch.float32) / torch.clamp(n_meas, min=1.0)

    def mean_delay(self, st: CtlState, mean_n, n_meas):
        """Little's law over the measured admitted rate, NaN where nothing
        was admitted: ``mean_n / measured_rate``, two float32 divisions as
        the reference's compiled ``sweep`` forms them.  (Its compiled
        ``simulate`` rewrites ``a / (b / c)`` as ``(a * c) / b``, at most
        one ulp away; the port's `simulate` is a one-cell sweep.)"""
        rate = self.measured_rate(st, n_meas)
        return torch.where(rate > 0, mean_n / rate,
                           torch.full_like(mean_n, float("nan")))

    def metrics(self, st: CtlState):
        offered = st.offered.to(torch.float32)
        out = {
            "ctl_offered": offered,
            "ctl_admitted": st.admitted.to(torch.float32),
            "ctl_shed": st.shed.to(torch.float32),
            "ctl_shed_rate": st.shed.to(torch.float32)
            / torch.clamp(offered, min=1.0),
        }
        adm = self.plane.admission
        if adm is not None and adm.defers:
            out["ctl_backlog"] = st.backlog
        if self.has_mask:
            out["ctl_active_mean"] = st.active_sum \
                / torch.clamp(st.active_n, min=1.0)
            out["ctl_active_min"] = st.active_min
        return out


CONTROL_METRIC_KEYS = ("ctl_offered", "ctl_admitted", "ctl_shed",
                       "ctl_shed_rate", "ctl_backlog", "ctl_active_mean",
                       "ctl_active_min")
