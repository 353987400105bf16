"""Blind Balanced-PANDAS: online rate learning inside the simulator
(Blind GB-PANDAS, Yekkehkhany & Nagi 2020 — the paper's "future work"
arm), port of `repro.core.blind_pandas` (the dense path).

Identical queueing structure and service dynamics to `balanced_pandas`,
but the scheduler's rates are not an input: the policy starts from a
prior, observes every completed task's (server, tier, service time) and
keeps per-(server, tier) EWMA estimates of the service TIME in its own
state, inverted on read (1/E[T] is the consistent estimator), with a
floor that keeps routing finite while a pair is unobserved.  The ``est``
argument of `slot_step` is ignored: a blind scheduler has no oracle.
Its draws are Balanced-PANDAS's (route Gumbels, service uniforms).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import balanced_pandas as bp
from repro_torch.core import locality as loc
from repro_torch.core.estimator import ewma_time_update
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DrawPlan


class BlindPandasState(NamedTuple):
    core: bp.PandasState
    age: torch.Tensor   # (..., M) int32 completed slots of the task in service
    tbar: torch.Tensor  # (..., M, K) f32 EWMA'd service time per (server, tier)


def _mean_left_to_right(x: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis as the reference's compiled mean
    computes it at the pinned widths: the sum left to right, times the
    float32 reciprocal of the count."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc * torch.tensor(1.0 / x.shape[-1], dtype=x.dtype)


@register_policy
class BlindPandasPolicy(SlotPolicy):
    """Blind GB-PANDAS: Balanced-PANDAS that starts from a prior and keeps
    per-(server, tier) EWMA rate estimates inside the scan state,
    re-learning online when the true rates drift.  (The port's "scan
    state" is the dense slot loop's carry.)

    Options: ``prior`` — the (K,) tier rates the estimates start from;
    ``decay`` — EWMA decay per observation; ``floor`` — lower clamp on the
    read-side rate estimates.  Travel in
    ``PolicyConfig("blind_pandas", {"prior": (...), ...})``.
    """

    name = "blind_pandas"

    def __init__(self, prior: Sequence[float] = (0.5, 0.45, 0.25),
                 decay: float = 0.98, floor: float = 1e-3):
        prior = tuple(float(p) for p in prior)
        if len(prior) < 2 or any(not 0.0 < p <= 1.0 for p in prior):
            raise ValueError(f"prior must be >= 2 tier rates in (0, 1], "
                             f"got {prior}")
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.prior: Tuple[float, ...] = prior
        self.decay = decay
        self.floor = floor

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return DrawPlan(route="servers")

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> BlindPandasState:
        m = topo.num_servers
        if len(self.prior) != topo.num_tiers:
            raise ValueError(f"prior has {len(self.prior)} tiers but the "
                             f"topology has {topo.num_tiers}")
        lead = tuple(batch)
        tbar = 1.0 / torch.tensor(self.prior, dtype=torch.float32,
                                  device=device)
        return BlindPandasState(
            core=bp.init_state(topo, device, batch),
            age=torch.zeros(lead + (m,), dtype=torch.int32, device=device),
            tbar=tbar.expand(lead + (m, len(self.prior))).clone())

    def estimates(self, s: BlindPandasState) -> torch.Tensor:
        """(..., M, K) current rate estimates the routing decisions use."""
        return torch.clamp(1.0 / torch.clamp(s.tbar, min=1e-9), self.floor,
                           1.0)

    def slot_step(self, s: BlindPandasState, draws, types, active, est,
                  true_rates, ancestors):
        del est  # blind: the policy trusts only its own observations
        core = bp.route_lanes(s.core, draws, types, active,
                              self.estimates(s), ancestors)
        # Balanced-PANDAS's service and scheduling; only the estimator
        # bookkeeping is new.  A task completing this slot took age + 1
        # slots of service.
        done, completions = bp.service_completions(core, draws.u_serve,
                                                   true_rates)
        k = s.tbar.shape[-1]
        tier = torch.clamp(core.serving.long() - 1, 0, k - 1)
        tbar = ewma_time_update(s.tbar, done, tier,
                                (s.age + 1).to(torch.float32), self.decay)
        new_core = bp.schedule_idle(core, done)
        # tasks that survived the slot age one slot; completed, fresh and
        # idle servers reset to zero
        age = torch.where((core.serving > 0) & ~done, s.age + 1,
                          torch.zeros_like(s.age))
        return BlindPandasState(new_core, age, tbar), completions

    def num_in_system(self, s: BlindPandasState) -> torch.Tensor:
        return bp.num_in_system(s.core)

    def extra_metrics(self, s: BlindPandasState):
        """Mean learned local-tier rate per cell: an observability hook
        for the drift figures (tracks straggler windows)."""
        return {"est_alpha_mean":
                _mean_left_to_right(self.estimates(s)[..., 0])}

    def telemetry_gauges(self, s: BlindPandasState):
        gauges = bp.telemetry_gauges(s.core)
        gauges["est_alpha_mean"] = _mean_left_to_right(
            self.estimates(s)[..., 0])
        return gauges
