"""Built-in controllers: open/closed-loop load generation, token-bucket
and queue-threshold admission, and headroom/hysteresis autoscaling
(counterpart of `repro.control.controllers`).

The ``sim_*`` hooks work on (N,) tensors, one entry a cell of a sweep,
and keep the reference's float32 order operation by operation; where the
reference divides by a Python float inside its compiled scan, XLA forms
a product with the float32 reciprocal of the float32 divisor (folded
with any constant factor before it), and the hooks multiply by that
same constant (`_f32_scale`).

XLA folds across hooks too.  A loadgen's offered rate is a base times a
constant factor (`rate_factor`: open loop's ``extra_mult``, closed
loop's ``1 / think_time``), and the autoscaler's ``headroom * lam_eff /
float32(rate0)`` multiplies it by two more; the compiled step forms one
product ``base * ((factor * headroom) * (1 / rate0))``, each step
rounded to float32 (`HeadroomAutoscale.sim_scale`,
tools/xla_control_fold.py).  So a plane with both hands the autoscaler
the loadgen's base and that one constant (`control.simproj.SimControl`),
never the rounded rate: two products, ``(thinking * (1 / think_time)) *
(headroom / rate0)``, put ``ceil`` one server off wherever the count
sits on an integer.  They draw nothing, so engaging a controller moves
no random number: the common-random-number coupling across policy arms
survives control.  The ``host_*`` hooks are the reference's Python.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.control.plane import (
    AdmissionController,
    AutoscaleController,
    LoadGenController,
    register_controller,
)


def _f32_scale(factor: float, divisor: float) -> float:
    """``factor / divisor`` as the reference's compiled step applies it to
    a float32 value: ``float32(factor) * (float32(1) / float32(divisor))``
    in float32, exact as a Python float, so a product with it is one
    float32 multiply on the CPU and the card alike."""
    recip = np.float32(1.0) / np.float32(divisor)
    return float(np.float32(factor) * recip)


@register_controller
@dataclasses.dataclass(frozen=True)
class OpenLoopLoadGen(LoadGenController):
    """Open-loop load generator: replay the scenario's rate track
    untouched (rate-driven arrivals, no completion feedback).

    The explicit spelling of the default traffic model — the identity arm
    of a study and the seam where a custom track would plug in.
    `extra_mult` rescales the whole track (a study-level rho knob that
    leaves the scenario object untouched); the dense simulator's draw
    seam folds it into each cell's count law, at the reference's float32
    product ``(lam_total * lam_mult) * extra_mult``."""

    name = "open_loop"
    extra_mult: float = 1.0

    def __post_init__(self):
        if self.extra_mult < 0.0:
            raise ValueError("extra_mult must be >= 0")

    @property
    def rate_factor(self) -> float:
        return self.extra_mult

    def sim_base(self, in_flight, lam_total, knobs):
        """(base, cap): the offered rate is ``base * rate_factor``."""
        return lam_total * knobs.lam_mult, None

    def sim_offered(self, in_flight, lam_total, knobs):
        base, cap = self.sim_base(in_flight, lam_total, knobs)
        return base * self.extra_mult, cap


@register_controller
@dataclasses.dataclass(frozen=True)
class ClosedLoopLoadGen(LoadGenController):
    """Closed-loop load generator: N think-time users, arrivals gated on
    completions (in-system never exceeds the user count).

    The load-tester model: each of ``users`` clients holds at most one
    task in the system and thinks for a mean of ``think_time`` slots
    between completion and next submission.  Per slot, the thinking
    population is ``max(users_t - in_flight, 0)`` and the offered rate is
    ``thinking / think_time``; admitted arrivals are additionally capped
    at the thinking count so ``in_flight <= users_t`` holds exactly.  The
    scenario's ``users_mult`` track scales ``users_t`` over time; the
    configured ``lam_total`` is ignored, and `simulate`'s Little's-law
    denominator switches to the measured admitted rate.  The dense
    simulator's count is the draw seam's table entry at ``thinking``
    (`core.rng.DenseDeviceSource`, ``users=``)."""

    name = "closed_loop"
    users: int = 64
    think_time: float = 8.0

    def __post_init__(self):
        if self.users < 1:
            raise ValueError("users must be >= 1")
        if self.think_time <= 0.0:
            raise ValueError("think_time must be > 0")

    def users_t(self, mult):
        """The slot's user count: `users`, or ``max(round(users * mult),
        1)`` under a ``users_mult`` track (a float32 tensor, or numpy
        float32 values on the host)."""
        if mult is None:
            return self.users
        if isinstance(mult, torch.Tensor):
            return torch.clamp(torch.round(self.users * mult),
                               min=1.0).to(torch.int32)
        prod = np.float32(self.users) * np.asarray(mult, np.float32)
        return np.maximum(np.round(prod), np.float32(1.0)).astype(np.int32)

    def max_users(self, users_track) -> int:
        """The largest ``users_t`` over the schedule's segments (the
        (S,) float32 ``users_mult`` track, None: no track)."""
        return int(np.max(self.users_t(users_track))) \
            if users_track is not None else self.users

    @property
    def rate_factor(self) -> float:
        return _f32_scale(1.0, self.think_time)

    def sim_base(self, in_flight, lam_total, knobs):
        """(base, cap): the thinking count, as float32 and as the cap;
        the offered rate is ``base * rate_factor``."""
        users_t = self.users_t(getattr(knobs, "users_mult", None))
        thinking = torch.clamp(users_t - in_flight, min=0)
        return thinking.to(torch.float32), thinking

    def sim_offered(self, in_flight, lam_total, knobs):
        base, thinking = self.sim_base(in_flight, lam_total, knobs)
        return base * self.rate_factor, thinking

    def host_clients(self, seed: int = 0):
        from repro_torch.control.host import ClosedLoopClients
        return ClosedLoopClients(users=self.users, think_time=self.think_time,
                                 seed=seed)


@register_controller
@dataclasses.dataclass(frozen=True)
class TokenBucketAdmission(AdmissionController):
    """Token-bucket admission: refill ``rate`` tokens/slot up to
    ``burst``; arrivals beyond the bucket are shed (or deferred).

    The classic rate limiter: long-run admitted throughput is capped at
    ``rate`` while bursts up to ``burst`` pass unhindered.  With
    ``defer=True`` rejected arrivals join a bounded backlog
    (``backlog_cap``) and re-enter on later slots as spare fixed-shape
    arrival lanes free up; past the cap they are shed.  The bucket starts
    full."""

    name = "token_bucket"
    rate: float = 1.0
    burst: float = 16.0
    defer: bool = False
    backlog_cap: float = 256.0

    def __post_init__(self):
        if self.rate < 0.0:
            raise ValueError("rate must be >= 0")
        if self.burst < 1.0:
            raise ValueError("burst must be >= 1")
        if self.backlog_cap < 0.0:
            raise ValueError("backlog_cap must be >= 0")

    def sim_init(self):
        return float(self.burst), 0.0

    def sim_admit(self, tokens, backlog, n_arr, n_sys, spare):
        tokens = torch.clamp(tokens + self.rate, max=self.burst)
        n_admit = torch.minimum(n_arr, torch.floor(tokens).to(torch.int32))
        tokens = tokens - n_admit.to(torch.float32)
        rejected = n_arr - n_admit
        if not self.defers:
            return (tokens, backlog, n_admit, torch.zeros_like(n_arr),
                    rejected)
        # Deferred arrivals re-enter through spare lanes, still paying
        # tokens; whatever exceeds the backlog cap is shed.
        n_release = torch.minimum(
            torch.minimum(torch.floor(backlog).to(torch.int32), spare),
            torch.floor(tokens).to(torch.int32))
        tokens = tokens - n_release.to(torch.float32)
        backlog = backlog - n_release + rejected
        overflow = torch.clamp(backlog - self.backlog_cap, min=0.0)
        backlog = backlog - overflow
        n_shed = torch.round(overflow).to(torch.int32)
        return tokens, backlog, n_admit, n_release, n_shed

    @property
    def defers(self) -> bool:
        return self.defer

    def host_init(self) -> dict:
        return {"tokens": float(self.burst), "last_step": None}

    def host_admit(self, state: dict, step: int, n_sys: int) -> bool:
        last = state["last_step"]
        if last is None:
            last = step
        state["tokens"] = min(state["tokens"] + self.rate * (step - last),
                              self.burst)
        state["last_step"] = step
        if state["tokens"] >= 1.0:
            state["tokens"] -= 1.0
            return True
        return False


@register_controller
@dataclasses.dataclass(frozen=True)
class QueueThresholdAdmission(AdmissionController):
    """Queue-threshold admission: shed arrivals whenever in-system work
    already meets ``threshold`` (a hard cap on total backlog).

    The simplest overload guard — admitted arrivals per slot are
    ``clip(threshold - n_sys, 0, n_arr)``, so the post-admission system
    size never exceeds ``threshold`` by more than the service lag."""

    name = "queue_threshold"
    threshold: int = 128

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1")

    def sim_admit(self, tokens, backlog, n_arr, n_sys, spare):
        room = torch.clamp(self.threshold - n_sys, min=0)
        n_admit = torch.minimum(n_arr, room)
        return (tokens, backlog, n_admit, torch.zeros_like(n_arr),
                n_arr - n_admit)

    def host_admit(self, state: dict, step: int, n_sys: int) -> bool:
        return n_sys < self.threshold


@register_controller
@dataclasses.dataclass(frozen=True)
class HeadroomAutoscale(AutoscaleController):
    """Autoscaler: keep ``headroom`` x the offered load in active local
    service capacity (sim: planned from the rate track; host: reactive
    p95 thresholds with hysteresis + cooldown via `launch.elastic`).

    The simulator projection is proactive — the offered-rate track is
    known ahead of time, so the active count each slot is
    ``clip(ceil(headroom * lam_eff / rate0), min_servers, M)``: enough
    tier-0 capacity to absorb the load times a safety factor.  The host
    projection cannot see the future, so it reacts to the engine's
    measured sojourn p95: ``up_after`` consecutive breaches of
    ``p95_high`` grow the fleet by ``step_frac``, ``down_after``
    consecutive readings under ``p95_low`` shrink it, with ``cooldown``
    steps between actions (see `launch.elastic.Autoscaler`).  Descaled
    servers drain: routing stops sending them work (scores masked to
    +inf) but queued tasks keep serving — distinct from the replication
    `alive` track, where dead servers stop serving and lose replicas."""

    name = "autoscale"
    headroom: float = 1.35
    min_servers: Optional[int] = None
    p95_high: float = 64.0
    p95_low: float = 16.0
    up_after: int = 2
    down_after: int = 8
    cooldown: int = 16
    step_frac: float = 0.25

    def __post_init__(self):
        if self.headroom <= 0.0:
            raise ValueError("headroom must be > 0")
        if self.min_servers is not None and self.min_servers < 1:
            raise ValueError("min_servers must be >= 1")
        if not (0.0 < self.step_frac <= 1.0):
            raise ValueError("step_frac must be in (0, 1]")

    def _min_servers(self, num_servers: int, floor: int) -> int:
        lo = self.min_servers if self.min_servers is not None else floor
        return max(1, min(lo, num_servers))

    def sim_scale(self, rate0: float, factor: float = 1.0) -> float:
        """The one float32 constant of the reference's compiled
        ``headroom * (base * factor) / float32(rate0)``: ``(factor *
        headroom) * (1 / rate0)``, each product rounded to float32
        (`factor` a loadgen's `rate_factor`; 1.0: the rate itself)."""
        return _f32_scale(float(np.float32(factor)
                                * np.float32(self.headroom)), rate0)

    def sim_count(self, base, scale: float, num_servers: int):
        """(N,) int32 ``clip(ceil(base * scale), min_servers, M)``: one
        float32 product with the folded constant `scale`."""
        need = torch.ceil(base * scale)
        lo = self._min_servers(num_servers, 1)
        return torch.clamp(need.to(torch.int32), lo, num_servers)

    def sim_target(self, lam_eff, num_servers: int, rate0: float):
        return self.sim_count(lam_eff, self.sim_scale(rate0), num_servers)

    def host_autoscaler(self, num_servers: int, min_servers: int):
        from repro_torch.launch.elastic import Autoscaler
        return Autoscaler(
            min_servers=self._min_servers(num_servers, min_servers),
            max_servers=num_servers,
            p95_high=self.p95_high, p95_low=self.p95_low,
            up_after=self.up_after, down_after=self.down_after,
            cooldown=self.cooldown, step_frac=self.step_frac)
