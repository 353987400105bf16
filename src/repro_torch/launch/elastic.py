"""Fault tolerance and elastic scaling (counterpart of
`repro.launch.elastic`; copied: plain Python): heartbeat failure
detection, legal-mesh replanning, a restart supervisor, and the serving
fleet's autoscaler.

The contract, as in the reference:
  1. HeartbeatMonitor flags hosts silent past the timeout;
  2. plan_elastic_mesh() picks the largest legal (dp, model) grid on the
     surviving chips — the model axis is preserved; the data axis
     shrinks, the global batch is kept by raising the microbatch count
     (rebalance_batch);
  3. the supervisor restores the latest atomic checkpoint and resumes.

On one card the mesh is (1, 1): `ElasticSupervisor.build` is the port's
`launch.steps.build_train_step` at the replanned microbatch count, and
its ``checkpointer`` is the port's `checkpoint.Checkpointer`, whose
`restore` places the state on the card (the reference restores onto the
new mesh's shardings).

`Autoscaler` is the reactive host projection of the control plane's
``autoscale`` controller (hysteresis, cooldown, NaN readings).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks worker liveness from heartbeat timestamps."""

    num_workers: int
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.monotonic()
        self._last: Dict[int, float] = {w: now for w in
                                        range(self.num_workers)}

    def beat(self, worker: int, t: Optional[float] = None) -> None:
        self._last[worker] = time.monotonic() if t is None else t

    def failed(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [w for w, t in self._last.items()
                if now - t > self.timeout_s]

    def alive(self, now: Optional[float] = None) -> List[int]:
        bad = set(self.failed(now))
        return [w for w in range(self.num_workers) if w not in bad]


def plan_elastic_mesh(available_chips: int, model_axis: int,
                      chips_per_host: int = 4,
                      pod_size: int = 256) -> Tuple[Tuple[int, ...],
                                                    Tuple[str, ...]]:
    """Largest legal mesh on the surviving fleet.

    Keeps the model (TP) axis intact — checkpointed parameter shards are laid
    out per model-rank — and shrinks the data axis to the largest multiple
    that fits.  Returns (shape, axis_names); raises if not even one model
    group survives.
    """
    if available_chips < model_axis:
        raise RuntimeError(
            f"only {available_chips} chips left; cannot form one "
            f"model-parallel group of {model_axis}")
    data = available_chips // model_axis
    if available_chips >= 2 * pod_size and data % 2 == 0:
        pods = min(available_chips // pod_size, 2)
        return (pods, data // pods, model_axis), ("pod", "data", "model")
    return (data, model_axis), ("data", "model")


def rebalance_batch(global_batch: int, old_dp: int, new_dp: int,
                    microbatches: int) -> Tuple[int, int]:
    """Keep the global batch across a shrink: raise microbatch count so the
    per-device-per-microbatch batch stays >= 1 and divisibility holds."""
    n_mb = microbatches
    while global_batch % n_mb or (global_batch // n_mb) % new_dp:
        n_mb += 1
        if n_mb > global_batch:
            raise RuntimeError(
                f"cannot split batch {global_batch} over dp={new_dp}")
    return global_batch, n_mb


@dataclasses.dataclass
class Autoscaler:
    """Reactive fleet autoscaler: p95-threshold hysteresis + cooldown.

    The host projection of `repro_torch.control`'s ``autoscale``
    controller (the simulator's projection plans from the known rate
    track; this one reacts to the measured sojourn p95 the serving engine
    feeds it).

    Hysteresis: ``up_after`` CONSECUTIVE readings above ``p95_high``
    grow the active-server target by ``ceil(step_frac * current)``;
    ``down_after`` consecutive readings below ``p95_low`` shrink it by
    the same step.  Readings between the thresholds (or NaN — no data
    yet) reset both streaks, and after any action the ``cooldown``
    window ignores readings entirely, so a scale-up must prove itself
    before the next move.  The asymmetry (``down_after`` >
    ``up_after``) is deliberate: scaling up is cheap and urgent,
    scaling down risks re-breaching — the standard conservative-down
    rule.  Targets clamp to [min_servers, max_servers].

    `observe(step, p95)` returns the new target when it changes, else
    None; `current` always holds the live target.
    """

    min_servers: int
    max_servers: int
    p95_high: float = 64.0
    p95_low: float = 16.0
    up_after: int = 2
    down_after: int = 8
    cooldown: int = 16
    step_frac: float = 0.25

    def __post_init__(self):
        if not 1 <= self.min_servers <= self.max_servers:
            raise ValueError(
                f"need 1 <= min_servers <= max_servers, got "
                f"[{self.min_servers}, {self.max_servers}]")
        if self.p95_low > self.p95_high:
            raise ValueError(f"need p95_low <= p95_high, got "
                             f"{self.p95_low} > {self.p95_high}")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        if not 0.0 < self.step_frac <= 1.0:
            raise ValueError(f"step_frac must be in (0, 1], got "
                             f"{self.step_frac}")
        self.current = self.max_servers
        self._hi_streak = 0
        self._lo_streak = 0
        self._cooldown_until = 0

    def _step(self) -> int:
        return max(1, int(-(-self.current * self.step_frac // 1)))

    def observe(self, step: int, p95: float) -> Optional[int]:
        """One p95 reading at engine step ``step``; returns the new
        target iff it changed."""
        if step < self._cooldown_until:
            return None
        if not (p95 == p95):  # NaN: no sojourn data yet
            self._hi_streak = self._lo_streak = 0
            return None
        if p95 > self.p95_high:
            self._hi_streak += 1
            self._lo_streak = 0
        elif p95 < self.p95_low:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = self._lo_streak = 0
            return None
        target = self.current
        if self._hi_streak >= self.up_after:
            target = min(self.current + self._step(), self.max_servers)
        elif self._lo_streak >= self.down_after:
            target = max(self.current - self._step(), self.min_servers)
        if target == self.current:
            return None
        self.current = target
        self._hi_streak = self._lo_streak = 0
        self._cooldown_until = step + self.cooldown
        return target


@dataclasses.dataclass
class ElasticSupervisor:
    """Drives fail -> replan -> restore -> resume for a training run.

    `build` is a factory: build(mesh_shape, axis_names, n_mb) ->
    (step_fn, state_template, ...); on one card, the port's
    `build_train_step` at ``n_mb`` microbatches.  ``checkpointer`` is a
    `Checkpointer`: its `restore(state_template, device=...)` loads the
    last checkpoint onto the card.
    """

    build: Callable
    checkpointer: "object"
    model_axis: int
    global_batch: int
    microbatches: int

    def replan(self, available_chips: int):
        shape, names = plan_elastic_mesh(available_chips, self.model_axis)
        dp = 1
        for s, n in zip(shape, names):
            if n in ("pod", "data"):
                dp *= s
        _, n_mb = rebalance_batch(self.global_batch, None, dp,
                                  self.microbatches)
        return shape, names, n_mb
