"""Elastic scaling of the serving fleet (counterpart of
`repro.launch.elastic`).

Ported so far: `Autoscaler`, the reactive host projection of the control
plane's ``autoscale`` controller, copied (hysteresis, cooldown, NaN
readings).  The reference module's training half — `HeartbeatMonitor`,
`plan_elastic_mesh`, `rebalance_batch` and `ElasticSupervisor`, the
fail -> replan -> restore -> resume loop of a training run — comes with
the port's training slice (ROADMAP Queue 1, item 11.5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
