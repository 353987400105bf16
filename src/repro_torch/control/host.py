"""Host-clock projection of a control plane for the serving engine
(counterpart of `repro.control.host`; a copy: numpy).

Same controllers, different substrate: admission runs per submitted
request on the engine step clock, autoscaling is the reactive
`launch.elastic.Autoscaler` fed by the engine's measured sojourn p95,
and closed-loop load generation is a seeded client pool
(`ClosedLoopClients`) that gates submissions on completions.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

from repro_torch.control.plane import ControlPlane


class ClosedLoopClients:
    """N think-time users on the host step clock.

    Each user holds at most one request in the system.  After their
    request completes they think for Exp(think_time) steps (seeded numpy
    RNG, the reference's draws in the reference's order) before
    submitting the next one.  Initial submissions are staggered uniformly
    over one think time so the run does not open with an N-wide burst.

    Drive it with `poll(step, completed_total)`: report the engine's
    cumulative completion count and get back how many fresh requests to
    submit at this step.
    """

    def __init__(self, users: int, think_time: float, seed: int = 0):
        if users < 1:
            raise ValueError("users must be >= 1")
        if think_time <= 0.0:
            raise ValueError("think_time must be > 0")
        self.users = int(users)
        self.think_time = float(think_time)
        self._rng = np.random.default_rng(seed)
        stagger = self._rng.uniform(0.0, think_time, size=self.users)
        self._ready: List[float] = sorted(stagger)
        heapq.heapify(self._ready)
        self._last_completed = 0
        self.in_flight = 0

    def poll(self, step: int, completed_total: int) -> int:
        """Number of new requests to submit at ``step``."""
        newly_done = completed_total - self._last_completed
        self._last_completed = completed_total
        for _ in range(max(newly_done, 0)):
            # a completion frees its user into a think period
            self.in_flight -= 1
            think = self._rng.exponential(self.think_time)
            heapq.heappush(self._ready, step + think)
        n_new = 0
        while self._ready and self._ready[0] <= step:
            heapq.heappop(self._ready)
            n_new += 1
        self.in_flight += n_new
        return n_new

    @property
    def done(self) -> bool:
        """True when every user is idle with nothing queued to submit —
        only meaningful if the caller stops polling."""
        return self.in_flight == 0 and not self._ready


class HostControl:
    """Resolved host-side control plane for one engine run."""

    def __init__(self, plane: ControlPlane, spec, rate0: float,
                 seed: int = 0):
        self.plane = plane
        self.clients: Optional[ClosedLoopClients] = None
        if plane.loadgen is not None:
            self.clients = plane.loadgen.host_clients(seed=seed)
        self._adm = plane.admission
        self._adm_state = self._adm.host_init() if self._adm else None
        self.autoscaler = None
        if plane.autoscale is not None:
            num_servers = int(spec.num_servers)
            min_servers = max(int(getattr(spec, "num_racks", 1)), 1)
            self.autoscaler = plane.autoscale.host_autoscaler(
                num_servers, min_servers)
        self.shed = 0
        self.admitted = 0

    def admit(self, step: int, n_sys: int) -> bool:
        """Admission decision for one request arriving at ``step`` with
        ``n_sys`` requests currently in the system."""
        if self._adm is None:
            self.admitted += 1
            return True
        ok = self._adm.host_admit(self._adm_state, step, n_sys)
        if ok:
            self.admitted += 1
        else:
            self.shed += 1
        return ok

    def observe(self, step: int, p95: float) -> Optional[int]:
        """Feed the autoscaler one sojourn-p95 reading; returns the new
        active-server target when it changes, else None."""
        if self.autoscaler is None:
            return None
        return self.autoscaler.observe(step, p95)

    def metrics(self) -> dict:
        offered = self.admitted + self.shed
        out = {"ctl_admitted": self.admitted, "ctl_shed": self.shed,
               "ctl_shed_rate": self.shed / max(offered, 1)}
        if self.autoscaler is not None:
            out["ctl_active"] = self.autoscaler.current
        return out
