"""Host-side cluster routers of the port (counterpart of
`repro.core.cluster`; copied: numpy): the paper's algorithms as an
online service for the serving engine.

"Servers" here are abstract workers (model-replica groups); "tasks" carry
a set of local workers (where their prefix-KV lives).  The fleet layout
is the same `locality.Topology` the simulator uses, so locality tiers
are K-generic: local (on-worker), one tier per hierarchy level, remote.

Every router subclasses `repro_torch.core.policy.Router` and speaks the
uniform ``route(locals_) -> Decision`` / ``claim(worker) -> Claim | None``
surface.  Each draws its tie-breaks from ``np.random.default_rng(seed)``
in the reference's order, so under one seed and one sequence of calls
the port and the reference make the same decisions, also after the
autoscaling seam (`Router.set_active`, a routable-worker mask) has
parked some workers: the three per-worker-queue routers fall back to
the active fleet as the reference's do, drawing the same numbers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.locality import Topology
from repro_torch.core.policy import Claim, Decision, Router, register_router


def ClusterSpec(num_workers: int, workers_per_pod: int) -> Topology:
    """Retired host-side fleet spec, kept as a constructor shim: the
    unified `Topology` replaces it everywhere and validates what
    ClusterSpec never did (group sizes must tile ``num_workers``)."""
    return Topology(num_workers, workers_per_pod)


def worker_tiers(spec: Topology, locals_: Sequence[int]) -> np.ndarray:
    """(M,) tier index (0 local .. K-1 remote) of each worker for a task
    whose data lives on `locals_` — the host-side `server_tiers`."""
    anc = np.asarray(spec.ancestors)
    locals_ = list(locals_)
    tier = np.full(spec.num_workers, spec.num_tiers - 1, np.int64)
    for lvl in range(anc.shape[0] - 1, -1, -1):
        tier[np.isin(anc[lvl], anc[lvl][locals_])] = lvl + 1
    tier[locals_] = 0
    return tier


def pair_worker_tiers(spec: Topology, worker: int) -> np.ndarray:
    """(M,) pair tier of every worker n w.r.t. `worker` (0 if n == worker,
    else 1 + deepest shared level, else K-1) — the host-side
    `locality.pair_tiers`."""
    anc = np.asarray(spec.ancestors)
    tier = np.full(spec.num_workers, spec.num_tiers - 1, np.int64)
    for lvl in range(anc.shape[0] - 1, -1, -1):
        tier[anc[lvl] == anc[lvl, worker]] = lvl + 1
    tier[worker] = 0
    return tier


def tier_of(spec: Topology, locals_: Sequence[int], worker: int) -> int:
    """Tier index (0 local .. K-1 remote) of one worker — shared helper."""
    if worker in set(locals_):
        return 0
    anc = np.asarray(spec.ancestors)
    for lvl in range(anc.shape[0]):
        if anc[lvl, worker] in set(int(a) for a in anc[lvl, list(locals_)]):
            return lvl + 1
    return spec.num_tiers - 1


@register_router
class BalancedPandasRouter(Router):
    """Incremental Balanced-PANDAS over an abstract worker fleet: weighted
    workload / estimated rate argmin per arrival, with the production
    two-stage tie-break (minimal score, then fastest tier, then random).
    """

    name = "balanced_pandas"

    def __init__(self, spec: Topology, rates: Sequence[float],
                 estimator=None, seed: int = 0):
        super().__init__(spec, rates, estimator=estimator, seed=seed)
        # one queue per (worker, tier)
        self.q = np.zeros((spec.num_workers, self.num_tiers), np.int64)

    def tiers(self, locals_: Sequence[int]) -> np.ndarray:
        """(M,) tier index of each worker for this task."""
        return worker_tiers(self.spec, locals_)

    def workload(self) -> np.ndarray:
        est = self._est()
        return (self.q / est).sum(axis=1)

    def route(self, locals_: Sequence[int]) -> Decision:
        """Assign a task with the given local workers.

        Ties (typically W == 0 on an idle fleet, where W/rate cannot
        discriminate) break toward the highest-rate tier: an idle local
        worker always wins over an idle remote one.  The discrete-time
        simulator keeps the paper's uniform-random tie-break; this is the
        production-sensible refinement (noted in EXPERIMENTS.md).
        """
        est = self._est()
        tier = self.tiers(locals_)
        rate = np.take_along_axis(est, tier[:, None], axis=1)[:, 0]
        score = self.workload() / rate
        if not self.active_mask.all():
            # descaled workers take no NEW work (the simulator's
            # server_mask seam); their queues keep draining via claim()
            score = np.where(self.active_mask, score, np.inf)
        mins = np.flatnonzero(score <= score.min() * (1 + 1e-9))
        best_rate = rate[mins].max()
        cand = mins[rate[mins] >= best_rate * (1 - 1e-9)]
        m_star = int(self.rng.choice(cand))
        self.q[m_star, tier[m_star]] += 1
        return Decision(worker=m_star, tier=int(tier[m_star]))

    def claim(self, worker: int) -> Optional[Claim]:
        """Idle worker serves its own queues, fastest tier first."""
        for t in range(self.num_tiers):
            if self.q[worker, t] > 0:
                self.q[worker, t] -= 1
                return Claim(source=worker, tier=t)
        return None

    def queue_depths(self) -> np.ndarray:
        return self.q.sum(axis=1)


@register_router
class PandasPoDRouter(BalancedPandasRouter):
    """Power-of-d-choices Balanced-PANDAS: O(d) routing on the host path.

    Instead of scanning all M workers per arrival, compare weighted
    workloads over {the task's locals} ∪ {d uniform samples} only — the
    candidate scoring touches O(d) rows of the queue matrix, which is what
    makes the router viable at very large fleets.  Claiming and estimator
    plumbing are inherited unchanged from `BalancedPandasRouter`; the
    simulator's counterpart is `core/pandas_po2.py`.
    """

    name = "pandas_po2"

    def __init__(self, spec: Topology, rates: Sequence[float],
                 estimator=None, seed: int = 0, d: int = 2):
        super().__init__(spec, rates, estimator=estimator, seed=seed)
        if d < 1:
            raise ValueError(f"need d >= 1 candidate samples, got {d}")
        self.d = d

    def route(self, locals_: Sequence[int]) -> Decision:
        m = self.spec.num_workers
        locals_ = [int(x) for x in locals_]
        sampled = self.rng.choice(m, size=min(self.d, m), replace=False)
        cand = sorted(set(locals_) | {int(x) for x in sampled})
        if not self.active_mask.all():
            live = [c for c in cand if self.active_mask[c]]
            # all candidates descaled: fall back to the active fleet
            # rather than routing to a parked worker
            cand = live or np.flatnonzero(self.active_mask).tolist()
        # O(d * depth) tier derivation: never touch all M workers
        tier = np.array([tier_of(self.spec, locals_, c) for c in cand],
                        np.int64)
        # (C, K) estimated rates for the candidates only — never the full
        # (M, K) matrix, or the O(d) claim would be O(M) in disguise.
        est = (self.estimator.rates_for(cand) if self.estimator is not None
               else np.tile(self.prior, (len(cand), 1)))
        w = (self.q[cand] / est).sum(axis=1)
        rate = np.take_along_axis(est, tier[:, None], axis=1)[:, 0]
        score = w / rate
        mins = np.flatnonzero(score <= score.min() * (1 + 1e-9))
        best_rate = rate[mins].max()
        pick = mins[rate[mins] >= best_rate * (1 - 1e-9)]
        j = int(self.rng.choice(pick))
        m_star = cand[j]
        self.q[m_star, tier[j]] += 1
        return Decision(worker=m_star, tier=int(tier[j]))


@register_router
class JsqMaxWeightRouter(Router):
    """Incremental JSQ-MaxWeight baseline: shortest-queue routing with
    MaxWeight-style claiming over the same fleet abstraction.
    """

    name = "jsq_maxweight"

    def __init__(self, spec: Topology, rates: Sequence[float],
                 estimator=None, seed: int = 0):
        super().__init__(spec, rates, estimator=estimator, seed=seed)
        self.q = np.zeros(spec.num_workers, np.int64)

    def route(self, locals_: Sequence[int]) -> Decision:
        locals_ = list(locals_)
        if not self.active_mask.all():
            live = [w for w in locals_ if self.active_mask[w]]
            # JSQ routes among the task's locals; when every local is
            # descaled, widen to the active fleet (claim-side stealing
            # still drains parked queues)
            locals_ = live or np.flatnonzero(self.active_mask).tolist()
        j = _rand_argmin(self.rng, self.q[locals_].astype(np.float64))
        m_star = int(locals_[j])
        self.q[m_star] += 1
        return Decision(worker=m_star,
                        tier=tier_of(self.spec, locals_, m_star))

    def claim(self, worker: int) -> Optional[Claim]:
        """Idle worker claims the head task of the argmax weighted queue
        (MaxWeight work stealing); returns the queue (owning worker) claimed
        from, or None."""
        if not (self.q > 0).any():
            return None
        est = self._est()[worker]  # (K,)
        pair = pair_worker_tiers(self.spec, worker)
        w = est[pair]
        score = np.where(self.q > 0, w * self.q, -np.inf)
        n_star = _rand_argmax(self.rng, score)
        self.q[n_star] -= 1
        return Claim(source=int(n_star), tier=int(pair[n_star]))

    def queue_depths(self) -> np.ndarray:
        return self.q.copy()


@register_router
class FifoRouter(Router):
    """Global-FIFO baseline (Hadoop default).

    Stores its estimator like every other router (uniform base
    constructor): FIFO never *consults* rates, but `on_complete`
    observations still flow, so a fleet can switch from FIFO to a
    rate-aware policy without re-warming the estimates.
    """

    name = "fifo"

    def __init__(self, spec: Topology, rates: Sequence[float],
                 estimator=None, seed: int = 0):
        super().__init__(spec, rates, estimator=estimator, seed=seed)
        self.queue: List[List[int]] = []

    def route(self, locals_: Sequence[int]) -> Decision:
        self.queue.append(list(locals_))
        return Decision(worker=-1, tier=-1, deferred=True)

    def claim(self, worker: int) -> Optional[Claim]:
        if not self.queue:
            return None
        self.queue.pop(0)
        return Claim(source=-1, tier=-1)  # tier depends on the task itself


def _rand_argmin(rng, x: np.ndarray) -> int:
    mins = np.flatnonzero(x == x.min())
    return int(rng.choice(mins))


def _rand_argmax(rng, x: np.ndarray) -> int:
    maxs = np.flatnonzero(x == x.max())
    return int(rng.choice(maxs))
