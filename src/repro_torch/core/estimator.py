"""Online processing-rate estimation (counterpart of
`repro.core.estimator`; the host-side half, copied: numpy).

The scheduler observes realized service times per (server, locality-tier)
and keeps EWMA estimates of the rates (Blind GB-PANDAS, Yekkehkhany &
Nagi 2020).  The serving engine feeds it one observation per admitted
request.  The functional `ewma_update`/`ewma_time_update` of the
reference belong to the blind simulator policy and wait for it (ROADMAP
Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EwmaRateEstimator:
    """Host-side per-(server, tier) EWMA rate estimator with priors.

    Until a (server, tier) pair has `min_samples` observations its estimate is
    blended toward the prior, which keeps cold-start routing sane (the blind
    algorithm's exploration phase).
    """

    num_servers: int
    prior: np.ndarray  # (K,) prior tier rates (fastest first)
    decay: float = 0.98
    min_samples: int = 8

    def __post_init__(self):
        # EWMA the service TIME and invert: 1/E[T] is the consistent rate
        # estimator (E[1/T] diverges for exponential service).
        self.prior = np.asarray(self.prior, np.float64)
        self._time = np.tile(1.0 / self.prior, (self.num_servers, 1))
        self._count = np.zeros((self.num_servers, self.prior.size), np.int64)

    @property
    def num_tiers(self) -> int:
        return int(self.prior.size)

    def observe(self, server: int, tier: int, service_time: float) -> None:
        """Record one completed task's service time (tier: 0 local ..
        K-1 remote)."""
        self._time[server, tier] = (self.decay * self._time[server, tier]
                                    + (1.0 - self.decay)
                                    * max(service_time, 1e-9))
        self._count[server, tier] += 1

    @property
    def rates(self) -> np.ndarray:
        """(M, 3) current estimates, prior-blended where under-sampled."""
        return self.rates_for(slice(None))

    def rates_for(self, servers) -> np.ndarray:
        """(len(servers), 3) estimates for a subset of servers — O(subset),
        for candidate-sampling routers that must not touch all M rows."""
        w = np.minimum(self._count[servers] / self.min_samples, 1.0)
        est = 1.0 / np.maximum(self._time[servers], 1e-9)
        return (w * est + (1.0 - w) * self.prior[None, :]).astype(np.float32)

    @property
    def sample_counts(self) -> np.ndarray:
        return self._count.copy()
