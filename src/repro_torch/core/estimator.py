"""Online processing-rate estimation (counterpart of
`repro.core.estimator`).

The scheduler observes realized service times per (server, locality-tier)
and keeps EWMA estimates of the rates (Blind GB-PANDAS, Yekkehkhany &
Nagi 2020).  Two halves, as in the reference:

  * `ewma_update` / `ewma_time_update` — functional tensor updates, used
    inside the simulator by the blind policy (`core.blind_pandas`);
  * `EwmaRateEstimator` — host-side (numpy), fed one observation per
    admitted request by the serving engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _ewma(old: torch.Tensor, new: torch.Tensor, decay: float):
    """float32 ``decay * old + (1 - decay) * new`` with the first product
    fused into the sum (one rounding), as the reference's compiled update
    computes it: that product is exact in float64 and the sum is rounded
    once more to float32, which differs from one rounding only on a
    float32 tie (about 2^-29 of the sums)."""
    fresh = ((1.0 - decay) * new).to(torch.float64)
    d = float(np.float32(decay))
    return (d * old.to(torch.float64) + fresh).to(torch.float32)


def ewma_update(est: torch.Tensor, server, tier, service_slots,
                decay: float = 0.98) -> torch.Tensor:
    """Functional EWMA update of est (M, K) from one completed task:
    a new tensor with est[server, tier] moved toward the rate sample
    1/service_slots (the unbiased sample for geometric service)."""
    slots = torch.as_tensor(service_slots, device=est.device)
    sample = 1.0 / torch.clamp(slots.to(torch.float32), min=1.0)
    out = est.clone()
    out[server, tier] = _ewma(est[server, tier], sample, decay)
    return out


def ewma_time_update(tbar: torch.Tensor, done: torch.Tensor,
                     tier: torch.Tensor, service_slots: torch.Tensor,
                     decay: float = 0.98) -> torch.Tensor:
    """Masked EWMA of the service TIME, one slot for all servers.

    tbar (..., M, K) EWMA'd service time per (server, tier); done (..., M)
    bool completions this slot; tier (..., M) tier served (0..K-1);
    service_slots (..., M) float32 observed completion times.  Like the
    host estimator, the TIME is averaged and the consumer inverts it
    (1/E[T] is the consistent rate estimator).  Fixed shapes, no
    scatter."""
    upd = _ewma(tbar, service_slots[..., None].expand_as(tbar), decay)
    tiers = torch.arange(tbar.shape[-1], device=tbar.device)
    mask = done[..., None] & (tiers == tier[..., None])
    return torch.where(mask, upd, tbar)


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
