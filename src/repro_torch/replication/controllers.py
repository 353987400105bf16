"""Built-in replication controllers, registered by name (counterpart of
`repro.replication.controllers`).

Each controller reduces to one function — the target replica count per
chunk — evaluated on both substrates from the same inputs (liveness and
read popularity).  The lifecycle machinery (wipe / repair / drop /
migrate under the bandwidth cap) is shared; see
`repro_torch.replication.simproj` and `repro_torch.replication.host`.
On the simulator substrate the inputs carry a leading cell dimension:
``pop`` and ``live`` are (N, C), ``base_tgt`` is (C,).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.replication.lifecycle import (ReplicationController,
                                               register_replication)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """(...) float32 quantile `q` of each row of `x` (..., C) by linear
    interpolation, as the reference's compiled ``jnp.quantile`` forms it:
    the row sorted, ``pos = q * (C - 1)`` in float32, ``w = pos -
    floor(pos)``, then ``low_value * (1 - w) + high_value * w`` with the
    first product fused into the sum (one rounding; XLA contracts it
    inside the simulator's scan): that product is exact in float64 and
    the sum is rounded once more to float32, which differs from one
    rounding only on a float32 tie.  `torch.quantile` interpolates
    another way and can differ from it in the last bit."""
    c = x.shape[-1]
    pos = np.float32(q) * np.float32(c - 1)
    low = int(np.clip(math.floor(pos), 0, c - 1))
    high = int(np.clip(math.ceil(pos), 0, c - 1))
    w_high = np.float32(pos - np.float32(math.floor(pos)))
    w_low = np.float32(np.float32(1.0) - w_high)
    srt = torch.sort(x, dim=-1).values
    # the weights are float32 values, passed as Python floats: no
    # host-to-device copy
    hi = (srt[..., high] * float(w_high)).to(torch.float64)
    return (srt[..., low].to(torch.float64) * float(w_low) + hi
            ).to(torch.float32)


@register_replication
class FixedReplication(ReplicationController):
    """The paper's static default: every chunk keeps whatever replicas the
    placement policy gave it — never migrates, widens, or repairs.  With
    no failure scenario this is bitwise-identical to the pre-replication
    code path (the lifecycle machinery is skipped entirely); under
    ``server_loss`` / ``rack_loss`` it only *observes* the damage, which
    is exactly what makes it the availability baseline."""

    name = "fixed"
    is_static = True

    def sim_targets(self, pop, live, base_tgt):
        # Target == live: deficits and surpluses are both zero by
        # construction, so the machinery never starts a move or drops a
        # replica — failures just reduce `live` (and the target with it).
        return live

    def host_targets(self, counts: Mapping[int, int], live: np.ndarray,
                     base_tgt: np.ndarray) -> np.ndarray:
        return live.astype(np.int64)


@register_replication
class RepairReplication(ReplicationController):
    """Failure-driven re-replication: after a server or rack dies, rebuild
    every chunk back to its initial replication factor from the surviving
    copies, paying migration bandwidth through the repair lanes.  The
    ``lanes`` cap is the repair-bandwidth budget — a storm after a rack
    loss queues behind it and contends with foreground traffic instead of
    saturating the fabric (HDFS-style re-replication)."""

    name = "repair"

    def sim_targets(self, pop, live, base_tgt):
        return base_tgt.expand_as(live)

    def host_targets(self, counts: Mapping[int, int], live: np.ndarray,
                     base_tgt: np.ndarray) -> np.ndarray:
        return base_tgt.astype(np.int64)


@register_replication
class PopularityReplication(ReplicationController):
    """Adaptive replication factor: chunks in the top ``hot_frac`` of
    (decayed) read popularity hold ``r_hot`` replicas, the rest ``r_cold``
    — extra copies of hot data buy locality and failure headroom where
    reads actually land, at the cost of migration bandwidth when
    popularity drifts.  Subsumes repair: a dead replica of any chunk is
    rebuilt toward the popularity-driven target."""

    name = "popularity"

    def __init__(self, r_hot: int = 5, r_cold: int = 3,
                 hot_frac: float = 0.125, decay: float = 0.02, **common):
        super().__init__(**common)
        if r_cold < 1 or r_hot < r_cold:
            raise ValueError(f"need 1 <= r_cold <= r_hot, "
                             f"got r_cold={r_cold}, r_hot={r_hot}")
        if not 0.0 < hot_frac < 1.0:
            raise ValueError(f"hot_frac must be in (0, 1), got {hot_frac}")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.r_hot = int(r_hot)
        self.r_cold = int(r_cold)
        self.hot_frac = float(hot_frac)
        self.decay = float(decay)

    def max_target(self, base: int) -> int:
        return max(int(base), self.r_hot)

    def sim_targets(self, pop, live, base_tgt):
        thr = quantile_linear(pop, 1.0 - self.hot_frac)
        hot = (pop >= thr[..., None]) & (pop > 0.0)
        return torch.where(hot, self.r_hot, self.r_cold).to(live.dtype)

    def host_targets(self, counts: Mapping[int, int], live: np.ndarray,
                     base_tgt: np.ndarray) -> np.ndarray:
        tgt = np.full(live.shape[0], self.r_cold, np.int64)
        if counts:
            n_hot = max(1, round(self.hot_frac * len(counts)))
            # ties toward the smaller chunk id, mirroring hot_aware
            ranked = sorted(counts, key=lambda c: (-counts[c], c))
            for c in ranked[:n_hot]:
                if 0 <= c < tgt.shape[0]:
                    tgt[c] = self.r_hot
        return tgt
