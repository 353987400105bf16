"""Claim helpers shared by the PANDAS-family service step (port of
`repro.core.claiming`).  Only `tier_rates` is ported so far; the
sequential `claim_loop` of JSQ-MaxWeight/Priority comes with the dense
slice."""

from __future__ import annotations

import torch


def tier_rates(serving_tier: torch.Tensor, tmk: torch.Tensor) -> torch.Tensor:
    """(M,) current true service rate per server: row m of the (M, K) true
    rates at the in-service class, 0 where idle."""
    k = tmk.shape[1]
    idx = torch.clamp(serving_tier.long() - 1, 0, k - 1)
    rate = torch.gather(tmk, 1, idx[:, None])[:, 0]
    return torch.where(serving_tier > 0, rate, torch.zeros_like(rate))
