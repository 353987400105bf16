"""Sequential task-claiming for single-queue-per-server policies (port of
`repro.core.claiming`).

JSQ-MaxWeight and Priority both schedule idle servers by scanning the
servers in a random order each slot and letting each idle server claim
the head task of the queue a policy-specific score picks.  Claims within
a slot are sequential so two servers cannot take the same last task; the
loop carries the live queue vector.

Every function takes leading batch dimensions: the dense simulator
carries (N, M) queues, one row per (load, error, seed) cell.  The random
order and the tie-breaking Gumbels come from the draw seam (`core.rng`).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import locality as loc


def claim_loop(q: torch.Tensor, serving_tier: torch.Tensor,
               perm: torch.Tensor, gumbels: torch.Tensor,
               score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               tier_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """Each idle server m, in the order `perm` (N, M), claims the random
    argmax over nonempty queues of ``score_fn(m, q)``.

    q, serving_tier (N, M) int32 (0 idle, else class 1..K); gumbels
    (N, M, M): row i breaks the ties of the i-th claim.  score_fn(m, q)
    -> (N, M) finite float scores for the (N, 1) servers m; empty queues
    are masked here, so a row has a task iff its best score is finite.
    tier_fn(m, n) -> the (N, 1) service class once m starts n's head
    task.  The class is stored, not the rate: the service step re-derives
    the rate each slot.  Returns (q, serving_tier).
    """
    # a fill, not torch.tensor: no blocking host-to-device copy in the loop
    minus_one = torch.full((), -1, dtype=q.dtype, device=q.device)
    for m, g in zip(perm[..., None].unbind(-2), gumbels.unbind(-2)):
        now = torch.gather(serving_tier, -1, m)
        score = torch.where(q > 0, score_fn(m, q), float("-inf"))
        best = score.amax(dim=-1, keepdim=True)
        # loc.random_argmax, keeping its row maximum for `take`
        n_star = torch.argmax(torch.where(score == best, g, float("-inf")),
                              dim=-1, keepdim=True)
        take = (now == 0) & (best > float("-inf"))
        q = q.scatter_add(-1, n_star, take * minus_one)
        serving_tier = serving_tier.scatter(
            -1, m, torch.where(take, tier_fn(m, n_star), now))
    return q, serving_tier


def pair_tier(m: torch.Tensor, n: torch.Tensor,
              ancestors: torch.Tensor) -> torch.Tensor:
    """(m,n)-relation service class 1..K: LOCAL if m == n, then one class
    per shared hierarchy level, REMOTE otherwise (the class analogue of
    `loc.pair_rate`)."""
    return (loc.pair_tiers(m, n, ancestors) + 1).to(torch.int32)


def pair_tier_table(ancestors: torch.Tensor) -> torch.Tensor:
    """(M, M) int32 `pair_tier` of every (server, queue) pair, so a claim
    looks its class up with one gather."""
    anc = loc.as_ancestors(ancestors)
    sid = torch.arange(anc.shape[1], device=anc.device)
    return pair_tier(sid[:, None], sid[None, :], anc)


def tier_rates(serving_tier: torch.Tensor, tmk: torch.Tensor) -> torch.Tensor:
    """(..., M) current true service rate per server: row m of the (M, K)
    true rates at the in-service class, 0 where idle."""
    k = tmk.shape[-1]
    idx = torch.clamp(serving_tier.long() - 1, 0, k - 1)
    rows = tmk.expand(serving_tier.shape + (k,))
    rate = torch.gather(rows, -1, idx[..., None])[..., 0]
    return torch.where(serving_tier > 0, rate, torch.zeros_like(rate))


def jsq_route_one(q: torch.Tensor, gumbel: torch.Tensor, task: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Join-the-shortest-queue among each task's 3 local servers (random
    tie-break by the (..., 3) `gumbel`)."""
    return _jsq_push(q, gumbel, task.long(), active.to(q.dtype))


def _jsq_push(q, gumbel, locs, inc):
    """`jsq_route_one` with int64 locals and a 0/1 increment in q's type
    (the queue lengths are small integers, so their f32 images order and
    tie exactly as they do)."""
    j = loc.random_argmin(gumbel, torch.gather(q, -1, locs))
    return q.scatter_add(-1, torch.gather(locs, -1, j[..., None]),
                         inc[..., None])


def telemetry_gauges(q: torch.Tensor, serving_tier: torch.Tensor):
    """Queued total and busy servers per cell, shared by the claim-based
    policies (waiting tasks have no tier until claim time)."""
    return {"queued": q.sum(dim=-1).to(torch.float32),
            "in_service": (serving_tier > 0).sum(dim=-1).to(torch.float32)}
