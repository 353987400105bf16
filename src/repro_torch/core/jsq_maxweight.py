"""JSQ-MaxWeight (paper §3.3), port of `repro.core.jsq_maxweight`.

One queue per server, holding tasks local to that server.  Routing: JSQ
among the arrival's 3 local queues.  Scheduling: an idle server m serves
the head task of

    argmax_n  rate(m, n) * Q_n(t)

where ``rate(m, n)`` is m's *estimated* rate at the (m, n) pair tier.
The realized service rate uses the true rates via the same (m, n) class.
State rows carry a leading cell dimension N (dense simulator).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import claiming, locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DenseDraws, DrawPlan

CLAIM_PLAN = DrawPlan(route="locals", perm=True, claim=True)


class JsqMwState(NamedTuple):
    q: torch.Tensor             # (N, M) int32 waiting tasks, local to each
    serving_tier: torch.Tensor  # (N, M) int32 (m,n)-class in service; 0 idle


def init_state(topo: loc.Topology, device=None, batch=()) -> JsqMwState:
    shape = tuple(batch) + (topo.num_servers,)
    return JsqMwState(torch.zeros(shape, dtype=torch.int32, device=device),
                      torch.zeros(shape, dtype=torch.int32, device=device))


def num_in_system(s) -> torch.Tensor:
    return s.q.sum(dim=-1) + (s.serving_tier > 0).sum(dim=-1)


def route_and_serve(q, serving_tier, draws: DenseDraws, types, active,
                    true_rates):
    """The phases JSQ-MaxWeight and Priority share: JSQ routing of the
    lanes in order, then service completions at the true rates of the
    stored class.  Returns (q, serving_tier after completions,
    completions (N,))."""
    lanes = zip(draws.route.unbind(-2), types.long().unbind(-2),
                active.to(q.dtype).unbind(-1))
    for gumbel, locs, inc in lanes:
        q = claiming._jsq_push(q, gumbel, locs, inc)
    tmk = loc.per_server_rates(true_rates, q.shape[-1])
    done = draws.u_serve < claiming.tier_rates(serving_tier, tmk)
    serving_tier = torch.where(done, torch.zeros_like(serving_tier),
                               serving_tier)
    return q, serving_tier, done.sum(dim=-1).to(torch.int32)


def slot_step(s: JsqMwState, draws: DenseDraws, types: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              true_rates: torch.Tensor, ancestors: torch.Tensor):
    """est (N, M, K): server m weighs queue n with its own estimate at the
    (m, n) pair tier.  Returns (state, completions (N,))."""
    anc = loc.as_ancestors(ancestors)
    q, serving_tier, completions = route_and_serve(
        s.q, s.serving_tier, draws, types, active, true_rates)
    cls = claiming.pair_tier_table(anc)
    # weight[c, m, n] = est[c, m, pair_tier(m, n)]: one gather per slot
    idx = (cls.long() - 1).expand(est.shape[:-1] + cls.shape[-1:])
    weight = torch.gather(est, -1, idx)
    rows = torch.arange(q.shape[0], device=q.device)

    def score_fn(m, qv):  # f32 weight times the int queue, in f32
        return weight[rows, m[..., 0]] * qv

    def tier_fn(m, n):
        return cls[m, n]

    q, serving_tier = claiming.claim_loop(q, serving_tier, draws.perm,
                                          draws.claim, score_fn, tier_fn)
    return JsqMwState(q, serving_tier), completions


@register_policy
class JsqMaxWeightPolicy(SlotPolicy):
    """JSQ-MaxWeight: join-shortest-queue routing + MaxWeight service over
    the (m, n) pair rates — throughput-optimal but NOT heavy-traffic
    delay-optimal, and the policy the paper shows degrades most under
    rate mis-estimation and drift.
    """

    name = "jsq_maxweight"

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return CLAIM_PLAN

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> JsqMwState:
        return init_state(topo, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors):
        return slot_step(s, draws, types, active, est, true_rates, ancestors)

    def num_in_system(self, s: JsqMwState) -> torch.Tensor:
        return num_in_system(s)

    def telemetry_gauges(self, s: JsqMwState):
        return claiming.telemetry_gauges(s.q, s.serving_tier)
