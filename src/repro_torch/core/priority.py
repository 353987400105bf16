"""Priority algorithm (paper §3.1), port of `repro.core.priority`.

Designed for two locality levels and run on the rack system as the paper
does.  One queue per server holding local tasks; JSQ routing among the
arrival's 3 local queues.  An idle server serves its own queue if it is
nonempty, otherwise the longest queue in the system (unweighted: the
algorithm never consults the rates, so it is the rate-oblivious control
arm of the robustness study).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import claiming, locality as loc
from repro_torch.core import jsq_maxweight as jsq
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DenseDraws, DrawPlan


class PriorityState(NamedTuple):
    q: torch.Tensor             # (N, M) int32
    serving_tier: torch.Tensor  # (N, M) int32 (m,n)-class in service; 0 idle


def init_state(topo: loc.Topology, device=None, batch=()) -> PriorityState:
    return PriorityState(*jsq.init_state(topo, device, batch))


def num_in_system(s: PriorityState) -> torch.Tensor:
    return jsq.num_in_system(s)


def slot_step(s: PriorityState, draws: DenseDraws, types: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              true_rates: torch.Tensor, ancestors: torch.Tensor):
    del est  # the Priority algorithm never consults service rates
    anc = loc.as_ancestors(ancestors)
    q, serving_tier, completions = jsq.route_and_serve(
        s.q, s.serving_tier, draws, types, active, true_rates)
    sid = torch.arange(q.shape[-1], device=q.device)
    cls = claiming.pair_tier_table(anc)

    def score_fn(m, qv):
        # own nonempty queue wins outright; otherwise the longest queue
        # (the reference also tests qv > 0 here; the claim loop masks empty
        # queues to -inf after this, so that test changes no score)
        return torch.where(sid == m, 1e9, qv.to(torch.float32))

    def tier_fn(m, n):
        return cls[m, n]

    q, serving_tier = claiming.claim_loop(q, serving_tier, draws.perm,
                                          draws.claim, score_fn, tier_fn)
    return PriorityState(q, serving_tier), completions


@register_policy
class PriorityPolicy(SlotPolicy):
    """Priority: serve local tasks first, then rack-local, then remote —
    rate-oblivious 2-level design with a smaller capacity region than
    Balanced-PANDAS (its delay inside that region can still be excellent;
    see EXPERIMENTS.md §Reproduction).  An idle server with no local task
    helps the longest queue.
    """

    name = "priority"

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return jsq.CLAIM_PLAN

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> PriorityState:
        return init_state(topo, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors):
        return slot_step(s, draws, types, active, est, true_rates, ancestors)

    def num_in_system(self, s: PriorityState) -> torch.Tensor:
        return num_in_system(s)

    def telemetry_gauges(self, s: PriorityState):
        return claiming.telemetry_gauges(s.q, s.serving_tier)
