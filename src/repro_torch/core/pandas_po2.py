"""Power-of-d-choices Balanced-PANDAS (``pandas_po2``), port of
`repro.core.pandas_po2` (the dense arm).

Instead of scanning all M servers per arrival, the router compares the
weighted-workload scores only over the task's 3 local servers plus ``d``
servers sampled uniformly without replacement.  Queueing structure,
service and idle-server scheduling are exactly Balanced-PANDAS'.  The
candidates come from the draw seam (`core.rng`).  The fleet arm is
`sharding.sim._route_batch_po2` (d uniform candidates a task, with
replacement, argmin in one snapshot round).
"""

from __future__ import annotations

import torch

from repro_torch.core import balanced_pandas as bp
from repro_torch.core import locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DenseDraws, DrawPlan


def candidate_mask(types: torch.Tensor, sampled: torch.Tensor,
                   num_servers: int):
    """(..., M) bool: the task's 3 locals and its sampled servers."""
    picked = torch.zeros(types.shape[:-1] + (num_servers,), dtype=torch.bool,
                         device=types.device)
    picked = picked.scatter(-1, types.long(), True)
    return picked.scatter(-1, sampled.long(), True)


def route_one_po_d(s: bp.PandasState, gumbel: torch.Tensor,
                   sampled: torch.Tensor, task: torch.Tensor,
                   active: torch.Tensor, est: torch.Tensor,
                   ancestors: torch.Tensor) -> bp.PandasState:
    """Route one arrival per cell over {3 locals} and its (..., d)
    `sampled` servers: `bp.route_one`'s score restricted to those
    candidates (the rest score +inf), ties broken by the (..., M)
    `gumbel`.  `sampled` and `gumbel` are the reference's
    ``choice(k_cand, M, (d,), replace=False)`` and ``gumbel(k_tie,
    (M,))``."""
    return bp.route_one(s, gumbel, task, active, est, ancestors,
                        candidate_mask(task, sampled, est.shape[-2]))


def slot_step(s: bp.PandasState, draws: DenseDraws, types: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              true_rates: torch.Tensor, ancestors: torch.Tensor):
    """One slot: po-d routing of the lanes in order (each over its locals
    and its (N, B, d) sampled candidates), then the PANDAS service and
    scheduling.  Returns (state, completions (N,))."""
    cell, est_rate, pref = bp.lane_rates(types, est, ancestors)
    resid = bp._in_service_work(s.serving, est)
    cand = candidate_mask(types, draws.cand, est.shape[-2])
    lanes = zip(draws.route.unbind(-2), cell.unbind(-2), est_rate.unbind(-2),
                pref.unbind(-2), active.to(s.q.dtype).unbind(-1),
                cand.unbind(-2))
    for gumbel, cell_i, rate_i, pref_i, inc, cand_i in lanes:
        s = bp._route_min(s, gumbel, cell_i, rate_i, pref_i, inc, est, resid,
                          candidates=cand_i)
    return bp.serve_and_schedule(s, draws.u_serve, true_rates)


@register_policy
class PandasPoDPolicy(SlotPolicy):
    """Power-of-d Balanced-PANDAS: score only the task's 3 locals plus d
    sampled candidates instead of all M servers — O(d) routing that
    trades a little exact-rate delay for a narrower error band.
    ``d`` (default 2) is a ``PolicyConfig("pandas_po2", {"d": ...})``
    option."""

    name = "pandas_po2"

    def __init__(self, d: int = 2):
        if d < 1:
            raise ValueError(f"need d >= 1 candidate samples, got {d}")
        self.d = d

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return DrawPlan(route="servers", cand=min(self.d, num_servers))

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> bp.PandasState:
        return bp.init_state(topo, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors):
        return slot_step(s, draws, types, active, est, true_rates, ancestors)

    def num_in_system(self, s: bp.PandasState) -> torch.Tensor:
        return bp.num_in_system(s)

    def telemetry_gauges(self, s: bp.PandasState):
        return bp.telemetry_gauges(s)
