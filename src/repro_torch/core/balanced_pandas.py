"""Balanced-PANDAS (paper §3.2), port of `repro.core.balanced_pandas`.

Queueing structure: K queues per server, one per locality tier, stored
as one (M, K) int32 matrix ``q``.  Workload

    W_m = sum_k  q[m, k] / rates[m, k]   (+ the in-service residual).

Routing sends an arrival to argmin_m W_m / rate(m, tier); scheduling lets
an idle server serve its fastest-tier nonempty queue.  The scheduler
decides with estimated rates ``est`` (M, K); service uses the true rates.

Every function takes the state with optional leading batch dimensions:
(M, K) on the fleet path, (N, M, K) on the dense path, one row per
(load, error, seed) cell.  Random draws come in from the draw seam
(`core.rng`): uniforms, so a Bernoulli with probability p is ``u < p`` —
how `jax.random.bernoulli` is built — and Gumbels for the random
tie-breaks, which lets the tests replay the reference's draws exactly.
The dense `slot_step` routes the slot's arrival lanes one after another
(each sees the workloads the earlier lanes left), as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import claiming, locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DenseDraws, DrawPlan


class PandasState(NamedTuple):
    q: torch.Tensor        # (..., M, K) int32 waiting tasks per (server, tier)
    serving: torch.Tensor  # (..., M) int32 class in service (0 idle, 1..K)


def init_state(topo: loc.Topology, device=None, batch=()) -> PandasState:
    """Empty state; `batch` is the shape of the leading cell dimensions."""
    m, k = topo.num_servers, topo.num_tiers
    lead = tuple(batch)
    return PandasState(torch.zeros(lead + (m, k), dtype=torch.int32,
                                   device=device),
                       torch.zeros(lead + (m,), dtype=torch.int32,
                                   device=device))


def num_in_system(s: PandasState) -> torch.Tensor:
    return s.q.sum(dim=(-2, -1)) + (s.serving > 0).sum(dim=-1)


def telemetry_gauges(s: PandasState):
    """Per-tier queued counts and busy servers per cell, (N,) float32 each
    — shared by every policy on the PANDAS (M, K) queue structure."""
    out = {f"queued_tier{t}": s.q[..., t].sum(dim=-1).to(torch.float32)
           for t in range(s.q.shape[-1])}
    out["in_service"] = (s.serving > 0).sum(dim=-1).to(torch.float32)
    return out


def workload(s: PandasState, est: torch.Tensor) -> torch.Tensor:
    """(..., M) estimated weighted workload W_m (waiting + in-service
    share).

    The tier sum is accumulated left to right in float32 and the
    in-service task adds its expected residual 1/rate at the class it is
    served at, bit for bit as the reference computes it.
    """
    return _queued_work(s.q, est) + _in_service_work(s.serving, est)


def _queued_work(q: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """sum_k q[..., k] / est[..., k], left to right in float32."""
    parts = q / est
    w = parts[..., 0]
    for t in range(1, q.shape[-1]):
        w = w + parts[..., t]
    return w


def _in_service_work(serving: torch.Tensor, est: torch.Tensor):
    """1/est at the in-service class, 0 where idle."""
    k = est.shape[-1]
    idx = torch.clamp(serving.long() - 1, 0, k - 1)
    resid_rate = torch.gather(est, -1, idx[..., None])[..., 0]
    return torch.where(serving > 0, 1.0 / resid_rate,
                       torch.zeros_like(resid_rate))


def push_task(s: PandasState, m_star: torch.Tensor, tier_m: torch.Tensor,
              active: torch.Tensor) -> PandasState:
    """Enqueue one (possibly inactive) arrival per cell at server
    `m_star` (...,), whose tier for the task is ``tier_m[..., m_star]``."""
    m_star = m_star.long()[..., None]
    tier = torch.gather(tier_m, -1, m_star)
    flat = m_star * s.q.shape[-1] + tier
    q = s.q.flatten(-2).scatter_add(-1, flat, active[..., None].to(s.q.dtype))
    return PandasState(q=q.view(s.q.shape), serving=s.serving)


def _route_min(s: PandasState, gumbel, cell, est_rate, pref, inc, est,
               resid, candidates=None, breach=None,
               drain_bias: float = 0.0) -> PandasState:
    """Push one lane to the random argmin of W / rate - rate * 1e-6 (the
    faster tier wins an exact tie; then the Gumbels), over `candidates`
    when given.  `cell` (..., M) is the flat (server, tier) index of the
    task at each server, `inc` the lane's 0/1 increment; `pref` is
    ``est_rate * 1e-6`` and `resid` the in-service share of W, all fixed
    while a slot's lanes are routed.  Where `breach` (..., 1) is set
    (SLO-PANDAS), the score gains ``drain_bias * W`` after it is formed,
    in the reference's order of float operations."""
    w = _queued_work(s.q, est) + resid
    score = w / est_rate - pref
    if breach is not None:
        score = torch.where(breach, score + drain_bias * w, score)
    if candidates is not None:
        score = torch.where(candidates, score, float("inf"))
    m_star = loc.random_argmin(gumbel, score)
    at = torch.gather(cell, -1, m_star[..., None])
    q = s.q.flatten(-2).scatter_add(-1, at, inc[..., None])
    return PandasState(q=q.view(s.q.shape), serving=s.serving)


def lane_rates(types: torch.Tensor, est: torch.Tensor, ancestors):
    """Per-lane routing constants, each (..., B, M): the tier of every
    server, the flat (server, tier) index into q, the estimated rate at
    that tier and ``rate * 1e-6``.  They depend only on the slot's task
    types, not on the queues."""
    tier_m = loc.server_tiers(types, ancestors)
    k = est.shape[-1]
    sid = torch.arange(tier_m.shape[-1], device=tier_m.device)
    cell = sid * k + tier_m.long()
    est_rate = torch.gather(est[..., None, :, :].expand(
        tier_m.shape + (k,)), -1, tier_m.long()[..., None])[..., 0]
    return cell, est_rate, est_rate * 1e-6


def route_one(s: PandasState, gumbel: torch.Tensor, task: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              ancestors: torch.Tensor, candidates=None) -> PandasState:
    """Route one arrival per cell against the live workloads (estimated
    rates), over the (..., M) `candidates` when given.  Tie-break: among
    minimal scores prefer the faster tier (the -rate*1e-6 term), then the
    largest of the (..., M) `gumbel`."""
    cell, est_rate, pref = lane_rates(task[..., None, :], est, ancestors)
    return _route_min(s, gumbel, cell[..., 0, :], est_rate[..., 0, :],
                      pref[..., 0, :], active.to(s.q.dtype), est,
                      _in_service_work(s.serving, est), candidates)


def service_completions(s: PandasState, u_serve: torch.Tensor,
                        true_rates: torch.Tensor):
    """Bernoulli service completions at the *true* rates: ``u_serve < p``
    for the (M,) uniforms of this slot.  `true_rates` is the shared (K,)
    vector or an (M, K) matrix.  Returns (done (M,) bool, completions)."""
    tmk = loc.per_server_rates(true_rates, s.serving.shape[-1])
    done = u_serve < claiming.tier_rates(s.serving, tmk)
    return done, done.sum(dim=-1).to(torch.int32)


def schedule_idle(s: PandasState, done: torch.Tensor,
                  breach=None) -> PandasState:
    """Idle servers (post-completion) pick their fastest nonempty tier
    queue (local > rack-local > ... > remote, conflict-free); in a cell
    whose (..., 1) `breach` is set (SLO-PANDAS), their LONGEST queue
    (the first of equals) instead."""
    k = s.q.shape[-1]
    serving = torch.where(done, torch.zeros_like(s.serving), s.serving)
    nonempty = s.q > 0                                   # (..., M, K)
    first = torch.argmax(nonempty.to(torch.int32), dim=-1)  # first max wins
    if breach is not None:
        first = torch.where(breach, torch.argmax(s.q, dim=-1), first)
    has_task = nonempty.any(dim=-1)
    take = (serving == 0) & has_task
    tiers = torch.arange(k, device=s.q.device)
    dec = take[..., None] & (tiers == first[..., None])
    return PandasState(
        q=s.q - dec.to(torch.int32),
        serving=torch.where(take, (first + 1).to(torch.int32), serving),
    )


def serve_and_schedule(s: PandasState, u_serve: torch.Tensor,
                       true_rates: torch.Tensor, breach=None):
    """Service completions (true rates) + idle-server scheduling (under
    `breach`, see `schedule_idle`).  Returns (state, completions)."""
    done, completions = service_completions(s, u_serve, true_rates)
    return schedule_idle(s, done, breach), completions


def route_lanes(s: PandasState, draws: DenseDraws, types: torch.Tensor,
                active: torch.Tensor, est: torch.Tensor,
                ancestors: torch.Tensor, breach=None,
                drain_bias: float = 0.0, server_mask=None) -> PandasState:
    """The slot's B arrival lanes for N cells, routed one after another
    (each sees the workloads the earlier lanes left).

    types (N, B, 3), active (N, B), est (N, M, K) estimated rates; the
    draws' route Gumbels are (N, B, M); `breach` (N, 1) and `drain_bias`
    as `_route_min` takes them; `server_mask` (N, M) bool, the
    autoscaling seam, is the candidate set of every lane (descaled
    servers score +inf and take no new work; their queues keep draining
    through the service phase)."""
    cell, est_rate, pref = lane_rates(types, est, ancestors)
    resid = _in_service_work(s.serving, est)
    lanes = zip(draws.route.unbind(-2), cell.unbind(-2), est_rate.unbind(-2),
                pref.unbind(-2), active.to(s.q.dtype).unbind(-1))
    for gumbel, cell_i, rate_i, pref_i, inc in lanes:
        s = _route_min(s, gumbel, cell_i, rate_i, pref_i, inc, est, resid,
                       candidates=server_mask, breach=breach,
                       drain_bias=drain_bias)
    return s


def slot_step(s: PandasState, draws: DenseDraws, types: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              true_rates: torch.Tensor, ancestors: torch.Tensor,
              server_mask=None):
    """One dense slot for N cells: the arrival lanes (`route_lanes`, over
    the (N, M) `server_mask` when given), then service completions and
    scheduling.  ``server_mask=None`` is the step without the autoscaling
    seam.  Returns (state, completions (N,))."""
    s = route_lanes(s, draws, types, active, est, ancestors,
                    server_mask=server_mask)
    return serve_and_schedule(s, draws.u_serve, true_rates)


@register_policy
class BalancedPandasPolicy(SlotPolicy):
    """Balanced-PANDAS: weighted-workload routing over estimated per-tier
    rates — the paper's headline throughput- and heavy-traffic-optimal
    policy."""

    name = "balanced_pandas"
    supports_server_mask = True

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return DrawPlan(route="servers")

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> PandasState:
        return init_state(topo, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors,
                  server_mask=None):
        return slot_step(s, draws, types, active, est, true_rates, ancestors,
                         server_mask=server_mask)

    def num_in_system(self, s: PandasState) -> torch.Tensor:
        return num_in_system(s)

    def telemetry_gauges(self, s: PandasState):
        return telemetry_gauges(s)
