"""FIFO — Hadoop's default scheduler, port of `repro.core.fifo`.

A single global FIFO queue of task types per cell, a ring buffer of
``cap`` entries; arrivals beyond it are dropped and counted.  An idle
server takes the head task whatever its locality, and serves it at the
true rate of the task's tier to that server.  FIFO consults neither
queues nor rates.

The reference pushes the lanes and pops the idle servers one by one.
Neither loop reads what an earlier iteration wrote except through the
counters, so both are written here in closed form with prefix sums: lane
b fits iff ``count + (active lanes before b) < cap``, and the j-th idle
server in permutation order takes the task at ``head + j`` iff
``j < count``.  The result is the reference's state, entry for entry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import claiming, locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DenseDraws, DrawPlan


class FifoState(NamedTuple):
    buf: torch.Tensor           # (N, cap, 3) int32 ring buffer of task types
    head: torch.Tensor          # (N,) int32 index of the oldest task
    count: torch.Tensor         # (N,) int32 number queued
    serving_tier: torch.Tensor  # (N, M) int32 class in service; 0 idle
    drops: torch.Tensor         # (N,) int32 arrivals dropped (buffer full)


def init_state(topo: loc.Topology, cap: int = 32768, device=None,
               batch=()) -> FifoState:
    lead = tuple(batch)
    i32 = dict(dtype=torch.int32, device=device)
    return FifoState(buf=torch.zeros(lead + (cap, 3), **i32),
                     head=torch.zeros(lead, **i32),
                     count=torch.zeros(lead, **i32),
                     serving_tier=torch.zeros(lead + (topo.num_servers,),
                                              **i32),
                     drops=torch.zeros(lead, **i32))


def num_in_system(s: FifoState) -> torch.Tensor:
    return s.count + (s.serving_tier > 0).sum(dim=-1).to(torch.int32)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32)
    return (torch.cumsum(x, dim=-1) - x).to(torch.int32)


def slot_step(s: FifoState, draws: DenseDraws, types: torch.Tensor,
              active: torch.Tensor, est: torch.Tensor,
              true_rates: torch.Tensor, ancestors: torch.Tensor):
    del est  # FIFO consults nothing
    cap = s.buf.shape[-2]
    head, count = s.head[..., None], s.count[..., None]

    # 1. push the arrivals in lane order, dropping when full.  Lanes that
    #    do not fit rewrite the entry they would hit: never a fitted
    #    lane's slot, so the scatter has no conflicting writes.
    before = _exclusive_cumsum(active)
    fits = active & (count + before < cap)
    pos = ((head + count + before) % cap).long()[..., None].expand(
        types.shape)
    old = torch.gather(s.buf, -2, pos)
    buf = s.buf.scatter(-2, pos, torch.where(fits[..., None], types, old))
    count = count + fits.sum(dim=-1, keepdim=True).to(torch.int32)
    drops = s.drops + (active & ~fits).sum(dim=-1).to(torch.int32)

    # 2. completions at the true rate of the stored class
    tmk = loc.per_server_rates(true_rates, s.serving_tier.shape[-1])
    done = draws.u_serve < claiming.tier_rates(s.serving_tier, tmk)
    completions = done.sum(dim=-1).to(torch.int32)
    serving_tier = torch.where(done, torch.zeros_like(s.serving_tier),
                               s.serving_tier)

    # 3. idle servers pop heads in the permutation's order
    order = draws.perm
    now = torch.gather(serving_tier, -1, order)
    idle = now == 0
    rank = _exclusive_cumsum(idle)
    take = idle & (rank < count)
    at = ((head + rank) % cap).long()[..., None].expand(order.shape + (3,))
    task = torch.gather(buf, -2, at)                         # (N, M, 3)
    cls = loc.class_of(task, ancestors, order)
    serving_tier = serving_tier.scatter(-1, order,
                                        torch.where(take, cls, now))
    taken = take.sum(dim=-1).to(torch.int32)
    return FifoState(buf, (s.head + taken) % cap, count[..., 0] - taken,
                     serving_tier, drops), completions


@register_policy
class FifoPolicy(SlotPolicy):
    """Global-FIFO: one shared rate-oblivious queue, idle servers pull in
    arrival order (the Hadoop-default floor every comparison stands on).
    `cap` is the ring buffer's bound; the drop counter surfaces through
    `extra_metrics`.
    """

    name = "fifo"

    def __init__(self, cap: int = 32_768):
        self.cap = cap

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return DrawPlan(perm=True)

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> FifoState:
        return init_state(topo, self.cap, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors):
        return slot_step(s, draws, types, active, est, true_rates, ancestors)

    def num_in_system(self, s: FifoState) -> torch.Tensor:
        return num_in_system(s)

    def extra_metrics(self, s: FifoState):
        return {"drops": s.drops.to(torch.float32)}

    def telemetry_gauges(self, s: FifoState):
        # one global queue: its depth plus busy servers (tiers resolve
        # only when an idle server pulls the head task)
        return {"queued": s.count.to(torch.float32),
                "in_service": (s.serving_tier > 0).sum(dim=-1)
                .to(torch.float32)}
