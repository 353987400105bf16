"""Fixed-shape replication lifecycle for the dense simulator's slot loop
(counterpart of `repro.replication.simproj`), batched over the N cells
of a sweep.

The machinery tracks an explicit chunk catalogue per cell — ``ids (N,
C+1, R)`` replica hosts plus a ``mask (N, C+1, R) bool`` liveness map,
materialized once from the placement policy — and evolves it every slot:

  wipe    -- replicas on dead servers (scenario ``alive`` track) vanish;
  commit  -- in-flight moves whose countdown hit zero land on their
             destination (moves with a dead endpoint are killed);
  drop    -- surplus replicas over the controller's target are released
             for free (rank-order within the row, keep the first
             ``target`` live copies);
  start   -- the largest-deficit chunks claim free migration lanes, a
             live source, and the least-loaded eligible destination; the
             move then occupies both endpoints for
             ``ceil(chunk_size / rate[pair_tier(src, dst)])`` slots
             (`MigrationModel`), multiplying their foreground TRUE rates
             by the contention factor while it runs.

Everything is fixed-shape and branch-free, with no read of a device
value: L migration lanes (the repair-bandwidth cap) are a static Python
loop over lanes, vectorised over cells; catalogue scatters go through a
scratch row (index C) so lanes that did not commit write nowhere (its
mask stays False); scatters where two lanes can hit one index reduce
(`scatter_add`, ``amax``).  Ties go to the first index everywhere, as
the reference's ``argmax``/``argmin`` take them.

Chunk reads come from the draw seam (`core.rng.DenseDraws.read`: (N, B)
ids, one per arrival lane, from the static Zipf(``read_skew``) law over
chunk ids), drawn from a generator of their own, so the foreground
arrival stream and every policy's draws keep the exact same numbers as a
run without replication, as the reference's dedicated key fold keeps its
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import locality as loc


class RepState(NamedTuple):
    """Lifecycle state of N cells, threaded through the slot loop's
    carry (fixed shapes)."""

    ids: torch.Tensor         # (N, C+1, R) int64 hosts (row C: scratch)
    mask: torch.Tensor        # (N, C+1, R) bool live replicas (row C: False)
    pop: torch.Tensor         # (N, C) f32 decayed read counts
    lane_chunk: torch.Tensor  # (N, L) int64 chunk in flight (C = idle)
    lane_slot: torch.Tensor   # (N, L) int64 catalogue column being filled
    lane_src: torch.Tensor    # (N, L) int64 source server
    lane_dst: torch.Tensor    # (N, L) int64 destination server
    lane_left: torch.Tensor   # (N, L) f32 slots remaining (0 = idle)
    ever_lost: torch.Tensor   # (N, C) bool chunk ever had zero live replicas
    moves: torch.Tensor       # (N,) i32 committed moves
    dropped: torch.Tensor     # (N,) i32 surplus replicas released
    lost_tasks: torch.Tensor  # (N,) i32 in-window arrivals for dead chunks
    busy_slots: torch.Tensor  # (N,) f32 server-slots occupied by migration
    max_conc: torch.Tensor    # (N,) i32 peak concurrent moves (<= L)
    avail_sum: torch.Tensor   # (N,) f32 window sum of availability
    repl_sum: torch.Tensor    # (N,) f32 window sum of mean replication
    win_cnt: torch.Tensor     # (N,) f32 measured slots


def _take(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, R) row c[n] of each cell's (N, C+1, R) table."""
    return x.gather(1, c[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


class SimReplication:
    """Lifecycle machinery for one controller on one topology, on one
    device; the cell count comes with `init`."""

    def __init__(self, ctrl, topo, tier_rates, placement, device=None):
        from repro_torch import resolve_device
        dev = self.device = resolve_device(device)
        self.ctrl = ctrl
        base = min(loc.NUM_REPLICAS, topo.num_servers)
        ids, mask = placement.placement_map(topo, ctrl.num_chunks, base,
                                            ctrl.catalogue_seed)
        r_max = max(ids.shape[1], ctrl.max_target(base))
        if r_max > ids.shape[1]:  # widen for controllers that over-replicate
            pad = r_max - ids.shape[1]
            ids = np.concatenate(
                [ids, np.repeat(ids[:, :1], pad, axis=1)], axis=1)
            mask = np.concatenate(
                [mask, np.zeros((mask.shape[0], pad), bool)], axis=1)
        self.C, self.R = ids.shape
        self.L = ctrl.lanes
        self.M = topo.num_servers
        # scratch row C: catalogue scatters from non-committing lanes land
        # here (the kernels' max-shape + guard-row idiom)
        self.ids0 = torch.as_tensor(
            np.concatenate([ids, np.zeros((1, self.R), np.int32)]),
            dtype=torch.int64, device=dev)
        self.mask0 = torch.as_tensor(
            np.concatenate([mask, np.zeros((1, self.R), bool)]), device=dev)
        self.base_tgt = torch.as_tensor(mask.sum(1).astype(np.int32),
                                        device=dev)
        self.ancestors = torch.as_tensor(np.array(topo.ancestors),
                                         device=dev)
        self.cost_table = torch.as_tensor(
            ctrl.migration.cost_table(tier_rates), device=dev)
        self.contention = ctrl.migration.contention
        self.decay = float(getattr(ctrl, "decay", 0.02))
        # static Zipf read popularity over chunk ids (0 = uniform): the
        # reference's logits, and the float64 CDF the draw seam inverts
        w = (np.arange(self.C, dtype=np.float64) + 1.0) ** -ctrl.read_skew
        self.read_logits = np.log(w / w.sum()).astype(np.float32)
        self.read_cdf = np.minimum(np.cumsum(w / w.sum()), 1.0)
        self.score_tie = torch.arange(self.C, dtype=torch.float32,
                                      device=dev)

    def init(self, n_cells: int) -> RepState:
        dev = self.device
        n, c, lanes = n_cells, self.C, self.L

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return RepState(
            ids=self.ids0.expand(n, -1, -1).clone(),
            mask=self.mask0.expand(n, -1, -1).clone(),
            pop=zeros(n, c, dtype=torch.float32),
            lane_chunk=torch.full((n, lanes), c, dtype=torch.int64,
                                  device=dev),
            lane_slot=zeros(n, lanes, dtype=torch.int64),
            lane_src=zeros(n, lanes, dtype=torch.int64),
            lane_dst=zeros(n, lanes, dtype=torch.int64),
            lane_left=zeros(n, lanes, dtype=torch.float32),
            ever_lost=zeros(n, c, dtype=torch.bool),
            moves=zeros(n), dropped=zeros(n), lost_tasks=zeros(n),
            busy_slots=zeros(n, dtype=torch.float32), max_conc=zeros(n),
            avail_sum=zeros(n, dtype=torch.float32),
            repl_sum=zeros(n, dtype=torch.float32),
            win_cnt=zeros(n, dtype=torch.float32))

    @torch.inference_mode()
    def step(self, st: RepState, alive: torch.Tensor, read_ids: torch.Tensor,
             active: torch.Tensor, in_window: bool):
        """One slot of lifecycle for every cell; returns ``(state,
        fg_mult)`` where ``fg_mult (N, M)`` multiplies the foreground
        TRUE rates (0 for dead servers, ``contention`` for busy migration
        endpoints).  `alive` (M,) is the slot's liveness track (shared by
        the cells), `read_ids` (N, B) the chunk each arrival lane reads,
        `active` (N, B) which lanes arrived, `in_window` a Python bool."""
        i32, f32 = torch.int32, torch.float32
        C, R, L, M = self.C, self.R, self.L, self.M
        n = st.ids.shape[0]
        alive_b = alive > 0.5
        ids, mask = st.ids, st.mask

        # wipe: replicas on dead servers are gone (and stay gone until a
        # repair move recreates them — recovery restores the server, empty)
        mask = mask & alive_b[ids]

        # lanes: kill moves with a dead endpoint, then advance survivors
        live_lane = (st.lane_left > 0.0) \
            & alive_b[st.lane_src] & alive_b[st.lane_dst]
        live_i = live_lane.to(i32)
        n_act = live_i.sum(dim=-1, dtype=i32)
        busy = torch.zeros((n, M), dtype=i32, device=ids.device) \
            .scatter_reduce(-1, st.lane_src, live_i, "amax") \
            .scatter_reduce(-1, st.lane_dst, live_i, "amax") > 0
        left = torch.where(live_lane, st.lane_left - 1.0, 0.0)
        commit = live_lane & (left <= 0.0)
        # catalogue writes of the lanes, flat (N, (C+1)*R), as sums: a
        # lane that does not commit adds 0 to its scratch-row entry, and
        # committing lanes fill distinct (chunk, slot) entries (`taken`)
        wc = torch.where(commit, st.lane_chunk, C)
        at = wc * R + st.lane_slot
        ids_f = ids.reshape(n, -1)
        ids = ids_f.scatter_add(-1, at, torch.where(
            commit, st.lane_dst - ids_f.gather(-1, at), 0)).view_as(ids)
        mask = mask | (torch.zeros_like(ids_f, dtype=i32).scatter_add(
            -1, at, commit.to(i32)) > 0).view_as(mask)

        # reads: skewed chunk popularity from the draw seam's read ids
        # (the foreground arrival/routing streams keep their numbers)
        act_f = active.to(f32)
        reads = torch.zeros((n, C), dtype=f32, device=ids.device) \
            .scatter_add(-1, read_ids, act_f)
        # float32, two roundings, as the reference's compiled step rounds
        # it (XLA fuses the same update compiled alone; see
        # tools/xla_quantile_ulp.py)
        pop = (1.0 - self.decay) * st.pop + reads
        live = mask[:, :C].sum(dim=-1, dtype=i32)
        lost_now = (active & (live.gather(-1, read_ids) == 0)).sum(
            dim=-1, dtype=i32)

        # targets and free drops (keep the first `tgt` live replicas)
        tgt = torch.clamp(self.ctrl.sim_targets(pop, live, self.base_tgt),
                          1, R).to(i32)
        tgt_ext = torch.cat([tgt, torch.full((n, 1), R, dtype=i32,
                                             device=ids.device)], dim=-1)
        rank = torch.cumsum(mask.to(i32), dim=-1)
        keep = mask & (rank <= tgt_ext[..., None])
        n_dropped = mask[:, :C].sum(dim=(1, 2), dtype=i32) \
            - keep[:, :C].sum(dim=(1, 2), dtype=i32)
        mask = keep
        live = mask[:, :C].sum(dim=-1, dtype=i32)

        # deficit-driven move starts: largest deficit first (ties toward
        # the smaller chunk id), budgeted per slot, one destination slot
        # per in-flight move, bandwidth-capped by the L lanes themselves
        flying = (left > 0.0).to(i32)
        infl = torch.zeros((n, C + 1), dtype=i32, device=ids.device) \
            .scatter_add(-1, st.lane_chunk, flying)
        deficit = torch.clamp(tgt - live - infl[:, :C], 0, R)
        deficit = torch.where(live > 0, deficit, 0)  # need a live source
        held = torch.zeros((n, M), dtype=f32, device=ids.device).scatter_add(
            -1, ids[:, :C].reshape(n, -1), mask[:, :C].reshape(n, -1).to(f32))
        taken = mask.to(i32).reshape(n, -1).scatter_reduce(
            -1, st.lane_chunk * R + st.lane_slot, flying, "amax"
        ).view(n, C + 1, R)
        lane_chunk, lane_slot = st.lane_chunk.clone(), st.lane_slot.clone()
        lane_src, lane_dst = st.lane_src.clone(), st.lane_dst.clone()
        started = torch.zeros((n,), dtype=i32, device=ids.device)
        for i in range(L):  # static loop: L is the bandwidth cap
            can = deficit > 0
            score = deficit.to(f32) * (C + 1.0) - self.score_tie
            c = torch.argmax(torch.where(can, score, float("-inf")), dim=-1)
            row_ids, row_mask = _take(ids, c), _take(mask, c)
            slot = torch.argmin(_take(taken, c), dim=-1)
            src = row_ids.gather(-1, torch.argmax(row_mask.to(i32), dim=-1,
                                                  keepdim=True))[:, 0]
            holders = torch.zeros((n, M), dtype=i32, device=ids.device) \
                .scatter_add(-1, row_ids, row_mask.to(i32))
            pending = torch.zeros((n, M), dtype=i32, device=ids.device) \
                .scatter_add(-1, lane_dst, ((left > 0.0)
                                            & (lane_chunk == c[:, None])
                                            ).to(i32))
            eligible = alive_b & (holders == 0) & (pending == 0)
            dst = torch.argmin(torch.where(eligible, held, float("inf")),
                               dim=-1)
            ok = (left[:, i] <= 0.0) & can.any(dim=-1) \
                & eligible.any(dim=-1) \
                & (started < self.ctrl.moves_per_slot)
            cost = self.cost_table[loc.pair_tiers(src, dst, self.ancestors)]
            lane_chunk[:, i] = torch.where(ok, c, lane_chunk[:, i])
            lane_slot[:, i] = torch.where(ok, slot, lane_slot[:, i])
            lane_src[:, i] = torch.where(ok, src, lane_src[:, i])
            lane_dst[:, i] = torch.where(ok, dst, lane_dst[:, i])
            left[:, i] = torch.where(ok, cost, left[:, i])
            ok_i = ok.to(i32)[:, None]
            deficit = deficit.scatter_add(-1, c[:, None], -ok_i)
            held = held.scatter_add(-1, dst[:, None], ok_i.to(f32))
            taken = taken.view(n, -1).scatter_reduce(
                -1, (c * R + slot)[:, None], ok_i, "amax").view_as(taken)
            started = started + ok_i[:, 0]

        in_w = float(in_window)
        new_st = RepState(
            ids=ids, mask=mask, pop=pop,
            lane_chunk=lane_chunk, lane_slot=lane_slot,
            lane_src=lane_src, lane_dst=lane_dst, lane_left=left,
            ever_lost=st.ever_lost | (live == 0),
            moves=st.moves + commit.sum(dim=-1, dtype=i32),
            dropped=st.dropped + n_dropped,
            lost_tasks=st.lost_tasks + lost_now * int(in_window),
            busy_slots=st.busy_slots + 2.0 * n_act.to(f32),
            max_conc=torch.maximum(st.max_conc, n_act),
            avail_sum=st.avail_sum + in_w * _mean(live > 0),
            repl_sum=st.repl_sum + in_w * _mean(live),
            win_cnt=st.win_cnt + in_w)
        fg_mult = alive * torch.where(busy, self.contention, 1.0)
        return new_st, fg_mult

    def metrics(self, st: RepState):
        """Availability / data-loss / migration metrics, (N,) float32 each
        (merged into the simulator's output dict in machinery mode)."""
        f32 = torch.float32
        win = torch.clamp(st.win_cnt, min=1.0)
        live = st.mask[:, :self.C].sum(dim=-1, dtype=torch.int32)
        return {
            "availability": st.avail_sum / win,
            "data_loss_frac": _mean(st.ever_lost),
            "mean_replication": st.repl_sum / win,
            "final_replication": _mean(live),
            "repair_moves": st.moves.to(f32),
            "dropped_replicas": st.dropped.to(f32),
            "lost_tasks": st.lost_tasks.to(f32),
            "migration_busy_slots": st.busy_slots,
            "max_concurrent_moves": st.max_conc.to(f32),
        }


def _mean(x: torch.Tensor) -> torch.Tensor:
    """(N,) float32 mean of the integer (or bool) rows of x (N, C): the
    exact integer sum over C, divided (rounded once), as the reference's
    float32 mean of these values rounds."""
    return x.sum(dim=-1, dtype=torch.int32).to(torch.float32) / x.shape[-1]
