"""Host-side replication lifecycle for the serving engine (counterpart
of `repro.replication.host`, a numpy copy).

The numpy mirror of `repro_torch.replication.simproj`: the same chunk
catalogue (padded ids + liveness mask from the placement policy), the
same wipe / commit / drop / start sequence, but on the hosts' continuous
clock — a move started at time ``t`` between endpoints at pair-tier
``k`` commits at ``t + ceil(chunk_size / rate[k])`` (`MigrationModel`),
and until then both endpoints serve foreground work at the contention
multiplier.  Consumers call `observe(t, alive_mask)` once per step with
the scenario playback's liveness mask, then read placements through
`replicas_for` instead of the static `PlacementPolicy.replicas`.

State round-trips through `state_dict()` / `load_state_dict()` as plain
JSON types, as the placement popularity state does.

With an `EventRecorder` installed as `tracer` (the engine installs its
own), `observe` emits ``server_down``/``server_up`` (cat ``failure``,
tid the server) and ``repair_start``/``repair_commit`` (cat
``replication``, tid the destination) instants on the ``CLOCK_UNIT_US``
clock, the reference's events exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np

from repro_torch.core.cluster import tier_of
from repro_torch.telemetry import CLOCK_UNIT_US


class HostReplication:
    """Replication lifecycle on the host fleet (serving engine)."""

    def __init__(self, ctrl, spec, placement, num_chunks: int,
                 replication: int, seed: int, tier_rates):
        base = min(int(replication), spec.num_workers)
        ids, mask = placement.placement_map(spec, num_chunks, base, seed)
        r_max = max(ids.shape[1], ctrl.max_target(base))
        if r_max > ids.shape[1]:
            pad = r_max - ids.shape[1]
            ids = np.concatenate(
                [ids, np.repeat(ids[:, :1], pad, axis=1)], axis=1)
            mask = np.concatenate(
                [mask, np.zeros((mask.shape[0], pad), bool)], axis=1)
        self.ctrl = ctrl
        self.spec = spec
        self.ids = ids.astype(np.int64)
        self.mask = mask.copy()
        self.base_tgt = mask.sum(1).astype(np.int64)
        self.cost = ctrl.migration.cost_table(tier_rates)
        self.counts: Dict[int, int] = {}
        self.lanes: List[Dict[str, Any]] = []  # chunk/slot/src/dst/done_t
        self.ever_lost: set = set()
        self.moves = 0
        self.dropped = 0
        self.lost_reads = 0
        self._alive = np.ones(spec.num_workers, bool)
        self._busy: set = set()
        # Structured event tracing: the engine installs its EventRecorder
        # here; None -> no events emitted.
        self.tracer = None

    @property
    def num_chunks(self) -> int:
        return self.ids.shape[0]

    # -- lifecycle -----------------------------------------------------------
    def observe(self, t: float, alive) -> None:
        """Advance the lifecycle to time `t` under liveness mask `alive`:
        wipe replicas on dead hosts, kill/commit in-flight moves, drop
        surpluses, start deficit repairs within the lane cap."""
        alive = np.asarray(alive, bool)
        if self.tracer is not None:
            ts = float(t) * CLOCK_UNIT_US
            for h in np.nonzero(self._alive & ~alive)[0]:
                self.tracer.instant("server_down", cat="failure", ts_us=ts,
                                    tid=int(h))
            for h in np.nonzero(~self._alive & alive)[0]:
                self.tracer.instant("server_up", cat="failure", ts_us=ts,
                                    tid=int(h))
        self._alive = alive
        self.mask &= alive[self.ids]
        survivors = []
        for ln in self.lanes:
            if not (alive[ln["src"]] and alive[ln["dst"]]):
                continue  # killed with its endpoint
            if ln["done_t"] <= t:
                self.ids[ln["chunk"], ln["slot"]] = ln["dst"]
                self.mask[ln["chunk"], ln["slot"]] = True
                self.moves += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "repair_commit", cat="replication",
                        ts_us=float(t) * CLOCK_UNIT_US, tid=ln["dst"],
                        chunk=ln["chunk"], src=ln["src"])
            else:
                survivors.append(ln)
        self.lanes = survivors

        live = self.mask.sum(1)
        self.ever_lost.update(int(c) for c in np.nonzero(live == 0)[0])
        tgt = np.clip(self.ctrl.host_targets(self.counts, live,
                                             self.base_tgt),
                      1, self.ids.shape[1])
        for c in np.nonzero(live > tgt)[0]:  # free drops, keep first tgt
            cols = np.nonzero(self.mask[c])[0]
            self.mask[c, cols[int(tgt[c]):]] = False
            self.dropped += len(cols) - int(tgt[c])
        live = self.mask.sum(1)

        infl = np.zeros(self.num_chunks, np.int64)
        for ln in self.lanes:
            infl[ln["chunk"]] += 1
        deficit = np.clip(tgt - live - infl, 0, None)
        deficit[live == 0] = 0  # no live source to copy from
        held = np.bincount(self.ids[self.mask],
                           minlength=self.spec.num_workers).astype(float)
        started = 0
        for c in sorted(np.nonzero(deficit > 0)[0],
                        key=lambda c: (-int(deficit[c]), int(c))):
            for _ in range(int(deficit[c])):
                if len(self.lanes) >= self.ctrl.lanes \
                        or started >= self.ctrl.moves_per_slot:
                    self._rebuild_busy()
                    return
                row = self.ids[c]
                src = int(row[self.mask[c]].min())
                excluded = set(int(h) for h in row[self.mask[c]])
                excluded |= {ln["dst"] for ln in self.lanes
                             if ln["chunk"] == c}
                cand = [h for h in range(self.spec.num_workers)
                        if alive[h] and h not in excluded]
                if not cand:
                    break
                dst = min(cand, key=lambda h: (held[h], h))
                taken = {ln["slot"] for ln in self.lanes
                         if ln["chunk"] == c}
                slot = next(s for s in range(self.ids.shape[1])
                            if not self.mask[c, s] and s not in taken)
                tier = tier_of(self.spec, [src], dst)
                self.lanes.append({"chunk": int(c), "slot": int(slot),
                                   "src": src, "dst": int(dst),
                                   "done_t": float(t)
                                   + float(self.cost[tier])})
                if self.tracer is not None:
                    self.tracer.instant(
                        "repair_start", cat="replication",
                        ts_us=float(t) * CLOCK_UNIT_US, tid=int(dst),
                        chunk=int(c), src=src,
                        eta=self.lanes[-1]["done_t"])
                held[dst] += 1.0
                started += 1
        self._rebuild_busy()

    def _rebuild_busy(self) -> None:
        self._busy = {ln["src"] for ln in self.lanes} \
            | {ln["dst"] for ln in self.lanes}

    # -- consumer surface ----------------------------------------------------
    def replicas_for(self, chunk_id: int) -> List[int]:
        """Sorted live hosts of `chunk_id` — empty when every replica is
        gone (the consumer falls back to a cold-store refetch and the
        read is counted as lost)."""
        c = int(chunk_id) % self.num_chunks
        locs = sorted(int(h) for h in self.ids[c][self.mask[c]])
        if not locs:
            self.lost_reads += 1
        return locs

    def note_read(self, chunk_id: int) -> None:
        c = int(chunk_id) % self.num_chunks
        self.counts[c] = self.counts.get(c, 0) + 1

    def contention_mult(self, host: int) -> float:
        """Foreground rate multiplier on `host` (migration contention)."""
        return self.ctrl.migration.contention if host in self._busy else 1.0

    def is_alive(self, host: int) -> bool:
        return bool(self._alive[host])

    # -- metrics -------------------------------------------------------------
    def availability(self) -> float:
        """Fraction of chunks with >= 1 live replica right now."""
        return float((self.mask.sum(1) > 0).mean())

    def mean_replication(self) -> float:
        return float(self.mask.sum(1).mean())

    def data_loss_frac(self) -> float:
        """Fraction of chunks that ever had zero live replicas."""
        return len(self.ever_lost) / self.num_chunks

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe lifecycle state (catalogue, lanes, popularity,
        counters)."""
        keys = sorted(self.counts)
        return {
            "ids": self.ids.tolist(),
            "mask": self.mask.astype(int).tolist(),
            "count_ids": [int(k) for k in keys],
            "counts": [int(self.counts[k]) for k in keys],
            "lanes": [[int(ln["chunk"]), int(ln["slot"]), int(ln["src"]),
                       int(ln["dst"]), float(ln["done_t"])]
                      for ln in self.lanes],
            "ever_lost": sorted(int(c) for c in self.ever_lost),
            "moves": int(self.moves),
            "dropped": int(self.dropped),
            "lost_reads": int(self.lost_reads),
        }

    def load_state_dict(self, s: Mapping[str, Any]) -> None:
        ids = np.asarray(s["ids"], np.int64)
        mask = np.asarray(s["mask"], bool)
        if ids.shape != self.ids.shape:
            raise ValueError(f"catalogue shape mismatch: checkpoint "
                             f"{ids.shape} vs configured {self.ids.shape}")
        self.ids, self.mask = ids, mask
        self.counts = {int(k): int(v)
                       for k, v in zip(s["count_ids"], s["counts"])}
        self.lanes = [{"chunk": int(c), "slot": int(sl), "src": int(a),
                       "dst": int(b), "done_t": float(d)}
                      for c, sl, a, b, d in s["lanes"]]
        self.ever_lost = set(int(c) for c in s["ever_lost"])
        self.moves = int(s["moves"])
        self.dropped = int(s["dropped"])
        self.lost_reads = int(s["lost_reads"])
        self._rebuild_busy()
