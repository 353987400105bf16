"""Continuous-batching serving engine with a Balanced-PANDAS request router
(counterpart of `repro.serve.engine`).

Cluster model (the paper's data center, one level up the stack):
  * R replica groups ("servers"), grouped into pods ("racks");
  * every request carries a prefix id whose KV/prompt artifacts are resident
    on the replicas its placement policy puts them on
    (`EngineConfig.placement`, `repro_torch.placement`; the default
    ``uniform`` is rendezvous hashing onto 3 replicas) — its *local*
    replicas; same-pod replicas are *rack-local*, the rest *remote*;
  * the router assigns each incoming request to a replica by weighted
    workload over estimated service rates; rates are measured online per
    (replica, tier) with the EWMA estimator, so a slow replica sheds load
    without any configuration.

The engine runs the model: per-replica prefill (bucketed, right-padded
prompts) through the model's hand-written kernel — flash attention
(``impl="pallas"``) for an attention model, the SSD scan
(``impl="pallas_ssd"``) for a Mamba one: the CUDA kernel on the card, its
plain version on the CPU — and batched decode steps over slotted KV and
SSM caches with per-slot lengths.  Any router registered in
`core/policy.py` is selectable by name (`EngineConfig.scheduler`).  All
replicas share one parameter tree.  Every architecture id is served: a
hybrid (jamba) prefills through the SSD scan, its attention layer on
the plain path; like the reference's engine, this one passes no frames
and no frontend, so an encoder-decoder (whisper-medium) attends over the
all-zero cross cache of `init_caches` and a vision model over its text
alone.

Scenarios (`EngineConfig.scenario`, `repro_torch.workloads`): the engine
plays the scenario back on its step clock (`HostPlayback`, one cycle every
``scenario_horizon`` steps) and inflates every observed prefill time by
the playback's slowdown of that replica and tier, so stragglers and
congested tiers open and close during a run and the router's EWMA sees
them.

Placement (`EngineConfig.placement`: a name, `PlacementConfig` or
instance): every routed request's prefix is looked up in the placement,
which is told of the read (`note_read`); every ``rebalance_every`` routed
requests (0: never) the placement re-derives its popularity-driven part
(`rebalance`, which only ``hot_aware`` acts on).  `routed` and
`rebalanced` count both.

Replication (`EngineConfig.replication`, `repro_torch.replication`): the
lifecycle (`HostReplication`) engages only when a dynamic controller is
set or the scenario has a failure track (``server_loss``,
``rack_loss``).  Then each step first observes the playback's liveness
mask; arrivals route over the lifecycle's live replica set of their
prefix (an all-dead prefix falls back to the placement's static set and
counts in `lost_routes`); an admission's observed prefill time is
divided by its replica's migration contention and, on a dead replica,
multiplied by `DEAD_SLOWDOWN`, so the EWMA estimator sheds it.  With
None/"fixed" and no failures nothing is built and the engine is the one
without replication.

Tracing (`EngineConfig.tracer`, a `repro_torch.telemetry.EventRecorder`):
the engine names its threads (router on tid 0, replica i on tid i+1),
emits ``submit``/``route``/``lost_route``/``admit`` instants and the
``queued`` counter on the step clock (one step = ``CLOCK_UNIT_US``),
one wall-clock-wide ``decode`` span (cat ``kernel``) per replica step
and one ``request{rid}`` span per finished request, and installs the
tracer on its `HostReplication`.  With None the step is the untraced
one.  `arrival_log` keeps every submit's step, and `recorded_trace`
re-records it as a replayable `workloads.Trace`.

Control (`EngineConfig.control`, `repro_torch.control`: a controller
name, `ControlConfig`, instance or sequence) builds the host projection
(`HostControl`).  `submit` asks admission first: a shed request is
settled at ``finish_time = -1.0`` (a ``shed`` instant when traced) and
is never routed, prefilled or counted in `completed`; `in_system` is
then admitted minus completed.  At the end of each step the autoscaler
reads the sojourn p95; a new target parks the replicas past it in the
`scale_priority` order (`Router.set_active`, an ``autoscale`` instant):
a parked replica drains its own routed queue and then claims nothing.
A closed-loop loadgen's client pool is `control.clients`, polled by the
caller.  With None nothing is built.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.control import resolve_control, scale_priority
from repro_torch.core.cluster import tier_of
from repro_torch.core.estimator import EwmaRateEstimator
from repro_torch.core.locality import Topology
from repro_torch.core.policy import make_router
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.placement import make_placement
from repro_torch.replication import make_replication
from repro_torch.telemetry import CLOCK_UNIT_US, percentiles_from_hist
from repro_torch.workloads import (Trace, host_playback, make_scenario,
                                   trace_from_arrivals)

# Observed-service-time inflation for a request admitted on a DEAD replica
# (failure scenarios): large enough that the EWMA estimator sheds the
# replica within a few observations, finite so the engine still drains.
DEAD_SLOWDOWN = 25.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new_tokens: int
    prefix_id: int = 0
    arrival: float = 0.0
    # filled by the engine
    replica: int = -1
    tier: int = -1
    generated: Optional[List[int]] = None
    finish_time: float = 0.0
    start_time: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    num_replicas: int = 4
    replicas_per_pod: int = 2
    slots_per_replica: int = 4
    max_len: int = 256
    prefill_buckets: Sequence[int] = (32, 64, 128)
    scheduler: str = "balanced_pandas"
    # prior service rates (requests/step) per tier; measured online
    rate_local: float = 1.0
    rate_rack: float = 0.7
    rate_remote: float = 0.4
    # K-tier overrides: a full `locality.Topology` for the replica fleet
    # (num_replicas/replicas_per_pod are then derived from it) and a (K,)
    # tier-rate prior replacing the three rate_* fields.
    topology: Optional[Topology] = None
    tier_rates: Optional[Sequence[float]] = None
    seed: int = 0
    # The reference's seams.  `scenario` (name / ScenarioConfig /
    # Scenario; None -> static) is played back over `scenario_horizon`
    # engine steps a cycle; `placement` (name / PlacementConfig /
    # instance; None -> uniform) places the prefixes, rebalanced every
    # `rebalance_every` routed requests (0: never); `replication` (name /
    # ReplicationConfig / controller; None -> fixed) runs the lifecycle
    # over a catalogue of `num_prefixes` prefixes (prefix ids wrap mod
    # it) when engaged; `tracer` (an EventRecorder; None: no events)
    # records the run's events; `control` (name / ControlConfig /
    # controller / sequence; None -> no control plane) sheds at submit and
    # parks replicas under an autoscaler.
    scenario: object = None
    scenario_horizon: int = 400  # engine steps per playback cycle
    placement: object = None
    rebalance_every: int = 0
    replication: object = None
    num_prefixes: int = 64
    tracer: object = None
    control: object = None
    # host-side sojourn histogram (submit -> finish, engine steps), read
    # by `sojourn_percentiles()`
    sojourn_hist_bins: int = 512
    sojourn_hist_max: float = 512.0


class Replica:
    """One replica group: slotted KV caches, eager prefill and decode."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device: torch.device):
        self.cfg = cfg
        self.params = params          # shared by every replica, not copied
        self.ecfg = ecfg
        self.device = device
        b = ecfg.slots_per_replica
        self.caches = T.init_caches(cfg, b, ecfg.max_len, device=device)
        self.prefill_impl = T.prefill_impl(cfg)
        self.lengths = np.zeros(b, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * b

    def free_slots(self) -> int:
        return sum(r is None for r in self.slot_req)

    def admit(self, req: Request) -> None:
        slot = self.slot_req.index(None)
        self.slot_req[slot] = req
        t = min(len(req.prompt), self.ecfg.max_len - req.max_new_tokens - 1)
        bucket = next((b for b in self.ecfg.prefill_buckets if b >= t),
                      self.ecfg.prefill_buckets[-1])
        t = min(t, bucket)
        prompt = np.zeros(bucket, np.int32)
        prompt[:t] = req.prompt[-t:]
        # Right-padded: pad positions are negative -> committed into
        # invalid (-marked) ring slots; real rows never see pad keys.  A
        # Mamba layer's scan runs through the pads as the reference's
        # does, and its states carry them into decode (ROADMAP Queue 3).
        pos = np.where(np.arange(bucket) < t, np.arange(bucket),
                       -(np.arange(bucket) - t + 1)).astype(np.int32)
        # The prefill goes through the model's hand-written kernel
        # (`prefill_impl`), where the reference's engine takes its XLA
        # path: the real rows agree (ROADMAP Queue 3).
        dev = self.device
        caches1 = T.init_caches(self.cfg, 1, self.ecfg.max_len, device=dev)
        logits, sub, _ = T.forward(
            self.params, self.cfg, torch.as_tensor(prompt[None], device=dev),
            positions=torch.as_tensor(pos[None], device=dev), caches=caches1,
            impl=self.prefill_impl)
        # merge the freshly prefilled rows (K/V, or SSM and conv states)
        # into this slot
        for i, stage in sub.items():
            for j, entry in stage.items():
                for kind, leaves in entry.items():
                    for name, one in leaves.items():
                        self.caches[i][j][kind][name][:, slot:slot + 1] = one
        self.lengths[slot] = t
        req.generated = [int(torch.argmax(logits[0, t - 1]))]
        req.start_time = time.monotonic()

    def decode_once(self) -> List[Request]:
        """One batched decode step; returns the requests that finished."""
        finished: List[Request] = []
        if all(r is None for r in self.slot_req):
            return finished
        tokens = np.zeros((len(self.slot_req), 1), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.generated:
                tokens[i, 0] = r.generated[-1]
        logits, self.caches = T.decode_step(
            self.params, self.cfg, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(self.lengths, dtype=torch.int32,
                            device=self.device), self.caches)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.lengths[i] += 1
            r.generated.append(int(nxt[i]))
            if (len(r.generated) > r.max_new_tokens
                    or self.lengths[i] >= self.ecfg.max_len - 1):
                r.finish_time = time.monotonic()
                finished.append(r)
                self.slot_req[i] = None
                self.lengths[i] = 0
        return finished


class ServingEngine:
    """`device=None` means the card (and raises without one); the
    parameter tree must already live on that device."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 slow_replicas: Optional[Dict[int, float]] = None,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the parameters live on "
                             f"{params['embed'].device}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.ecfg = cfg, ecfg
        self.spec = ecfg.topology if ecfg.topology is not None else \
            Topology(ecfg.num_replicas, ecfg.replicas_per_pod)
        n_rep = self.spec.num_servers
        prior = np.asarray(
            ecfg.tier_rates if ecfg.tier_rates is not None
            else (ecfg.rate_local, ecfg.rate_rack, ecfg.rate_remote),
            np.float32)
        if prior.shape != (self.spec.num_tiers,):
            raise ValueError(f"engine prior has {prior.size} tier rates but "
                             f"the fleet has {self.spec.num_tiers} tiers")
        self.estimator = EwmaRateEstimator(n_rep, prior)
        self.router = make_router(ecfg.scheduler, self.spec, prior,
                                  estimator=self.estimator, seed=ecfg.seed)
        # prefix artifacts live where the placement policy puts them
        self.placement = make_placement(ecfg.placement)
        if ecfg.rebalance_every < 0:
            raise ValueError(f"rebalance_every must be >= 0, got "
                             f"{ecfg.rebalance_every}")
        self.routed = 0
        self.rebalanced = 0
        # One scenario seam for every scheduler: the playback inflates the
        # observed service times the estimator sees, like the static
        # `slow_replicas` dict but time-varying (stragglers open and close).
        self.playback = host_playback(make_scenario(ecfg.scenario),
                                      n_rep, float(ecfg.scenario_horizon),
                                      num_tiers=self.spec.num_tiers,
                                      rack_of=np.asarray(self.spec.rack_of))
        # Replication lifecycle: engaged only when a controller is
        # configured or the scenario kills servers — otherwise replica
        # lookups go straight to the placement policy.
        ctrl = make_replication(ecfg.replication)
        if ctrl.is_static and self.playback.alive is None:
            self.replication = None
        else:
            self.replication = ctrl.build_host(
                self.spec, self.placement, ecfg.num_prefixes, 3,
                ecfg.seed, prior)
        self.lost_routes = 0  # arrivals whose prefix had no live replica
        # Host control plane: admission and autoscaling on the engine-step
        # clock.  None -> nothing is built.
        plane = resolve_control(ecfg.control)
        self.control = None if plane is None else \
            plane.build_host(self.spec, float(prior[0]), seed=ecfg.seed)
        # autoscale parking: rank r is the r-th replica kept on shrink
        self._scale_rank = scale_priority(self.spec)
        self._parked = np.zeros(n_rep, bool)
        self.replicas = [Replica(cfg, params, ecfg, self.device)
                         for _ in range(n_rep)]
        self.queue: deque = deque()            # not-yet-routed arrivals
        self.waiting: List[deque] = [deque()   # routed, awaiting a slot
                                     for _ in range(n_rep)]
        self.pending: deque = deque()          # deferred-assignment (global)
        self.slow = slow_replicas or {}
        if ecfg.sojourn_hist_bins < 1 or ecfg.sojourn_hist_max <= 0:
            raise ValueError("sojourn_hist_bins must be >= 1 and "
                             "sojourn_hist_max > 0")
        self._soj_width = float(ecfg.sojourn_hist_max) / ecfg.sojourn_hist_bins
        self.sojourn_hist = np.zeros(ecfg.sojourn_hist_bins + 1, np.int64)
        self.completed = 0
        self.steps = 0
        self.assign_tiers = {t: 0 for t in range(self.spec.num_tiers)}
        # engine-step index of every submit, for trace export
        # (`recorded_trace`)
        self.arrival_log: List[int] = []
        # Structured event tracing: router events on tid 0, each replica
        # on tid i+1; the virtual clock is the engine-step counter.
        self.tracer = ecfg.tracer
        if self.replication is not None:
            self.replication.tracer = self.tracer
        if self.tracer is not None:
            self.tracer.metadata("process_name", name="serving_engine")
            self.tracer.metadata("thread_name", tid=0, name="router")
            for i in range(n_rep):
                self.tracer.metadata("thread_name", tid=i + 1,
                                     name=f"replica{i}")

    def _ts(self) -> float:
        """Virtual-clock timestamp (us) of the current engine step."""
        return self.steps * CLOCK_UNIT_US

    def submit(self, req: Request) -> None:
        req.arrival = time.monotonic()
        req._submit_step = self.steps  # type: ignore[attr-defined]
        self.arrival_log.append(self.steps)
        if self.control is not None and \
                not self.control.admit(self.steps, self.in_system):
            # shed BEFORE routing: the request never touches a queue;
            # finish_time = -1.0 settles it (run_until_drained waits on
            # == 0.0) without its ever having started
            req.finish_time = -1.0
            if self.tracer is not None:
                self.tracer.instant("shed", cat="engine", ts_us=self._ts(),
                                    rid=req.rid, prefix=req.prefix_id)
            return
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.instant("submit", cat="engine", ts_us=self._ts(),
                                rid=req.rid, prefix=req.prefix_id)

    @property
    def in_system(self) -> int:
        """Admitted-but-unfinished requests (queued, waiting, decoding):
        admitted == completed + in_system at every step."""
        if self.control is not None:
            return self.control.admitted - self.completed
        return len(self.arrival_log) - self.completed

    def _note_finished(self, finished: List[Request]) -> None:
        """Sojourn accounting (submit -> finish on the engine-step clock)."""
        for r in finished:
            self.completed += 1
            b = min(int((self.steps - r._submit_step) / self._soj_width),
                    len(self.sojourn_hist) - 1)
            self.sojourn_hist[b] += 1

    def sojourn_percentiles(self, qs=(0.5, 0.95, 0.99)) -> np.ndarray:
        """Sojourn quantiles (engine steps) from the host histogram:
        upper-bin-edge estimates (NaN before the first completion, inf
        from the overflow bin)."""
        return percentiles_from_hist(self.sojourn_hist, self._soj_width, qs)

    @property
    def sojourn_overflow_frac(self) -> float:
        """Fraction of completions whose sojourn exceeded
        ``sojourn_hist_max`` (quantiles landing there report inf)."""
        total = int(self.sojourn_hist.sum())
        return float(self.sojourn_hist[-1]) / max(total, 1)

    def recorded_trace(self, num_intervals: int = 32,
                       name: str = "engine") -> Trace:
        """Re-record this run's arrival stream as a replayable `Trace`
        (per-interval submit counts on the engine-step clock), which
        ``scenario="trace"`` replays through this engine or the
        simulator."""
        horizon = float(max([self.steps, 1]
                            + [s + 1 for s in self.arrival_log]))
        return trace_from_arrivals(self.arrival_log, num_intervals,
                                   name=name, horizon=horizon)

    # -- scheduling ----------------------------------------------------------
    def _route_arrivals(self) -> None:
        while self.queue:
            req = self.queue.popleft()
            if self.replication is not None:
                # live replica set from the lifecycle catalogue; an
                # all-dead prefix falls back to the placement's static
                # set (a cold-store refetch) and counts as a lost route
                locs = self.replication.replicas_for(req.prefix_id)
                self.replication.note_read(req.prefix_id)
                if not locs:
                    self.lost_routes += 1
                    if self.tracer is not None:
                        self.tracer.instant("lost_route", cat="engine",
                                            ts_us=self._ts(), rid=req.rid,
                                            prefix=req.prefix_id)
                    locs = self.placement.replicas(self.spec, req.prefix_id,
                                                   3, self.ecfg.seed)
            else:
                locs = self.placement.replicas(self.spec, req.prefix_id, 3,
                                               self.ecfg.seed)
            self.placement.note_read(req.prefix_id)
            self.routed += 1
            if self.ecfg.rebalance_every and \
                    self.routed % self.ecfg.rebalance_every == 0:
                self.rebalanced += self.placement.rebalance()
            req._locs = locs  # type: ignore[attr-defined]
            decision = self.router.route(locs)
            if self.tracer is not None:
                self.tracer.instant(
                    "route", cat="engine", ts_us=self._ts(), rid=req.rid,
                    replica=-1 if decision.deferred else decision.worker)
            if decision.deferred:
                self.pending.append(req)  # assigned at claim time
            else:
                req.replica = decision.worker
                self.waiting[decision.worker].append(req)

    def _admit(self) -> None:
        for i, rep in enumerate(self.replicas):
            # a parked (descaled) replica drains its already-routed queue,
            # then stops claiming: it must not pull from the global
            # deferred queue or steal other replicas' work
            if self._parked[i] and not self.waiting[i]:
                continue
            while rep.free_slots():
                claim = self.router.claim(i)
                if claim is None:
                    break
                # claim.source names the queue the task came from: a
                # replica's routed queue, or the global deferred queue (-1).
                src = self.pending if claim.source < 0 \
                    else self.waiting[claim.source]
                req = src.popleft()
                req.replica = i
                req.tier = tier_of(self.spec, req._locs, req.replica)
                self.assign_tiers[req.tier] += 1
                req._admit_step = self.steps  # type: ignore[attr-defined]
                if self.tracer is not None:
                    self.tracer.instant("admit", cat="engine",
                                        ts_us=self._ts(), tid=i + 1,
                                        rid=req.rid, tier=req.tier)
                t0 = time.monotonic()
                rep.admit(req)
                # wall clock of the prefill (it ends in a host read of the
                # first token), scaled by a configured slowdown and the
                # scenario's slowdown of this replica and tier at this step
                slow = self.slow.get(i, 1.0) * self.playback.slowdown(
                    self.steps, req.replica, req.tier)
                if self.replication is not None:
                    # migration endpoints serve slower (contention); dead
                    # replicas inflate hard so the EWMA sheds them
                    slow /= self.replication.contention_mult(req.replica)
                    if not self.replication.is_alive(req.replica):
                        slow *= DEAD_SLOWDOWN
                elapsed = (time.monotonic() - t0) * slow
                self.router.on_complete(req.replica, req.tier,
                                        max(elapsed, 1e-4))

    # -- execution -----------------------------------------------------------
    def step(self) -> None:
        """One engine tick: route arrivals, admit into free slots, one decode
        step on every replica."""
        if self.replication is not None:
            self.replication.observe(float(self.steps),
                                     self.playback.alive_mask_at(self.steps))
        self._route_arrivals()
        self._admit()
        if self.tracer is None:
            for rep in self.replicas:
                self._note_finished(rep.decode_once())
        else:
            self.tracer.counter(
                "queued", len(self.queue) + len(self.pending)
                + sum(len(w) for w in self.waiting), ts_us=self._ts())
            for i, rep in enumerate(self.replicas):
                active = sum(r is not None for r in rep.slot_req)
                t0 = self.tracer.now_us()
                finished = rep.decode_once()
                self._note_finished(finished)
                if active:
                    # virtual-clock placement, wall-clock width: the
                    # replica step's host time (its decode ends in a host
                    # read of the next tokens)
                    self.tracer.complete("decode", self._ts(),
                                         self.tracer.now_us() - t0,
                                         cat="kernel", tid=i + 1,
                                         batch=active)
                for r in finished:
                    a = getattr(r, "_admit_step", self.steps)
                    self.tracer.complete(
                        f"request{r.rid}", a * CLOCK_UNIT_US,
                        (self.steps - a + 1) * CLOCK_UNIT_US, cat="request",
                        tid=r.replica + 1, rid=r.rid, tier=r.tier,
                        tokens=len(r.generated or ()))
        if self.control is not None and self.control.autoscaler is not None:
            # reactive autoscaling: feed the measured sojourn p95; a new
            # target reshapes the routing mask (parked replicas drain)
            p95 = float(self.sojourn_percentiles((0.95,))[0])
            target = self.control.observe(self.steps, p95)
            if target is not None:
                mask = self._scale_rank < target
                self.router.set_active(mask)
                self._parked = ~mask
                if self.tracer is not None:
                    self.tracer.instant("autoscale", cat="engine",
                                        ts_us=self._ts(), target=int(target))
        self.steps += 1

    def run_until_drained(self, all_requests: Sequence[Request],
                          max_steps: int = 10_000) -> List[Request]:
        for r in all_requests:
            self.submit(r)
        outstanding = list(all_requests)
        while any(r.finish_time == 0.0 for r in outstanding):
            self.step()
            if self.steps > max_steps:
                raise RuntimeError("engine did not drain")
        return outstanding

    @property
    def queue_depths(self) -> np.ndarray:
        return self.router.queue_depths()
