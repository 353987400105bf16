"""Deterministic data pipeline with locality-aware chunk scheduling (the
port's counterpart of `repro.data.pipeline`; copied: numpy).

The MapReduce structure of the paper maps directly onto the input pipeline of
training: the corpus is split into chunks, every chunk is replicated on 3
data hosts — *which* hosts is the configured `PlacementPolicy`
(`repro_torch.placement`, ``PipelineConfig.placement``; the default
"uniform" is the classic rendezvous hashing) — and each read is a "map
task" whose service rate depends on where it runs: on a replica host
(local), on a host in the same pod (rack-local), or across pods (remote).
The chunk->host assignment runs any router registered in
`repro_torch.core.policy` (Balanced-PANDAS default; JSQ-MW, FIFO,
power-of-d PANDAS selectable by name) through the uniform
`route -> Decision` / `claim -> Claim` surface, with host read rates
estimated online (EWMA), so a straggling host sheds load — the robustness
property the paper establishes is what makes the blind version
deployable.  Time-varying faults come from the scenario subsystem
(`PipelineConfig.scenario`, `repro_torch.workloads`): straggler windows
and congestion sags play back on the virtual clock, recorded cluster
traces included (``scenario=ScenarioConfig("trace", {...})``).

Tokens are synthesized deterministically from (seed, chunk_id), so any two
runs — and any resharding of hosts — produce identical global batches
(byte-for-byte reproducible input, a requirement of elastic restarts).
The pipeline runs on the host and nothing of it on the card: the batches
are numpy ``int32`` arrays, as the reference's are, and the trainer moves
them to its device.  Its three numpy generators, the router's random
state and the order of every draw are the reference's, so under one
configuration the two pipelines give the same batches byte for byte and
the same metrics and state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import tier_of
from repro_torch.core.estimator import EwmaRateEstimator
from repro_torch.core.locality import Topology
from repro_torch.core.policy import make_router
from repro_torch.placement import PlacementLike, make_placement
# chunk_replicas's home is the placement subsystem; re-exported for the
# long-standing name
from repro_torch.placement.policies import chunk_replicas  # noqa: F401
from repro_torch.replication import ReplicationLike, make_replication
from repro_torch.telemetry import CLOCK_UNIT_US, EventRecorder
from repro_torch.workloads import ScenarioLike, host_playback, make_scenario


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_hosts: int = 16
    hosts_per_pod: int = 8
    num_chunks: int = 1024
    tokens_per_chunk: int = 65_536
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    replication: int = 3
    scheduler: str = "balanced_pandas"
    # replica placement (repro_torch.placement): which hosts hold each chunk.
    # None -> "uniform" (the classic rendezvous placement, bitwise).
    placement: PlacementLike = None
    # deterministic placement rebalance cadence (reads between
    # `PlacementPolicy.rebalance()` calls; 0 disables) — only meaningful
    # for popularity-driven placements (hot_aware)
    rebalance_every: int = 0
    # token unigram skew: 0.0 keeps the classic uniform synthetic tokens
    # (bitwise); > 0 draws Zipf(s)-distributed tokens so a language model
    # trained on the pipeline has learnable statistics (quickstart)
    token_skew: float = 0.0
    # mean simulated read service rates (reads per virtual-clock unit)
    rate_local: float = 1.0
    rate_rack: float = 0.8
    rate_remote: float = 0.4
    # K-tier overrides: a full `locality.Topology` for the host fleet
    # (num_hosts/hosts_per_pod are then derived from it) and a (K,)
    # tier-rate vector replacing the three rate_* fields.
    topology: Optional[Topology] = None
    tier_rates: Optional[Tuple[float, ...]] = None
    # scenario playback (repro_torch.workloads) on the virtual clock: straggler
    # hosts and congestion windows; None -> "static" (multipliers 1.0)
    scenario: ScenarioLike = None
    scenario_horizon: float = 256.0  # virtual-time units per playback cycle
    # replication lifecycle (repro_torch.replication): chunk replica sets become
    # time-varying — wiped on host death, repaired / widened by the
    # selected controller under the migration bandwidth cap.  None ->
    # "fixed"; the machinery only engages when a dynamic controller is
    # selected or the scenario carries a failure track, so the default
    # read path stays bitwise identical.  (`replication` above is the
    # *factor*; this picks the *controller*.)
    replication_policy: ReplicationLike = None
    # structured event tracing (repro_torch.telemetry.EventRecorder): chunk-read
    # complete events and failover instants on the pipeline's virtual
    # clock (1 clock unit == 1 ms in the exported Chrome trace).  None ->
    # no events, zero overhead.
    tracer: Optional[EventRecorder] = None


def chunk_tokens(cfg: PipelineConfig, chunk_id: int) -> np.ndarray:
    """Deterministic synthetic tokens for one chunk: uniform by default
    (bitwise-stable across PRs), Zipf-skewed when ``cfg.token_skew > 0``
    (rank r gets mass ~ r^-skew — learnable unigram statistics)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, chunk_id]))
    if cfg.token_skew <= 0.0:
        return rng.integers(0, cfg.vocab_size, cfg.tokens_per_chunk,
                            dtype=np.int32)
    p = np.arange(1, cfg.vocab_size + 1, dtype=np.float64) ** -cfg.token_skew
    cdf = np.cumsum(p / p.sum())
    u = rng.random(cfg.tokens_per_chunk)
    return np.minimum(np.searchsorted(cdf, u),
                      cfg.vocab_size - 1).astype(np.int32)


class DataPipeline:
    """Iterator of {tokens, labels} batches with scheduler-driven reads.

    Reads run on a virtual clock: each chunk read is assigned to a host by
    the configured router and "takes" a sampled service time based on its
    true locality tier (optionally skewed by `slow_hosts` to model
    stragglers).  Observed times feed the EWMA estimator, closing the blind
    scheduling loop.  Metrics expose locality mix and per-host load.
    """

    def __init__(self, cfg: PipelineConfig,
                 slow_hosts: Optional[Dict[int, float]] = None):
        self.cfg = cfg
        # The same unified `Topology` as the simulator (ClusterSpec retired)
        self.spec = cfg.topology if cfg.topology is not None else \
            Topology(cfg.num_hosts, cfg.hosts_per_pod)
        n_hosts = self.spec.num_servers
        self.prior = np.asarray(
            cfg.tier_rates if cfg.tier_rates is not None
            else (cfg.rate_local, cfg.rate_rack, cfg.rate_remote),
            np.float32)
        if self.prior.shape != (self.spec.num_tiers,):
            raise ValueError(f"pipeline prior has {self.prior.size} tier "
                             f"rates but the fleet has "
                             f"{self.spec.num_tiers} tiers")
        self.estimator = EwmaRateEstimator(n_hosts, self.prior)
        self.router = make_router(cfg.scheduler, self.spec, self.prior,
                                  estimator=self.estimator, seed=cfg.seed)
        # Replica placement: every chunk -> host assignment flows through
        # one PlacementPolicy (uniform == the classic `chunk_replicas`).
        self.placement = make_placement(cfg.placement)
        if cfg.rebalance_every < 0:
            raise ValueError(f"rebalance_every must be >= 0, got "
                             f"{cfg.rebalance_every}")
        self.slow = slow_hosts or {}
        # Scenario playback over the virtual clock: the same declarative
        # scenarios the simulator and serving engine run, here modelling
        # straggler hosts / congested links during read windows.
        self.playback = host_playback(make_scenario(cfg.scenario),
                                      n_hosts, cfg.scenario_horizon,
                                      num_tiers=self.spec.num_tiers,
                                      rack_of=np.asarray(self.spec.rack_of))
        # Replication lifecycle over the chunk catalogue: engaged only when
        # a controller is configured or the scenario kills hosts.
        ctrl = make_replication(cfg.replication_policy)
        if ctrl.is_static and self.playback.alive is None:
            self.replication_ctl = None
        else:
            self.replication_ctl = ctrl.build_host(
                self.spec, self.placement, cfg.num_chunks, cfg.replication,
                cfg.seed, self.prior)
        # Structured event tracing: hosts are trace tids, the virtual
        # clock maps to trace time at 1 unit == 1 ms.
        self.tracer = cfg.tracer
        if self.replication_ctl is not None:
            self.replication_ctl.tracer = self.tracer
        if self.tracer is not None:
            self.tracer.metadata("process_name", name="data_pipeline")
            for h in range(n_hosts):
                self.tracer.metadata("thread_name", tid=h, name=f"host{h}")
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._clock = 0.0
        self.metrics = {"local": 0, "rack": 0, "remote": 0,
                        "reads": 0, "virtual_time": 0.0,
                        "tier_reads": np.zeros(self.spec.num_tiers, np.int64),
                        "host_reads": np.zeros(n_hosts, np.int64)}
        self._chunk_order = np.random.default_rng(cfg.seed + 2).permutation(
            cfg.num_chunks)
        self._cursor = 0  # chunk index
        self._buffer = np.empty((0,), np.int32)

    # -- scheduling ---------------------------------------------------------
    def _read_chunk(self, chunk_id: int) -> np.ndarray:
        if self.replication_ctl is not None:
            # advance the lifecycle to the virtual clock, then read from
            # the live catalogue; an all-dead chunk falls back to the
            # static placement (cold-store refetch, counted as lost)
            self.replication_ctl.observe(
                self._clock, self.playback.alive_mask_at(self._clock))
            self.replication_ctl.note_read(chunk_id)
            locs = self.replication_ctl.replicas_for(chunk_id)
            self.metrics["lost_reads"] = self.replication_ctl.lost_reads
            self.metrics["repair_moves"] = self.replication_ctl.moves
            if not locs:
                locs = self.placement.replicas(self.spec, chunk_id,
                                               self.cfg.replication,
                                               self.cfg.seed)
        else:
            locs = self.placement.replicas(self.spec, chunk_id,
                                           self.cfg.replication,
                                           self.cfg.seed)
        decision = self.router.route(locs)
        # Deferred-assignment routers (global queue) pick the host only at
        # claim time; the synchronous pipeline stands in for "whichever host
        # goes idle next" with a uniform draw.
        host = decision.worker if not decision.deferred \
            else int(self.rng.integers(self.spec.num_servers))
        if self.replication_ctl is not None \
                and not self.replication_ctl.is_alive(host):
            # failover: a dead host cannot serve — retry on the first live
            # replica (or any live host for an all-dead set)
            live = [h for h in locs if self.replication_ctl.is_alive(h)] \
                or [h for h in range(self.spec.num_servers)
                    if self.replication_ctl.is_alive(h)]
            host = live[0]
            self.metrics["failovers"] = self.metrics.get("failovers", 0) + 1
            if self.tracer is not None:
                self.tracer.instant("failover", cat="pipeline",
                                    ts_us=self._clock * CLOCK_UNIT_US,
                                    tid=host, chunk=chunk_id)
        tier = tier_of(self.spec, locs, host)
        rate = float(self.prior[tier])
        rate *= self.slow.get(host, 1.0)
        rate *= self.playback.rate_mult_at(self._clock, host, tier)
        if self.replication_ctl is not None:
            # migration endpoints serve foreground reads at the
            # contention multiplier while a copy is in flight
            rate *= self.replication_ctl.contention_mult(host)
        service = float(self.rng.exponential(1.0 / max(rate, 1e-6)))
        if self.tracer is not None:
            # the read occupies [clock, clock + service) on the host's lane
            self.tracer.complete("chunk_read",
                                 self._clock * CLOCK_UNIT_US,
                                 service * CLOCK_UNIT_US, cat="read",
                                 tid=host, chunk=chunk_id, tier=tier)
        self._clock += service
        self.router.claim(host)  # drain the queued task (read runs now)
        self.router.on_complete(host, tier, service)
        # legacy 3-way counters: "remote" is the last tier (so a 2-tier
        # fleet counts non-local reads as remote, not rack); intermediate
        # tiers (rack, pod, ...) aggregate under "rack"
        key = "local" if tier == 0 else (
            "remote" if tier == self.spec.num_tiers - 1 else "rack")
        self.metrics[key] += 1
        self.metrics["tier_reads"][tier] += 1
        self.metrics["reads"] += 1
        self.metrics["virtual_time"] = self._clock
        self.metrics["host_reads"][host] += 1
        # popularity feedback -> deterministic rebalance on a fixed cadence
        self.placement.note_read(chunk_id)
        if self.cfg.rebalance_every and \
                self.metrics["reads"] % self.cfg.rebalance_every == 0:
            self.metrics["rebalanced"] = self.metrics.get("rebalanced", 0) \
                + self.placement.rebalance()
        return chunk_tokens(self.cfg, chunk_id)

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.cfg.global_batch * (self.cfg.seq_len + 1)
        while self._buffer.size < need:
            chunk_id = int(self._chunk_order[self._cursor
                                             % self.cfg.num_chunks])
            self._cursor += 1
            self._buffer = np.concatenate(
                [self._buffer, self._read_chunk(chunk_id)])
        flat = self._buffer[:need].reshape(self.cfg.global_batch,
                                           self.cfg.seq_len + 1)
        self._buffer = self._buffer[need:]
        return {"tokens": flat[:, :-1].copy(), "labels": flat[:, 1:].copy()}

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict:
        # `reads` drives the rebalance cadence and `placement` carries the
        # popularity state (hot_aware), so a restored pipeline places and
        # rebalances exactly like the uninterrupted run would have.
        out = {"cursor": self._cursor, "buffer": self._buffer.copy(),
               "clock": self._clock, "reads": int(self.metrics["reads"]),
               "placement": self.placement.state_dict()}
        if self.replication_ctl is not None:
            out["replication"] = self.replication_ctl.state_dict()
        return out

    def load_state_dict(self, s: Dict) -> None:
        self._cursor = int(s["cursor"])
        self._buffer = np.asarray(s["buffer"], np.int32)
        self._clock = float(s["clock"])
        # pre-placement checkpoints (no keys) restore as before
        self.metrics["reads"] = int(s.get("reads", self.metrics["reads"]))
        if s.get("placement"):
            self.placement.load_state_dict(s["placement"])
        if s.get("replication"):
            if self.replication_ctl is None:
                raise ValueError("checkpoint carries replication-lifecycle "
                                 "state but this pipeline has no controller "
                                 "configured (replication_policy)")
            self.replication_ctl.load_state_dict(s["replication"])

    @property
    def locality_fractions(self) -> Tuple[float, float, float]:
        r = max(self.metrics["reads"], 1)
        return (self.metrics["local"] / r, self.metrics["rack"] / r,
                self.metrics["remote"] / r)
