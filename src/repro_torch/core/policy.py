"""The two scheduler registries of the port (counterpart of
`repro.core.policy`).

`SlotPolicy` is the discrete-time simulator contract: a policy owns a
fixed-shape tensor state and advances it one slot at a time.  Policies
register themselves with `@register_policy` at their definition site;
`make_policy` resolves a name, a `PolicyConfig` (name + constructor
options) or an instance.  Per-policy constructor options (FIFO's `cap`,
power-of-d's `d`) travel in a `PolicyConfig`; per-policy outputs (FIFO's
drop counter) come back through `extra_metrics`.

`Router` is the host-side (numpy, incremental) contract of the serving
engine: ``route(locals_) -> Decision`` and ``claim(worker) -> Claim``.
Routers register with `@register_router` (`core.cluster` holds the
built-in four); `make_router` builds one by name.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import (Any, Dict, Mapping, Optional, Sequence, Tuple, Type,
                    Union)

import numpy as np
import torch

from repro_torch.core.rng import DrawPlan


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of `Router.route`: where an arriving task went.

    worker   -- assigned worker id, or -1 when assignment is deferred
    tier     -- locality tier (0 local .. K-1 remote) at the assigned
                worker, or -1 when deferred / unknown at routing time
    deferred -- True when the router queues globally and picks the worker
                only at claim time (e.g. FIFO)
    """

    worker: int
    tier: int = -1
    deferred: bool = False


@dataclasses.dataclass(frozen=True)
class Claim:
    """Outcome of `Router.claim`: what an idle worker just pulled.

    source -- index of the queue the task came from: a worker id for
              per-worker-queue routers (the claimer's own queue, or another
              worker's under MaxWeight work stealing), or -1 for a global
              queue (FIFO)
    tier   -- the router's belief of the service tier for this claim, or -1
              when it cannot know (global queue: depends on the task)
    """

    source: int
    tier: int = -1


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Name + per-policy constructor options, e.g.
    ``PolicyConfig("pandas_po2", {"d": 4})``."""

    name: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


PolicyLike = Union[str, PolicyConfig, "SlotPolicy"]


class SlotPolicy(abc.ABC):
    """One scheduling algorithm as seen by the discrete-time simulator.

    Implementations are stateless objects over an immutable options set;
    all mutable simulation state lives in the tensors returned by
    `init_state` and threaded through `slot_step` by the simulator.  The
    state carries a leading cell dimension N: one row per (load, error,
    seed) cell of a sweep.
    """

    name: str = ""
    #: whether slot_step accepts a ``server_mask=`` kwarg ((N, M) bool,
    #: True = routable) — the autoscaling seam (`repro_torch.control`):
    #: masked servers take no NEW work but keep draining their queues.
    supports_server_mask: bool = False
    #: whether slot_step accepts a ``signals=`` kwarg of in-loop telemetry
    #: readings (SLO-conditioned policies).  Such policies are the
    #: documented exception to the telemetry-purity invariant: enabling
    #: telemetry deliberately changes their sample path.  Without signals
    #: they must degrade to a signal-free base policy bit for bit.
    uses_signals: bool = False

    @abc.abstractmethod
    def draw_plan(self, num_servers: int) -> DrawPlan:
        """The per-slot random draws `slot_step` consumes (`core.rng`)."""

    @abc.abstractmethod
    def init_state(self, topo, device=None, batch=(), **opts):
        """Fresh fixed-shape state for `topo` on `device`, with leading
        dimensions `batch`."""

    @abc.abstractmethod
    def slot_step(self, state, draws, types: torch.Tensor,
                  active: torch.Tensor, est: torch.Tensor,
                  true_rates: torch.Tensor, ancestors: torch.Tensor,
                  signals=None):
        """One time slot of the dense simulator for N cells: arrivals ->
        completions -> scheduling.

        draws: the slot's `core.rng.DenseDraws`; types/active: the
        (N, B, 3)/(N, B) arrival batch; est: (N, M, K) estimated rates the
        scheduler decides with; true_rates: the rates of the service
        dynamics, (K,), (M, K) or per cell (N, M, K) (the replication
        seam scales them per cell); ancestors: the (depth, M) table;
        signals: the recorder's (N,) readings, given only to a policy
        that `uses_signals` when telemetry is on.  A policy that
        `supports_server_mask` also takes ``server_mask=``, the (N, M)
        routable servers, given only under an autoscaler.  Returns
        (state, completions (N,) int32).
        """

    @abc.abstractmethod
    def num_in_system(self, state) -> torch.Tensor:
        """Tasks present (queued + in service) per cell, integer (N,)."""

    def extra_metrics(self, state) -> Dict[str, torch.Tensor]:
        """Per-policy end-of-run values per cell (e.g. FIFO's drop count);
        merged into the simulator's metrics."""
        return {}

    def telemetry_gauges(self, state) -> Dict[str, torch.Tensor]:
        """Per-slot (N,) float32 gauges for the telemetry time series
        (`repro_torch.telemetry`): queue/occupancy readings off the live
        state, one value per track name and cell.  Pure observation (no
        draw, no state change) and fixed-keyed: the track list is
        resolved once a run.  Default: no per-policy tracks."""
        return {}


class Router(abc.ABC):
    """Incremental host-side scheduler over an abstract worker fleet.

    Uniform constructor: (spec, rates, estimator=None, seed=0).  `spec` is
    the same `locality.Topology` the simulator uses; `rates` is the (K,)
    tier-rate prior, K matching ``spec.num_tiers``.  When an
    `EwmaRateEstimator` is given
    its live (M, K) estimates are used instead (blind mode).  Every
    router accepts and stores the estimator, even rate-oblivious ones —
    observations still flow through `on_complete`, so switching a fleet
    from FIFO to a rate-aware policy needs no re-warming.
    """

    name: str = ""

    def __init__(self, spec, rates: Sequence[float], estimator=None,
                 seed: int = 0):
        self.spec = spec
        self.ancestors = np.asarray(spec.ancestors)  # (depth, M)
        self.num_tiers = spec.num_tiers
        self.prior = np.asarray(rates, np.float32)   # (K,) fastest first
        if self.prior.shape != (self.num_tiers,):
            raise ValueError(
                f"router prior has {self.prior.shape[0]} tier rates but the "
                f"fleet topology has {self.num_tiers} tiers")
        self.estimator = estimator
        self.rng = np.random.default_rng(seed)
        # (M,) bool routable mask (autoscaling seam): masked-out workers
        # receive no NEW work at route time but drain what they hold.
        self.active_mask = np.ones(spec.num_workers, bool)

    # -- estimated rates ----------------------------------------------------
    def _est(self) -> np.ndarray:
        """(M, K) estimated rates (the estimator's if present, else the
        prior's)."""
        if self.estimator is not None:
            return self.estimator.rates
        return np.tile(self.prior, (self.spec.num_workers, 1))

    # -- the uniform surface ------------------------------------------------
    @abc.abstractmethod
    def route(self, locals_: Sequence[int]) -> Decision:
        """Admit one task whose data lives on `locals_`."""

    @abc.abstractmethod
    def claim(self, worker: int) -> Optional[Claim]:
        """Idle `worker` asks for its next task; None when nothing to do."""

    def on_complete(self, worker: int, tier: int, service_time: float) -> None:
        """Feed one observed (worker, tier, service_time) to the estimator."""
        if self.estimator is not None:
            self.estimator.observe(worker, tier, service_time)

    def queue_depths(self) -> np.ndarray:
        """(M,) tasks queued per worker (0s for global-queue routers)."""
        return np.zeros(self.spec.num_workers)

    def set_active(self, mask: Sequence[bool]) -> None:
        """Install the routable-worker mask (autoscaling seam).  At least
        one worker must stay active; routers fall back to the full fleet
        for a task whose every candidate is masked (better a remote
        assignment than a stuck task)."""
        m = np.asarray(mask, bool)
        if m.shape != (self.spec.num_workers,):
            raise ValueError(f"active mask must have shape "
                             f"({self.spec.num_workers},), got {m.shape}")
        if not m.any():
            raise ValueError("active mask must keep at least one worker")
        self.active_mask = m


_POLICIES: Dict[str, Type[SlotPolicy]] = {}
_ROUTERS: Dict[str, Type[Router]] = {}

# Modules that register the built-in policies and routers as an import
# side effect, loaded on first lookup so `policy.py` never imports an
# algorithm module at import time (no cycles).
_BUILTIN_MODULES = (
    "repro_torch.core.balanced_pandas",
    "repro_torch.core.jsq_maxweight",
    "repro_torch.core.priority",
    "repro_torch.core.fifo",
    "repro_torch.core.pandas_po2",
    "repro_torch.core.blind_pandas",
    "repro_torch.core.slo_pandas",
    "repro_torch.core.cluster",
)
_builtins_loaded = False


def _load_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def register_policy(cls: Type[SlotPolicy]) -> Type[SlotPolicy]:
    """Class decorator: add a SlotPolicy to the registry under `cls.name`."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"policy class {cls.__name__} has no `name`")
    if name in _POLICIES:
        raise ValueError(f"duplicate policy registration: {name!r}")
    _POLICIES[name] = cls
    return cls


def register_router(cls: Type[Router]) -> Type[Router]:
    """Class decorator: add a Router to the registry under `cls.name`."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"router class {cls.__name__} has no `name`")
    if name in _ROUTERS:
        raise ValueError(f"duplicate router registration: {name!r}")
    _ROUTERS[name] = cls
    return cls


def available_policies() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_POLICIES))


def available_routers() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_ROUTERS))


def policy_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered `SlotPolicy`,
    from the first sentence of each class docstring — the self-describing
    registry surface behind ``benchmarks/run.py --help``."""
    from repro_torch.utils.doc import first_doc_line
    _load_builtins()
    return {n: first_doc_line(c) for n, c in sorted(_POLICIES.items())}


def router_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered `Router`."""
    from repro_torch.utils.doc import first_doc_line
    _load_builtins()
    return {n: first_doc_line(c) for n, c in sorted(_ROUTERS.items())}


def get_policy_cls(name: str) -> Type[SlotPolicy]:
    _load_builtins()
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; "
                         f"registered: {available_policies()}") from None


def get_router_cls(name: str) -> Type[Router]:
    _load_builtins()
    try:
        return _ROUTERS[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"registered: {available_routers()}") from None


def policy_name(spec: PolicyLike) -> str:
    """The registry name of a policy name / PolicyConfig / instance,
    without instantiating it."""
    if isinstance(spec, str):
        return spec
    return spec.name


def make_policy(spec: PolicyLike) -> SlotPolicy:
    """Resolve a policy name / PolicyConfig / instance to an instance."""
    if isinstance(spec, SlotPolicy):
        return spec
    if isinstance(spec, str):
        spec = PolicyConfig(spec)
    return get_policy_cls(spec.name)(**dict(spec.options))


def make_router(name: str, spec, rates: Sequence[float], estimator=None,
                seed: int = 0, **options) -> Router:
    """Instantiate a registered router with the uniform constructor."""
    return get_router_cls(name)(spec, rates, estimator=estimator, seed=seed,
                                **options)
