"""Replication-lifecycle subsystem: the replica set of every chunk as a
mutable, costed object (counterpart of `repro.replication.lifecycle`; a
copy, with the simulator projection taking the port's tensors).

The paper's locality hierarchy rests on one design fact — "each data
chunk is replicated over 3 servers for increasing availability of data
and decreasing probability of data loss" — but placement (PR 5) only
chooses the *initial* replica sets.  This layer makes the replica map a
living object on both substrates:

  * a `MigrationModel` charges every replica move ``size / rate(tier)``
    slots of occupied bandwidth on source and destination, with the tier
    taken from the K-level `Topology` pair hierarchy (core-switch hops
    cost more than ToR hops, per the paper's network model);
  * a `ReplicationController` decides the *target* replication factor of
    every chunk from liveness and read popularity, and the lifecycle
    machinery closes the gap — wiping replicas on server/rack death,
    re-replicating from survivors under a tunable bandwidth cap (the
    repair-lane budget), and dropping surplus replicas for free;
  * failure/recovery events arrive through the scenario seam
    (``server_loss`` / ``rack_loss`` segments carry ``down_servers`` /
    ``down_racks``), so the dense simulator's slot loop and the host-side
    serving engine replay the *same* incidents.

`@register_replication` mirrors the `@register_policy` /
`@register_placement` registries: controllers are selectable by name
from `simulate`/`sweep`/`replication_study` and the serving engine.  The
``"fixed"`` controller with no failure scenario is the run without
replication bit for bit on both substrates, so the whole subsystem is
opt-in with a zero-cost default.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import (TYPE_CHECKING, Any, Dict, Mapping, Tuple, Type, Union)

import numpy as np

if TYPE_CHECKING:  # annotation-only: core/serve/data import this package
    from repro_torch.core.locality import Topology
    from repro_torch.placement import PlacementPolicy


# ---------------------------------------------------------------------------
# Migration cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MigrationModel:
    """Bandwidth cost of moving one replica across the hierarchy.

    A move of a chunk of ``chunk_size`` (in units of tier-0 service work)
    between servers at pair-tier ``k`` occupies both endpoints for
    ``ceil(chunk_size / rate[k])`` slots — the same strictly decreasing
    `Rates` ladder that prices task service, so a cross-core copy costs
    more than a ToR-local one.  While a server is an endpoint of an
    in-flight move, its foreground TRUE service rates are multiplied by
    ``contention`` (< 1): repair storms contend with traffic.
    """

    chunk_size: float = 8.0
    contention: float = 0.5

    def __post_init__(self):
        if self.chunk_size <= 0.0:
            raise ValueError(f"chunk_size must be > 0, got {self.chunk_size}")
        if not 0.0 < self.contention <= 1.0:
            raise ValueError(f"contention must be in (0, 1], "
                             f"got {self.contention}")

    def cost_table(self, tier_rates) -> np.ndarray:
        """(K,) f32 slots of occupied bandwidth per move, by pair tier."""
        rates = np.asarray(tier_rates, np.float64)
        if rates.ndim != 1 or rates.size == 0 or np.any(rates <= 0.0):
            raise ValueError(f"tier_rates must be positive, got {rates}")
        return np.ceil(self.chunk_size / rates).astype(np.float32)

    def cost(self, tier_rates, tier: int) -> float:
        """Slots to move one replica between endpoints at `tier`."""
        return float(self.cost_table(tier_rates)[int(tier)])


# ---------------------------------------------------------------------------
# Controller contract
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Name + per-controller constructor options, e.g.
    ``ReplicationConfig("repair", {"lanes": 2})`` — the replication
    analogue of `PolicyConfig` / `PlacementConfig`."""

    name: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


ReplicationLike = Union[str, ReplicationConfig, "ReplicationController", None]


class ReplicationController(abc.ABC):
    """One replication rule: a target replica count per chunk, closed by
    the shared lifecycle machinery on both substrates.

    Common options (the lifecycle knobs every controller shares):

    num_chunks     -- catalogue size C tracked by the simulator projection
                      (the host consumers size theirs from their configs)
    lanes          -- max concurrent replica moves: the repair-bandwidth
                      cap.  Storms queue behind it instead of saturating
                      the fabric.
    moves_per_slot -- max moves *started* per slot (host: per observe())
    read_skew      -- Zipf exponent of the simulator's chunk-read
                      popularity (0 = uniform reads); gives popularity-
                      driven controllers a signal to adapt to
    catalogue_seed -- seed for the initial placement map
    chunk_size / contention -- forwarded to `MigrationModel`
    """

    name: str = ""
    #: True when the controller never moves, drops, or widens replicas on
    #: its own — with no failure track the lifecycle machinery is skipped
    #: entirely (a Python-level branch), preserving the sample paths
    #: without replication bit for bit.
    is_static: bool = False

    def __init__(self, num_chunks: int = 64, lanes: int = 4,
                 moves_per_slot: int = 2, read_skew: float = 1.1,
                 catalogue_seed: int = 0, chunk_size: float = 8.0,
                 contention: float = 0.5):
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        if lanes < 1:
            raise ValueError(f"lanes (repair-bandwidth cap) must be >= 1, "
                             f"got {lanes}")
        if moves_per_slot < 1:
            raise ValueError(f"moves_per_slot must be >= 1, "
                             f"got {moves_per_slot}")
        if read_skew < 0.0:
            raise ValueError(f"read_skew must be >= 0, got {read_skew}")
        self.num_chunks = int(num_chunks)
        self.lanes = int(lanes)
        self.moves_per_slot = int(moves_per_slot)
        self.read_skew = float(read_skew)
        self.catalogue_seed = int(catalogue_seed)
        self.migration = MigrationModel(chunk_size, contention)

    # -- target policy -------------------------------------------------------
    def max_target(self, base: int) -> int:
        """Widest replication factor this controller may request — the
        R_max the catalogue pads to."""
        return int(base)

    @abc.abstractmethod
    def sim_targets(self, pop, live, base_tgt):
        """Target replica count per chunk on the simulator substrate.

        ``pop`` (N, C) f32 decayed read counts, ``live`` (N, C) int32
        live replicas of the N cells, ``base_tgt`` (C,) int32 initial
        factors.  A pure tensor function of its inputs, with no read of a
        device value (it runs inside the slot loop)."""

    @abc.abstractmethod
    def host_targets(self, counts: Mapping[int, int], live: np.ndarray,
                     base_tgt: np.ndarray) -> np.ndarray:
        """Target replica count per chunk on the host substrate.

        ``counts`` are cumulative `note_read` observations keyed by chunk
        id; ``live`` / ``base_tgt`` as above (numpy)."""

    # -- substrate projections ----------------------------------------------
    def build_sim(self, topo: "Topology", tier_rates,
                  placement: "PlacementPolicy", device=None):
        """Build the lifecycle machinery for the dense simulator's slot
        loop on `device` (None: the card)."""
        from repro_torch.replication.simproj import SimReplication
        return SimReplication(self, topo, tier_rates, placement, device)

    def build_host(self, spec: "Topology", placement: "PlacementPolicy",
                   num_chunks: int, replication: int, seed: int,
                   tier_rates):
        """Instantiate the host-side lifecycle (serving engine)."""
        from repro_torch.replication.host import HostReplication
        return HostReplication(self, spec, placement, num_chunks,
                               replication, seed, tier_rates)


# ---------------------------------------------------------------------------
# Registry (mirrors core/policy.py and placement/policy.py)
# ---------------------------------------------------------------------------

_REPLICATIONS: Dict[str, Type[ReplicationController]] = {}
_BUILTIN_MODULES = ("repro_torch.replication.controllers",)
_builtins_loaded = False


def _load_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def register_replication(cls: Type[ReplicationController]
                         ) -> Type[ReplicationController]:
    """Class decorator: add a ReplicationController under `cls.name`."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"replication class {cls.__name__} has no `name`")
    if name in _REPLICATIONS:
        raise ValueError(f"duplicate replication registration: {name!r}")
    _REPLICATIONS[name] = cls
    return cls


def available_replications() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_REPLICATIONS))


def replication_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered controller,
    from the first sentence of each class docstring — the self-describing
    registry surface behind ``benchmarks/run.py --help``."""
    from repro_torch.utils.doc import first_doc_line
    _load_builtins()
    return {n: first_doc_line(c) for n, c in sorted(_REPLICATIONS.items())}


def get_replication_cls(name: str) -> Type[ReplicationController]:
    _load_builtins()
    try:
        return _REPLICATIONS[name]
    except KeyError:
        raise ValueError(f"unknown replication {name!r}; "
                         f"registered: {available_replications()}") from None


def make_replication(spec: ReplicationLike, **options
                     ) -> ReplicationController:
    """Resolve a name / ReplicationConfig / instance; None -> "fixed"."""
    if spec is None:
        spec = "fixed"
    if isinstance(spec, ReplicationController):
        if options:
            raise ValueError("options only apply when building by name")
        return spec
    if isinstance(spec, ReplicationConfig):
        if options:
            raise ValueError("options only apply when building by name")
        spec, options = spec.name, dict(spec.options)
    return get_replication_cls(spec)(**options)
