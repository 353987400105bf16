"""Replica-placement subsystem: where chunk replicas live on the hierarchy
(counterpart of `repro.placement.policy`; a copy, with the simulator
projection rewritten for the port's draw seam).

A `PlacementPolicy` projects one placement rule onto both substrates:

  * **dense simulator** -- `build_sampler(topo, device)` compiles the rule
    into a per-task replica sampling distribution: a function
    ``sample(u_hot, g_type, p_hot, hot_rack=0, rack_weights=None,
    g_rack=None, g_place=None) -> (..., B, NUM_REPLICAS) int32``, sorted
    per row, with fixed shapes and no read of a device value.  It takes
    the numbers of the draw seam (`core.rng.DenseDraws`) where the
    reference takes a key: ``u_hot`` (..., B) hot uniforms, ``g_type``
    (..., B, M) the type Gumbels uniform draws from, ``g_rack``
    (..., B, R) the rack Gumbels of a schedule with per-rack weights, and
    ``g_place`` (..., P, B, M) the ``P = gumbel_blocks(topo)`` Gumbel
    blocks a placement draws besides them;
  * **host fleet** -- `replicas(spec, chunk_id, replication, seed)`
    deterministically places one chunk on the serving engine's fleet, and
    `placement_map(spec, num_chunks, replication, seed)` materializes the
    whole catalogue as a padded ``(C, R_max)`` id array plus a
    ``(C, R_max)`` bool mask.

`@register_placement` makes a class selectable by name from
`simulate`/`sweep`/`placement_study` and the serving engine.  The
``"uniform"`` policy is the run without a placement, bit for bit.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Mapping,
                    Tuple, Type, Union)

import numpy as np
import torch

if TYPE_CHECKING:  # annotation-only: `core` imports this package
    from repro_torch.core.locality import Topology

# The compiled simulator projection: sample(u_hot, g_type, p_hot,
# hot_rack=0, rack_weights=None, g_rack=None, g_place=None)
# -> (..., B, NUM_REPLICAS) int32, sorted per row.
TypeSampler = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Name + per-policy constructor options, e.g.
    ``PlacementConfig("hot_aware", {"r_hot": 6})`` — the placement
    analogue of `PolicyConfig`."""

    name: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


PlacementLike = Union[str, PlacementConfig, "PlacementPolicy", None]


class PlacementPolicy(abc.ABC):
    """One replica-placement rule, projected onto both substrates.

    Implementations are stateless w.r.t. the simulator (the compiled
    sampler is a pure function of the topology) but may carry host-side
    popularity state for deterministic rebalancing (`hot_aware`).
    """

    name: str = ""

    # -- dense simulator projection ------------------------------------------
    @abc.abstractmethod
    def build_sampler(self, topo: Topology, device=None) -> TypeSampler:
        """Compile this placement against `topo` on `device` (None: the
        card) into a per-task replica sampling distribution (see the
        module docstring for its signature)."""

    def gumbel_blocks(self, topo: Topology) -> int:
        """How many (B, M) Gumbel blocks the sampler reads from
        ``g_place`` besides the uniform draw's (0: none).  A Python-level
        fact of the topology, fixed when the draw source is built."""
        return 0

    # -- host projection -----------------------------------------------------
    @abc.abstractmethod
    def replicas(self, spec: Topology, chunk_id: int, replication: int,
                 seed: int) -> List[int]:
        """Sorted host ids holding `chunk_id` (length >= `replication` for
        policies that widen popular chunks; deterministic in all args)."""

    def max_replication(self, replication: int) -> int:
        """Upper bound over chunks — the R_max the placement map pads to."""
        return replication

    def placement_map(self, spec: Topology, num_chunks: int,
                      replication: int, seed: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize the whole catalogue: ``(ids, mask)`` with ids
        ``(C, R_max) int32`` (pad slots hold the row's first replica so
        every entry is a valid host id) and mask ``(C, R_max) bool``."""
        r_max = self.max_replication(replication)
        ids = np.zeros((num_chunks, r_max), np.int32)
        mask = np.zeros((num_chunks, r_max), bool)
        for c in range(num_chunks):
            locs = self.replicas(spec, c, replication, seed)
            ids[c, :len(locs)] = locs
            ids[c, len(locs):] = locs[0]
            mask[c, :len(locs)] = True
        return ids, mask

    # -- popularity feedback (optional) --------------------------------------
    def note_read(self, chunk_id: int) -> None:
        """Popularity feedback from the host consumers (no-op by default)."""

    def rebalance(self) -> int:
        """Deterministically re-derive any popularity-driven placement from
        the counts observed so far; returns the number of chunks whose
        placement changed (0 for static policies)."""
        return 0

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe popularity state ({} for stateless policies)."""
        return {}

    def load_state_dict(self, s: Mapping[str, Any]) -> None:
        if s:
            raise ValueError(f"{self.name!r} placement carries no state, "
                             f"got {dict(s)}")


# ---------------------------------------------------------------------------
# Registry (mirrors core/policy.py)
# ---------------------------------------------------------------------------

_PLACEMENTS: Dict[str, Type[PlacementPolicy]] = {}
_BUILTIN_MODULES = ("repro_torch.placement.policies",)
_builtins_loaded = False


def _load_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def register_placement(cls: Type[PlacementPolicy]) -> Type[PlacementPolicy]:
    """Class decorator: add a PlacementPolicy under `cls.name`."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"placement class {cls.__name__} has no `name`")
    if name in _PLACEMENTS:
        raise ValueError(f"duplicate placement registration: {name!r}")
    _PLACEMENTS[name] = cls
    return cls


def available_placements() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_PLACEMENTS))


def placement_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered placement,
    from the first sentence of each class docstring."""
    from repro_torch.utils.doc import first_doc_line
    _load_builtins()
    return {n: first_doc_line(c) for n, c in sorted(_PLACEMENTS.items())}


def get_placement_cls(name: str) -> Type[PlacementPolicy]:
    _load_builtins()
    try:
        return _PLACEMENTS[name]
    except KeyError:
        raise ValueError(f"unknown placement {name!r}; "
                         f"registered: {available_placements()}") from None


def make_placement(spec: PlacementLike, **options) -> PlacementPolicy:
    """Resolve a name / PlacementConfig / instance; None -> "uniform"."""
    if spec is None:
        spec = "uniform"
    if isinstance(spec, PlacementPolicy):
        if options:
            raise ValueError("options only apply when building by name")
        return spec
    if isinstance(spec, PlacementConfig):
        if options:
            raise ValueError("options only apply when building by name")
        spec, options = spec.name, dict(spec.options)
    return get_placement_cls(spec)(**options)
