"""SlotPolicy registry of the port (counterpart of `repro.core.policy`).

`SlotPolicy` is the discrete-time simulator contract: a policy owns a
fixed-shape tensor state and advances it one slot at a time.  Policies
register themselves with `@register_policy` at their definition site;
`make_policy` resolves a name, a `PolicyConfig` (name + constructor
options) or an instance.  Per-policy constructor options (FIFO's `cap`,
power-of-d's `d`) travel in a `PolicyConfig`; per-policy outputs (FIFO's
drop counter) come back through `extra_metrics`.  The host-side `Router`
half of the reference module comes with the host-fleet slice.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import Any, Dict, Mapping, Tuple, Type, Union

import torch

from repro_torch.core.rng import DrawPlan


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
                  true_rates: torch.Tensor, ancestors: torch.Tensor):
        """One time slot of the dense simulator for N cells: arrivals ->
        completions -> scheduling.

        draws: the slot's `core.rng.DenseDraws`; types/active: the
        (N, B, 3)/(N, B) arrival batch; est: (N, M, K) estimated rates the
        scheduler decides with; true_rates: the (K,) rates of the service
        dynamics; ancestors: the (depth, M) table.  Returns (state,
        completions (N,) int32).
        """

    @abc.abstractmethod
    def num_in_system(self, state) -> torch.Tensor:
        """Tasks present (queued + in service) per cell, integer (N,)."""

    def extra_metrics(self, state) -> Dict[str, torch.Tensor]:
        """Per-policy end-of-run values per cell (e.g. FIFO's drop count);
        merged into the simulator's metrics."""
        return {}


_POLICIES: Dict[str, Type[SlotPolicy]] = {}

# Modules that register the built-in policies as an import side effect,
# loaded on first lookup so `policy.py` never imports an algorithm module
# at import time (no cycles).
_BUILTIN_MODULES = (
    "repro_torch.core.balanced_pandas",
    "repro_torch.core.jsq_maxweight",
    "repro_torch.core.priority",
    "repro_torch.core.fifo",
    "repro_torch.core.pandas_po2",
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


def available_policies() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_POLICIES))


def get_policy_cls(name: str) -> Type[SlotPolicy]:
    _load_builtins()
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; "
                         f"registered: {available_policies()}") from None


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
