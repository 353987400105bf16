"""Control-plane contract and registry: load generation, admission control
and autoscaling as composable controllers (counterpart of
`repro.control.plane`; a copy, with the simulator projection taking the
port's tensors).

A `Controller` is one closed-loop actuator with a declared ``kind``:

  * ``loadgen``   -- shapes the offered traffic itself: ``open_loop``
                     replays the scenario's rate track untouched,
                     ``closed_loop`` gates arrivals on completions
                     (N think-time users, the load-tester model);
  * ``admission`` -- sheds or defers arrivals *before* routing
                     (``token_bucket``, ``queue_threshold``);
  * ``autoscale`` -- grows/shrinks the serving fleet mid-run on the
                     Topology seam (``autoscale``).

Every controller projects onto both substrates: a fixed-shape projection
batched over the cells of a sweep (`repro_torch.control.simproj`),
threaded through the dense simulator's carry, and a host-clock projection
(`repro_torch.control.host`) for the serving engine.  Controllers
compose: ``control=`` on `simulate`/`sweep`/`EngineConfig` accepts one
controller or a sequence (at most one per kind), which is how the SLO
study builds its {no control, admission only, autoscale only, both}
arms.

With ``control=None`` (the default) nothing is built: the simulator step
is the one without a control plane and every sample path stays bit for
bit.  Registration mirrors the policy, placement and replication
registries: `@register_controller`, `ControlConfig`, `make_controller`,
`controller_descriptions`.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Type, Union

import numpy as np

KINDS = ("loadgen", "admission", "autoscale")


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Name + per-controller constructor options, e.g.
    ``ControlConfig("token_bucket", {"rate": 3.0, "burst": 24})`` — the
    control analogue of `PolicyConfig`."""

    name: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class Controller(abc.ABC):
    """One control-plane actuator (see module docstring for the kinds).

    Subclasses declare ``name`` (registry key) and ``kind`` and implement
    the hook surface of their kind: the simulator projection calls the
    ``sim_*`` hooks once a slot on (N,) tensors, one entry a cell, the
    host projection the ``host_*`` hooks on the engine's step clock.
    Controllers are stateless objects over immutable options; all mutable
    state lives in the simulator's carry (`simproj.CtlState`) or the
    host-side objects they build.
    """

    name: str = ""
    kind: str = ""


class LoadGenController(Controller):
    """Base for ``kind == "loadgen"``: shapes the offered arrival rate."""

    kind = "loadgen"

    @abc.abstractmethod
    def sim_offered(self, in_flight, lam_total, knobs):
        """The slot's offered rate per cell -> (lam, cap).

        ``in_flight`` is the (N,) int32 tasks in system, ``lam_total`` the
        (N,) float32 configured base rates, ``knobs`` the scenario's
        `SlotKnobs`.  ``cap`` bounds the admitted arrivals this slot ((N,)
        int32) or is None for no bound (open loop)."""

    def host_clients(self, seed: int = 0):
        """Host projection: a closed-loop client pool driving request
        submission (`repro_torch.control.host.ClosedLoopClients`), or None
        for open loop."""
        return None


class AdmissionController(Controller):
    """Base for ``kind == "admission"``: shed/defer arrivals pre-routing."""

    kind = "admission"

    #: whether this controller can re-admit deferred arrivals later
    defers: bool = False

    def sim_init(self) -> Tuple[float, float]:
        """Initial (tokens, backlog) carry values."""
        return 0.0, 0.0

    @abc.abstractmethod
    def sim_admit(self, tokens, backlog, n_arr, n_sys, spare):
        """One slot of admission, every argument and result (N,).

        n_arr  -- candidate arrivals this slot (int32)
        n_sys  -- tasks in system before this slot (int32)
        spare  -- free arrival lanes available for re-admitting deferred
                  work (int32; the fixed-shape batch minus n_arr)
        Returns (tokens, backlog, n_admit, n_release, n_shed): admit the
        first ``n_admit`` of the candidates, re-activate ``n_release``
        deferred arrivals, shed ``n_shed`` outright."""

    @abc.abstractmethod
    def host_admit(self, state: dict, step: int, n_sys: int) -> bool:
        """Host projection: admit one request arriving at ``step`` with
        ``n_sys`` requests currently in the system.  ``state`` is the
        mutable per-run dict initialized by `host_init`."""

    def host_init(self) -> dict:
        return {"tokens": 0.0, "last_step": None}


class AutoscaleController(Controller):
    """Base for ``kind == "autoscale"``: grow/shrink the active fleet."""

    kind = "autoscale"

    @abc.abstractmethod
    def sim_target(self, lam_eff, num_servers: int, rate0: float):
        """(N,) int32 active-server count for a slot offering the (N,)
        ``lam_eff`` tasks/slot, given the fleet size and the tier-0
        (local) service rate — the planned projection (the scenario's
        rate track is known ahead of time)."""

    @abc.abstractmethod
    def host_autoscaler(self, num_servers: int, min_servers: int):
        """Host projection: a reactive `launch.elastic.Autoscaler` driven
        by the engine's measured sojourn p95 (hysteresis + cooldown)."""


_OneController = Union[str, ControlConfig, Controller, Mapping[str, Any]]
ControlLike = Union[None, _OneController, Sequence[_OneController]]


# ---------------------------------------------------------------------------
# Registry (mirrors core/policy.py / replication/lifecycle.py)
# ---------------------------------------------------------------------------

_CONTROLLERS: Dict[str, Type[Controller]] = {}
_BUILTIN_MODULES = ("repro_torch.control.controllers",)
_builtins_loaded = False


def _load_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def register_controller(cls: Type[Controller]) -> Type[Controller]:
    """Class decorator: add a Controller to the registry under
    ``cls.name``."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"controller class {cls.__name__} has no `name`")
    if getattr(cls, "kind", "") not in KINDS:
        raise ValueError(f"controller {name!r} has kind "
                         f"{getattr(cls, 'kind', '')!r}; must be one of "
                         f"{KINDS}")
    if name in _CONTROLLERS:
        raise ValueError(f"duplicate controller registration: {name!r}")
    _CONTROLLERS[name] = cls
    return cls


def available_controllers() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_CONTROLLERS))


def controller_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered controller,
    from the first sentence of each class docstring."""
    from repro_torch.utils.doc import first_doc_line
    _load_builtins()
    return {n: f"[{c.kind}] {first_doc_line(c)}"
            for n, c in sorted(_CONTROLLERS.items())}


def get_controller_cls(name: str) -> Type[Controller]:
    _load_builtins()
    try:
        return _CONTROLLERS[name]
    except KeyError:
        raise ValueError(f"unknown controller {name!r}; "
                         f"registered: {available_controllers()}") from None


def make_controller(spec: _OneController) -> Controller:
    """Resolve a name / ControlConfig / mapping / instance to a
    Controller (mappings are ``{"name": ..., "options": {...}}``, the
    JSON-friendly spelling)."""
    if isinstance(spec, Controller):
        return spec
    if isinstance(spec, str):
        spec = ControlConfig(spec)
    elif isinstance(spec, Mapping):
        spec = ControlConfig(**spec)
    if not isinstance(spec, ControlConfig):
        raise TypeError(f"cannot resolve a controller from {spec!r}")
    return get_controller_cls(spec.name)(**dict(spec.options))


# ---------------------------------------------------------------------------
# The composed plane
# ---------------------------------------------------------------------------


class ControlPlane:
    """A stack of controllers, at most one per kind, resolved from the
    ``control=`` seam.  Holds no mutable state — it is the description
    both projections are built from."""

    def __init__(self, controllers: Sequence[Controller]):
        if not controllers:
            raise ValueError("a control plane needs at least one controller")
        self.by_kind: Dict[str, Controller] = {}
        for c in controllers:
            if c.kind in self.by_kind:
                raise ValueError(
                    f"duplicate {c.kind!r} controllers in one control "
                    f"plane: {self.by_kind[c.kind].name!r} and {c.name!r}")
            self.by_kind[c.kind] = c

    @property
    def loadgen(self) -> Optional[LoadGenController]:
        return self.by_kind.get("loadgen")

    @property
    def admission(self) -> Optional[AdmissionController]:
        return self.by_kind.get("admission")

    @property
    def autoscale(self) -> Optional[AutoscaleController]:
        return self.by_kind.get("autoscale")

    def describe(self) -> str:
        return "+".join(f"{c.name}" for _, c in sorted(self.by_kind.items()))

    def build_sim(self, topo, cfg, sched, rate0: float, device=None):
        """The dense simulator's projection (`repro_torch.control.simproj`)
        on `device`."""
        from repro_torch.control.simproj import SimControl
        return SimControl(self, topo, cfg, sched, rate0, device)

    def build_host(self, spec, rate0: float, seed: int = 0):
        """Host-clock projection (`repro_torch.control.host`) for the
        serving engine."""
        from repro_torch.control.host import HostControl
        return HostControl(self, spec, rate0, seed=seed)


def resolve_control(spec: ControlLike) -> Optional[ControlPlane]:
    """The ``control=`` seam: None -> None (nothing is built); a name /
    config / instance -> a one-controller plane; a sequence -> a composed
    plane (one per kind)."""
    if spec is None:
        return None
    if isinstance(spec, ControlPlane):
        return spec
    if isinstance(spec, (str, ControlConfig, Controller, Mapping)):
        return ControlPlane([make_controller(spec)])
    if isinstance(spec, Sequence):
        return ControlPlane([make_controller(s) for s in spec])
    raise TypeError(f"control must be None, a controller name/config/"
                    f"instance, or a sequence of them; got {spec!r}")


def scale_priority(topo) -> np.ndarray:
    """(M,) descale rank per server: rank r is the r-th server kept when
    the fleet shrinks.  Servers are ranked round-robin across racks
    (position-within-rack major, rack minor), so any prefix of the order
    spans the racks as evenly as possible — the locality-aware descale
    order (a shrunken fleet keeps replica-holding racks reachable rather
    than evacuating whole racks first)."""
    rack_of = np.asarray(topo.rack_of)
    pos = np.zeros_like(rack_of)
    seen: Dict[int, int] = {}
    for i, r in enumerate(rack_of):
        pos[i] = seen.get(int(r), 0)
        seen[int(r)] = pos[i] + 1
    order = np.lexsort((rack_of, pos))  # sort by (pos, rack)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank.astype(np.int32)
