"""Declarative time-varying workload scenarios (port of
`repro.workloads.scenario`).

A `Scenario` is a piecewise-constant schedule over *normalized* run time
``[0, 1)`` of every workload knob: the arrival-rate multiplier
(``lam_mult``), the locality knobs (``p_hot``, ``hot_rack``,
``rack_weights``), and faults in the *true* service rates (per-server
``slow_servers``, per-tier ``tier_mult``), plus the failure track
(``down_servers``, ``down_racks``) and the closed-loop ``users_mult``.
The declarative pieces, the registry, `_dense_segments`,
`mean_lam_mult_over` and the host projection are numpy copies of the
reference's.

One scenario feeds every layer through two projections:

  * `compile_schedule` -- the per-segment tracks as tensors on an explicit
    device (`Schedule`), plus the segment in force at every slot of the
    horizon, ``seg`` (horizon,), computed once on the host and kept on the
    device.  `slot_knobs(schedule, t)` gathers slot `t`'s knobs with
    `index_select` on ``seg[t:t+1]``: no read of a device value, so the
    simulator's slot loop stays free of host syncs.  ``knots`` stays
    numpy, so host code finds a slot's segment without touching the
    device;
  * `host_playback` -- the same segments as numpy arrays (`HostPlayback`)
    for the serving engine (time-varying replica slowdowns) and
    `arrival_steps` (arrival-time modulation).

Scenarios are registered by name with `@register_scenario`; the builtins
live in `repro_torch.workloads.library` (synthetic) and
`repro_torch.workloads.trace` (recorded traces).  The ``"static"``
scenario is the identity: compiled, it multiplies every knob by 1.0, and
the simulator's sample paths equal the run without a scenario bit for
bit.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.utils.doc import first_doc_line

# ---------------------------------------------------------------------------
# Declarative pieces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    """One piecewise-constant span of a scenario, starting at fraction
    ``start`` of the run and lasting until the next segment (or the end).

    lam_mult     -- arrival-rate multiplier applied to the configured load
    p_hot        -- absolute hot-traffic fraction; None keeps the config's
    hot_rack     -- rack receiving the hot traffic (mod num_racks at compile)
    rack_weights -- per-rack arrival weights for the skewed traffic: hot
                    tasks draw their rack from this vector instead of the
                    single ``hot_rack`` (resized to the topology's rack
                    count at compile: truncated or cycled).  None keeps
                    the classic one-hot hot_rack behaviour — and the
                    bitwise static sample path.
    tier_mult    -- per-tier multipliers on the TRUE rates: network faults
                    (rack-switch congestion sags the non-local tiers).
                    Three values are the classic (local, rack, remote)
                    spelling — on a deeper topology the remote multiplier
                    extends to every tier past the rack; a K-length tuple
                    addresses each tier exactly.
    slow_servers -- {server_id: rate_mult} per-server TRUE-rate multipliers
                    (straggler windows; ids taken mod fleet size at compile)
    down_servers -- server ids DEAD during this segment: rate 0, replicas
                    wiped (ids taken mod fleet size at compile).  Death is a
                    separate track from slow_servers because a dead server
                    loses its data — stragglers only serve it slowly.
    down_racks   -- rack ids whose every server is dead during this segment
                    (ids taken mod rack count at compile; resolved through
                    the topology's ``rack_of`` map)
    users_mult   -- multiplier on the closed-loop user population
                    (`repro.control`'s ``closed_loop`` load generator) —
                    the closed-loop analogue of ``lam_mult``.  Ignored by
                    open-loop runs, so the default 1.0 keeps every
                    pre-control schedule bitwise (the track is only
                    materialized when some segment moves it).
    """

    start: float
    lam_mult: float = 1.0
    p_hot: Optional[float] = None
    hot_rack: int = 0
    tier_mult: Tuple[float, ...] = (1.0, 1.0, 1.0)
    slow_servers: Mapping[int, float] = dataclasses.field(default_factory=dict)
    rack_weights: Optional[Tuple[float, ...]] = None
    down_servers: Tuple[int, ...] = ()
    down_racks: Tuple[int, ...] = ()
    users_mult: float = 1.0

    def __post_init__(self):
        if not 0.0 <= self.start < 1.0:
            raise ValueError(f"segment start must be in [0, 1), got {self.start}")
        if self.lam_mult < 0.0:
            raise ValueError(f"lam_mult must be >= 0, got {self.lam_mult}")
        if self.p_hot is not None and not 0.0 <= self.p_hot <= 1.0:
            raise ValueError(f"p_hot must be in [0, 1], got {self.p_hot}")
        if self.hot_rack < 0:
            raise ValueError(f"hot_rack must be >= 0, got {self.hot_rack}")
        if len(self.tier_mult) < 2 or any(m <= 0.0 for m in self.tier_mult):
            raise ValueError(f"tier_mult must be >= 2 positive values, "
                             f"got {self.tier_mult}")
        if any(v <= 0.0 for v in self.slow_servers.values()):
            raise ValueError(f"slow_servers multipliers must be > 0, "
                             f"got {dict(self.slow_servers)}")
        if self.rack_weights is not None:
            w = tuple(float(x) for x in self.rack_weights)
            if not w or any(x < 0.0 for x in w) or sum(w) <= 0.0:
                raise ValueError(f"rack_weights must be non-negative with a "
                                 f"positive sum, got {self.rack_weights}")
            object.__setattr__(self, "rack_weights", w)
        for field in ("down_servers", "down_racks"):
            ids = getattr(self, field)
            if any(not isinstance(i, numbers.Integral) or i < 0 for i in ids):
                raise ValueError(f"{field} must be non-negative server/rack "
                                 f"ids, got {ids}")
            object.__setattr__(self, field, tuple(int(i) for i in ids))
        if self.users_mult < 0.0:
            raise ValueError(f"users_mult must be >= 0, got {self.users_mult}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, ordered tuple of `Segment`s covering [0, 1)."""

    name: str
    segments: Tuple[Segment, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("scenario needs at least one segment")
        starts = [s.start for s in self.segments]
        if starts[0] != 0.0:
            raise ValueError(f"first segment must start at 0.0, got {starts[0]}")
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError(f"segment starts must strictly increase: {starts}")

    @property
    def mean_lam_mult(self) -> float:
        """Time-average arrival multiplier over [0, 1) — the factor relating
        the configured base load to the effective offered load."""
        starts = [s.start for s in self.segments] + [1.0]
        return float(sum(s.lam_mult * (b - a) for s, a, b in
                         zip(self.segments, starts, starts[1:])))


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Name + builder options, e.g. ``ScenarioConfig("stragglers",
    {"factor": 0.2})`` — the scenario analogue of `PolicyConfig`."""

    name: str
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


ScenarioLike = Union[str, ScenarioConfig, Scenario, None]


# ---------------------------------------------------------------------------
# Registry (mirrors core/policy.py)
# ---------------------------------------------------------------------------

_SCENARIOS: Dict[str, Callable[..., Scenario]] = {}
_BUILTIN_MODULES = ("repro_torch.workloads.library",
                    "repro_torch.workloads.trace")
_builtins_loaded = False


def _load_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    import importlib
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    _builtins_loaded = True


def register_scenario(name: str):
    """Decorator: register ``builder(**options) -> Scenario`` under `name`."""
    def deco(builder: Callable[..., Scenario]):
        if name in _SCENARIOS:
            raise ValueError(f"duplicate scenario registration: {name!r}")
        _SCENARIOS[name] = builder
        builder.scenario_name = name  # type: ignore[attr-defined]
        return builder
    return deco


def available_scenarios() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_SCENARIOS))


def scenario_descriptions() -> Dict[str, str]:
    """``{name: one-line description}`` for every registered scenario,
    taken from the first sentence of each builder's docstring — the
    self-describing registry surface behind ``benchmarks/run.py --help``."""
    _load_builtins()
    return {name: first_doc_line(builder)
            for name, builder in sorted(_SCENARIOS.items())}


def make_scenario(spec: ScenarioLike, **options) -> Scenario:
    """Resolve a name / ScenarioConfig / Scenario instance; None -> static."""
    if spec is None:
        spec = "static"
    if isinstance(spec, Scenario):
        if options:
            raise ValueError("options only apply when building by name")
        return spec
    if isinstance(spec, ScenarioConfig):
        if options:
            raise ValueError("options only apply when building by name")
        spec, options = spec.name, dict(spec.options)
    _load_builtins()
    try:
        builder = _SCENARIOS[spec]
    except KeyError:
        raise ValueError(f"unknown scenario {spec!r}; "
                         f"registered: {available_scenarios()}") from None
    return builder(**options)


# ---------------------------------------------------------------------------
# Dense materialization shared by both projections
# ---------------------------------------------------------------------------


def _expand_tier_mult(tm: Sequence[float], num_tiers: int) -> Tuple[float, ...]:
    """Map a segment's tier_mult onto K tiers: exact when lengths match;
    the classic 3-tuple extends its remote multiplier to every tier past
    the rack (DCN congestion hits everything beyond the rack switch) and
    drops the rack entry on a 2-tier fleet."""
    tm = tuple(float(x) for x in tm)
    if len(tm) == num_tiers:
        return tm
    if len(tm) == 3:
        if num_tiers > 3:
            return tm[:2] + (tm[2],) * (num_tiers - 2)
        if num_tiers == 2:
            return (tm[0], tm[2])
    raise ValueError(f"tier_mult {tm} does not fit a {num_tiers}-tier "
                     f"topology (pass 3 or exactly {num_tiers} values)")


def _resize_weights(w: Sequence[float], num_racks: int) -> Tuple[float, ...]:
    """Fit a segment's rack_weights to the compiled rack count: truncate a
    longer vector, cycle a shorter one (mirroring hot_rack's mod wrap)."""
    w = tuple(float(x) for x in w)
    out = tuple(w[i % len(w)] for i in range(num_racks))
    if sum(out) <= 0.0:
        raise ValueError(f"rack_weights {w} are all zero over the first "
                         f"{num_racks} racks")
    return out


def _dense_segments(scn: Scenario, num_workers: int, num_racks: int,
                    base_p_hot: float, num_tiers: int = 3,
                    materialize_weights: bool = True, rack_of=None):
    """Numpy per-segment arrays:
    (starts, lam, p_hot, hot_rack, tier, server, rack_weights, alive).

    starts are fractions in [0, 1); tier is (S, K); server is (S, M);
    rack_weights is (S, R) — or None when no segment opts into per-rack
    weights (the bitwise-pinned classic hot_rack path) or the caller
    does not consume the locality knobs (`materialize_weights=False`,
    the host projection — weights must not be resized/validated against
    a rack count the host side does not have).  alive is (S, M) bool —
    or None when no segment declares failures (a compile-time fact both
    projections branch on in Python, keeping the failure-free paths
    bitwise identical to the pre-replication code).  ``down_racks``
    resolve through ``rack_of`` (server -> rack map); scenarios that use
    them require the caller to supply it.
    """
    s_count = len(scn.segments)
    starts = np.array([s.start for s in scn.segments], np.float64)
    lam = np.array([s.lam_mult for s in scn.segments], np.float32)
    p_hot = np.array([base_p_hot if s.p_hot is None else s.p_hot
                      for s in scn.segments], np.float32)
    hot = np.array([s.hot_rack % max(num_racks, 1) for s in scn.segments],
                   np.int32)
    tier = np.array([_expand_tier_mult(s.tier_mult, num_tiers)
                     for s in scn.segments], np.float32)
    server = np.ones((s_count, num_workers), np.float32)
    for i, seg in enumerate(scn.segments):
        for sid, mult in seg.slow_servers.items():
            server[i, sid % num_workers] = mult
    if not materialize_weights or \
            all(s.rack_weights is None for s in scn.segments):
        weights = None
    else:
        # segments without explicit weights keep their hot_rack as one-hot
        weights = np.zeros((s_count, max(num_racks, 1)), np.float32)
        for i, seg in enumerate(scn.segments):
            if seg.rack_weights is None:
                weights[i, hot[i]] = 1.0
            else:
                weights[i] = _resize_weights(seg.rack_weights,
                                             max(num_racks, 1))
    if all(not s.down_servers and not s.down_racks for s in scn.segments):
        alive = None
    else:
        alive = np.ones((s_count, num_workers), bool)
        for i, seg in enumerate(scn.segments):
            for sid in seg.down_servers:
                alive[i, sid % num_workers] = False
            if seg.down_racks:
                if rack_of is None:
                    raise ValueError(
                        "scenario uses down_racks but this consumer did not "
                        "supply a server->rack map; pass rack_of= (e.g. the "
                        "topology's rack_of) to resolve rack failures")
                rk = np.asarray(rack_of)
                if rk.shape != (num_workers,):
                    raise ValueError(f"rack_of must have shape "
                                     f"({num_workers},), got {rk.shape}")
                n_racks = int(rk.max()) + 1
                for rid in seg.down_racks:
                    alive[i, rk == rid % n_racks] = False
            if not alive[i].any():
                raise ValueError(
                    f"segment {i} of scenario {scn.name!r} kills every "
                    f"server — at least one must survive")
    return starts, lam, p_hot, hot, tier, server, weights, alive


# ---------------------------------------------------------------------------
# Device projection: per-segment tracks + the segment of every slot
# ---------------------------------------------------------------------------


class Schedule(NamedTuple):
    """Compiled scenario: per-segment tracks on one device, gathered per
    slot by `slot_knobs`.  Shapes are fixed per scenario (S segments, M
    servers, K tiers, R racks) and shared by every cell of a batch.
    ``rack_weights`` is None unless some segment opts into per-rack
    arrival weights, ``alive`` None unless some segment declares failures,
    ``users_mult`` None unless some segment moves it: Python-level facts,
    so the paths without them stay as they were."""

    knots: np.ndarray          # (S,) int32 first slot of each segment (host)
    lam_mult: torch.Tensor     # (S,) f32 arrival-rate multiplier
    p_hot: torch.Tensor        # (S,) f32 absolute hot fraction
    hot_rack: torch.Tensor     # (S,) int32 rack receiving hot traffic
    rate_mult: torch.Tensor    # (S, M, K) f32 TRUE-rate multiplier
    seg: torch.Tensor          # (horizon,) int64 segment in force per slot
    rack_weights: Optional[torch.Tensor] = None  # (S, R) f32
    alive: Optional[torch.Tensor] = None         # (S, M) f32 1 alive, 0 dead
    users_mult: Optional[torch.Tensor] = None    # (S,) f32

    @property
    def num_segments(self) -> int:
        return len(self.knots)


class SlotKnobs(NamedTuple):
    """The scenario knobs in force during one slot (device tensors)."""

    lam_mult: torch.Tensor     # () f32
    p_hot: torch.Tensor        # () f32
    hot_rack: torch.Tensor     # () int32
    rate_mult: torch.Tensor    # (M, K) f32
    rack_weights: Optional[torch.Tensor] = None  # (R,) f32
    alive: Optional[torch.Tensor] = None         # (M,) f32
    users_mult: Optional[torch.Tensor] = None    # () f32


def _users_track(scn: Scenario) -> Optional[np.ndarray]:
    """(S,) closed-loop user-population multipliers, or None when every
    segment keeps the default 1.0."""
    if all(s.users_mult == 1.0 for s in scn.segments):
        return None
    return np.array([s.users_mult for s in scn.segments], np.float32)


def compile_schedule(scn: Scenario, topo, horizon: int, base_p_hot: float,
                     device=None) -> Schedule:
    """Compile a scenario against a `Topology` and a slot horizon onto
    `device` (None: the card).  The topology fixes the rack count
    (hot_rack wrap, rack_weights width) and the tier count K of the
    rate-multiplier track.  The tracks equal the reference's
    `compile_schedule` element for element."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    starts, lam, p_hot, hot, tier, server, weights, alive = _dense_segments(
        scn, topo.num_servers, topo.num_racks, base_p_hot,
        num_tiers=topo.num_tiers, rack_of=np.asarray(topo.rack_of))
    knots = np.floor(starts * horizon).astype(np.int32)
    knots[0] = 0
    rate = server[:, :, None] * tier[:, None, :]  # (S, M, K) f32
    # side="right": with duplicate knots the LAST matching segment wins
    seg = np.searchsorted(knots, np.arange(horizon), side="right") - 1
    users = _users_track(scn)

    def dev_t(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    return Schedule(
        knots=knots, lam_mult=dev_t(lam), p_hot=dev_t(p_hot),
        hot_rack=dev_t(hot), rate_mult=dev_t(rate),
        seg=dev_t(seg.astype(np.int64)),
        rack_weights=dev_t(weights),
        alive=None if alive is None else dev_t(alive.astype(np.float32)),
        users_mult=dev_t(users))


def slot_knobs(sched: Schedule, t: int) -> SlotKnobs:
    """Gather the segment in force at slot `t` of the compiled horizon
    (fixed shapes, no host read: ``seg[t:t + 1]`` is a view on the
    device).  With duplicate knots (segments shorter than one slot at
    small horizons) the LAST matching segment wins, as the reference's
    ``searchsorted(side="right")`` does."""
    i = sched.seg[t:t + 1]

    def at(track):
        return None if track is None else track.index_select(0, i)[0]

    return SlotKnobs(lam_mult=at(sched.lam_mult), p_hot=at(sched.p_hot),
                     hot_rack=at(sched.hot_rack),
                     rate_mult=at(sched.rate_mult),
                     rack_weights=at(sched.rack_weights),
                     alive=at(sched.alive), users_mult=at(sched.users_mult))


def mean_lam_mult_over(sched: Schedule, start_slot: int,
                       horizon: int) -> float:
    """Exact time-average of lam_mult over slots [start_slot, horizon) —
    the Little's-law denominator correction for the measurement window.

    Computed from segment spans clipped to the window (O(S), not
    O(window)), so a window that starts or ends mid-segment weighs that
    truncated segment by exactly the slots it contributes.  Zero-length or
    inverted windows raise instead of silently returning NaN, and a
    negative ``start_slot`` raises instead of wrapping onto the final
    segment.  Reads ``lam_mult`` to the host once: call it at set-up,
    not inside a slot loop."""
    if not 0 <= start_slot < horizon:
        raise ValueError(f"need 0 <= start_slot < horizon for a non-empty "
                         f"window, got [{start_slot}, {horizon})")
    knots = np.asarray(sched.knots, np.int64)
    lam = sched.lam_mult.cpu().numpy().astype(np.float64)
    # Each segment runs [knot, next knot); the last extends to `horizon`
    # (truncated there even if the scenario was compiled for a longer run).
    ends = np.append(knots[1:], max(horizon, int(knots[-1]) + 1))
    spans = (np.minimum(ends, horizon)
             - np.maximum(knots, start_slot)).clip(min=0)
    return float(np.dot(lam, spans) / spans.sum())


# ---------------------------------------------------------------------------
# Host projection: numpy playback for engine / pipeline / benches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostPlayback:
    """Host-side scenario playback over continuous (or step) time.

    Time wraps modulo `horizon`, so one playback cycle repeats — natural for
    diurnal patterns and harmless for one-shot windows as long as the run
    fits one horizon.  All consumers (serving engine, data pipeline,
    bench_serving) read the same compiled segments through this object, so
    there is no per-scenario branching on the host paths either.
    """

    horizon: float
    starts: np.ndarray       # (S,) segment start fractions
    lam_mult: np.ndarray     # (S,)
    tier_mult: np.ndarray    # (S, K)
    server_mult: np.ndarray  # (S, M)
    alive: Optional[np.ndarray] = None  # (S, M) bool; None = no failures
    users_mult: Optional[np.ndarray] = None  # (S,); None = no users track

    def _seg(self, t: float) -> int:
        u = (float(t) % self.horizon) / self.horizon
        return int(np.searchsorted(self.starts, u, side="right")) - 1

    def alive_at(self, t: float, worker: int) -> bool:
        """Whether `worker` is up at time `t` (always True for scenarios
        without a failure track)."""
        if self.alive is None:
            return True
        return bool(self.alive[self._seg(t), worker])

    def alive_mask_at(self, t: float) -> np.ndarray:
        """(M,) bool liveness mask at time `t`."""
        if self.alive is None:
            return np.ones(self.server_mult.shape[1], bool)
        return self.alive[self._seg(t)]

    def lam_mult_at(self, t: float) -> float:
        return float(self.lam_mult[self._seg(t)])

    def users_mult_at(self, t: float) -> float:
        """Closed-loop user-population multiplier at time `t` (1.0 for
        scenarios without a users track)."""
        if self.users_mult is None:
            return 1.0
        return float(self.users_mult[self._seg(t)])

    def rate_mult_at(self, t: float, worker: int,
                     tier: Optional[int] = None) -> float:
        """TRUE-rate multiplier for `worker` at time `t` (x tier sag when the
        locality tier of the work is known)."""
        s = self._seg(t)
        mult = float(self.server_mult[s, worker])
        if tier is not None and 0 <= tier < self.tier_mult.shape[1]:
            mult *= float(self.tier_mult[s, tier])
        return mult

    def slowdown(self, t: float, worker: int,
                 tier: Optional[int] = None) -> float:
        """Observed service-time inflation factor (1 / rate multiplier)."""
        return 1.0 / max(self.rate_mult_at(t, worker, tier), 1e-6)


def host_playback(scn: Scenario, num_workers: int, horizon: float,
                  num_tiers: int = 3, rack_of=None) -> HostPlayback:
    """Project a scenario to host-side numpy playback over `num_workers`
    with `num_tiers` locality tiers (the fleet Topology's ``num_tiers``).

    Host consumers (engine, pipeline, benches) place work by rendezvous
    hashing, so only the arrival-rate and fault tracks are materialized —
    the locality knobs (p_hot / hot_rack / rack_weights) are simulator-only.
    ``rack_of`` (server -> rack map, e.g. ``ClusterSpec.rack_of``) is only
    needed when the scenario uses ``down_racks``.
    """
    if not (isinstance(horizon, numbers.Real) and horizon > 0):
        raise ValueError(f"playback horizon must be > 0, got {horizon}")
    starts, lam, _p_hot, _hot, tier, server, _w, alive = _dense_segments(
        scn, num_workers, num_racks=1, base_p_hot=0.5, num_tiers=num_tiers,
        materialize_weights=False, rack_of=rack_of)
    return HostPlayback(horizon=float(horizon), starts=starts, lam_mult=lam,
                        tier_mult=tier, server_mult=server, alive=alive,
                        users_mult=_users_track(scn))


def arrival_steps(playback: HostPlayback, n_requests: int,
                  base_per_step: float) -> np.ndarray:
    """Deterministic arrival step for each of `n_requests` under the
    playback's time-varying intensity ``base_per_step * lam_mult(t)``.

    Fractional-accumulator thinning: walk steps, accumulate intensity, emit
    one arrival per accumulated unit.  Used by bench_serving to drive
    request submission times from the same scenario that drives slowdowns.
    """
    if base_per_step <= 0:
        raise ValueError(f"base_per_step must be > 0, got {base_per_step}")
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    if n_requests == 0:
        return np.empty(0, np.int64)
    if float(playback.lam_mult.max()) <= 0.0:
        raise ValueError("scenario has lam_mult == 0 everywhere: no "
                         "arrivals would ever be emitted")
    steps = np.empty(n_requests, np.int64)
    acc, t, emitted = 0.0, 0, 0
    # Generous bound: enough steps to emit everything at the mean intensity,
    # plus slack cycles.  Guards against degenerate playbacks where only
    # zero-rate segments land on integer steps (e.g. horizon ~ 1).
    max_steps = int(10 * (n_requests / base_per_step + playback.horizon)) + 100
    while emitted < n_requests:
        if t > max_steps:
            raise RuntimeError(
                f"arrival_steps emitted only {emitted}/{n_requests} after "
                f"{t} steps — scenario intensity too low on this playback")
        acc += base_per_step * playback.lam_mult_at(t)
        while acc >= 1.0 and emitted < n_requests:
            steps[emitted] = t
            emitted += 1
            acc -= 1.0
        t += 1
    return steps
