"""Trace-driven replay: compile recorded cluster traces into `Scenario`s
(a numpy copy of `repro.workloads.trace`).

The drift study stresses every policy with *synthetic* drift — diurnal
ramps, flash crowds, MMPP bursts.  Production comparisons (the
affinity-scheduling line, the Hadoop scheduling surveys) instead ground
themselves in *recorded* traffic: per-interval arrival counts from a real
cluster, annotated with key-skew shifts and incident windows.  This module
compiles such a trace into the exact same piecewise `Segment`/`Scenario`
representation every other scenario uses, so
``simulate(..., scenario="trace")``, `sweep`, `drift_study` and
`HostPlayback` (the serving engine) replay it through the one scenario
seam.

The pieces:

  * **Schema** — `Trace` (per-interval arrival counts plus optional
    per-interval key-skew annotations ``p_hot`` / ``hot_rack``) and
    `Incident` (a straggler or rack-congestion window over a span of
    intervals).  Intervals are uniform in wall time (``interval``
    seconds each); the compiler maps interval ``i`` of ``N`` onto the
    run fraction ``[i/N, (i+1)/N)``.
  * **Loader / saver** — JSONL (full schema, incident records included)
    and CSV (arrival + skew columns only) via `load_trace` / `save_trace`;
    round-trips are lossless, so an exported trace replays bit-for-bit.
  * **Compiler** — `trace_to_scenario`: unit-mean arrival normalization
    (a load expressed as a fraction of static fluid capacity offers the
    same long-run traffic under every replayed trace) and change-point
    merging (adjacent intervals whose knobs agree within a tolerance
    collapse into one segment; the tolerance doubles until the segment
    count fits ``max_segments``, so a 10k-interval trace compiles to a
    bounded schedule).  Merging averages arrivals over equal-length
    intervals, so the time-average — and therefore the offered load — is
    preserved *exactly*, not approximately.
  * **Generator** — `synthesize_trace` builds deterministic reference
    traces ("diurnal_week", "flash_day"); the port's bundled copies
    (``repro_torch/workloads/traces/``, byte for byte the reference
    package's) are its exact output and load by name through
    `load_bundled`.
  * **Export hook** — `trace_from_arrivals` bins recorded arrival steps
    back into a `Trace`, so any run can be re-recorded and replayed
    deterministically.

A constant trace (no skew annotations, no incidents) compiles to the same
single-segment schedule as the ``"static"`` scenario, so its simulator
sample paths are bitwise identical.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import numbers
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.workloads.scenario import Scenario, Segment, register_scenario

TRACE_VERSION = 1
INCIDENT_KINDS = ("straggler", "rack_congestion")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Incident:
    """One incident window over a span of trace intervals.

    kind      -- "straggler" (per-server slowdown) or "rack_congestion"
                 (tier-wide sag of the rack-local / remote rates)
    start/end -- interval span [start, end), end exclusive
    servers   -- straggler only: affected server ids (mod fleet at compile)
    factor    -- straggler only: TRUE-rate multiplier in (0, 1)
    tier_mult -- congestion only: (local, rack, remote) TRUE-rate multipliers
    """

    kind: str
    start: int
    end: int
    servers: Tuple[int, ...] = ()
    factor: float = 0.25
    tier_mult: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __post_init__(self):
        if self.kind not in INCIDENT_KINDS:
            raise ValueError(f"unknown incident kind {self.kind!r}; "
                             f"expected one of {INCIDENT_KINDS}")
        if not 0 <= self.start < self.end:
            raise ValueError(f"incident needs 0 <= start < end, got "
                             f"[{self.start}, {self.end})")
        if self.kind == "straggler":
            if not self.servers:
                raise ValueError("straggler incident needs `servers`")
            if not 0.0 < self.factor < 1.0:
                raise ValueError(f"straggler factor must be in (0, 1), "
                                 f"got {self.factor}")
        if self.kind == "rack_congestion":
            if len(self.tier_mult) != 3 or any(m <= 0.0
                                               for m in self.tier_mult):
                raise ValueError(f"tier_mult must be 3 positive values, "
                                 f"got {self.tier_mult}")
        object.__setattr__(self, "servers",
                           tuple(int(s) for s in self.servers))
        object.__setattr__(self, "tier_mult",
                           tuple(float(m) for m in self.tier_mult))


@dataclasses.dataclass(frozen=True, eq=False)
class Trace:
    """A recorded cluster trace: uniform intervals of ``interval`` wall
    seconds, each carrying an arrival count and optional key-skew
    annotations, plus incident windows.

    arrivals     -- (N,) per-interval arrival counts (>= 0; any real scale —
                    the compiler normalizes to unit mean)
    p_hot        -- optional (N,) hot-traffic fraction per interval; keep the
                    values quantized to a few levels (every distinct value
                    starts a new segment that merging must preserve)
    hot_rack     -- optional (N,) rack receiving the hot traffic
    rack_weights -- optional (N, R) per-rack arrival weights (the
                    many-rack generalization of hot_rack: the skewed
                    traffic draws its rack from this vector); quantize to
                    a few distinct rows, like p_hot
    """

    name: str
    interval: float
    arrivals: np.ndarray
    p_hot: Optional[np.ndarray] = None
    hot_rack: Optional[np.ndarray] = None
    incidents: Tuple[Incident, ...] = ()
    rack_weights: Optional[np.ndarray] = None

    def __post_init__(self):
        arr = np.asarray(self.arrivals, np.float64)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"arrivals must be a non-empty 1-d array, "
                             f"got shape {arr.shape}")
        if not np.isfinite(arr).all() or (arr < 0).any():
            raise ValueError("arrivals must be finite and >= 0")
        if not (isinstance(self.interval, numbers.Real) and self.interval > 0):
            raise ValueError(f"interval must be > 0, got {self.interval}")
        object.__setattr__(self, "arrivals", arr)
        n = arr.size
        if self.p_hot is not None:
            ph = np.asarray(self.p_hot, np.float64)
            if ph.shape != (n,):
                raise ValueError(f"p_hot must have shape ({n},), "
                                 f"got {ph.shape}")
            if ((ph < 0) | (ph > 1)).any() or not np.isfinite(ph).all():
                raise ValueError("p_hot values must be in [0, 1]")
            object.__setattr__(self, "p_hot", ph)
        if self.hot_rack is not None:
            hr = np.asarray(self.hot_rack, np.int64)
            if hr.shape != (n,):
                raise ValueError(f"hot_rack must have shape ({n},), "
                                 f"got {hr.shape}")
            if (hr < 0).any():
                raise ValueError("hot_rack ids must be >= 0")
            object.__setattr__(self, "hot_rack", hr)
        if self.rack_weights is not None:
            rw = np.asarray(self.rack_weights, np.float64)
            if rw.ndim != 2 or rw.shape[0] != n or rw.shape[1] < 1:
                raise ValueError(f"rack_weights must have shape ({n}, R), "
                                 f"got {rw.shape}")
            if not np.isfinite(rw).all() or (rw < 0).any() or \
                    (rw.sum(axis=1) <= 0).any():
                raise ValueError("rack_weights rows must be non-negative "
                                 "with positive sums")
            object.__setattr__(self, "rack_weights", rw)
        for inc in self.incidents:
            if inc.end > n:
                raise ValueError(f"incident [{inc.start}, {inc.end}) runs "
                                 f"past the trace ({n} intervals)")
        object.__setattr__(self, "incidents", tuple(self.incidents))

    @property
    def num_intervals(self) -> int:
        return int(self.arrivals.size)

    @property
    def duration(self) -> float:
        """Wall-clock span of the whole trace, seconds."""
        return float(self.interval * self.num_intervals)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Trace):
            return NotImplemented

        def arr_eq(a, b):
            return (a is None) == (b is None) and (
                a is None or np.array_equal(a, b))
        return (self.name == other.name
                and self.interval == other.interval
                and arr_eq(self.arrivals, other.arrivals)
                and arr_eq(self.p_hot, other.p_hot)
                and arr_eq(self.hot_rack, other.hot_rack)
                and arr_eq(self.rack_weights, other.rack_weights)
                and self.incidents == other.incidents)


# ---------------------------------------------------------------------------
# Loader / saver (JSONL + CSV)
# ---------------------------------------------------------------------------


def save_trace(trace: Trace, path: Union[str, Path]) -> Path:
    """Write a trace to `path`: JSONL for ``.jsonl``/``.json`` (full
    schema), CSV for ``.csv`` (interval columns only — incident windows
    have no CSV representation and raise)."""
    path = Path(path)
    if path.suffix == ".csv":
        if trace.incidents:
            raise ValueError("CSV traces cannot carry incident records; "
                             "save as .jsonl instead")
        if trace.rack_weights is not None:
            raise ValueError("CSV traces cannot carry rack_weights vectors; "
                             "save as .jsonl instead")
        cols = ["arrivals"]
        if trace.p_hot is not None:
            cols.append("p_hot")
        if trace.hot_rack is not None:
            cols.append("hot_rack")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["# name", trace.name, "interval", trace.interval])
            w.writerow(cols)
            for i in range(trace.num_intervals):
                row: List[object] = [_num(trace.arrivals[i])]
                if trace.p_hot is not None:
                    row.append(_num(trace.p_hot[i]))
                if trace.hot_rack is not None:
                    row.append(int(trace.hot_rack[i]))
                w.writerow(row)
        return path
    with open(path, "w") as f:
        head = {"record": "header", "version": TRACE_VERSION,
                "name": trace.name, "interval": trace.interval}
        f.write(json.dumps(head) + "\n")
        for i in range(trace.num_intervals):
            rec: Dict[str, object] = {"record": "interval",
                                      "arrivals": _num(trace.arrivals[i])}
            if trace.p_hot is not None:
                rec["p_hot"] = _num(trace.p_hot[i])
            if trace.hot_rack is not None:
                rec["hot_rack"] = int(trace.hot_rack[i])
            if trace.rack_weights is not None:
                rec["rack_weights"] = [_num(w) for w in trace.rack_weights[i]]
            f.write(json.dumps(rec) + "\n")
        for inc in trace.incidents:
            rec = {"record": "incident", "kind": inc.kind,
                   "start": inc.start, "end": inc.end}
            if inc.kind == "straggler":
                rec["servers"] = list(inc.servers)
                rec["factor"] = inc.factor
            else:
                rec["tier_mult"] = list(inc.tier_mult)
            f.write(json.dumps(rec) + "\n")
    return path


def _num(x: float) -> Union[int, float]:
    """Integral floats serialize as ints (arrival counts stay readable and
    round-trip exactly)."""
    f = float(x)
    return int(f) if f.is_integer() and abs(f) < 2**53 else f


def load_trace(path: Union[str, Path]) -> Trace:
    """Read a JSONL or CSV trace written by `save_trace` (or by hand)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no trace file at {path}")
    if path.suffix == ".csv":
        return _load_csv(path)
    return _load_jsonl(path)


def _load_jsonl(path: Path) -> Trace:
    name, interval = path.stem, 1.0
    arrivals: List[float] = []
    p_hot: List[float] = []
    hot_rack: List[int] = []
    rack_weights: List[List[float]] = []
    incidents: List[Incident] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: invalid JSON: {e}") from None
            kind = rec.get("record")
            if kind == "header":
                if rec.get("version", TRACE_VERSION) > TRACE_VERSION:
                    raise ValueError(f"{path}: trace version "
                                     f"{rec['version']} is newer than "
                                     f"supported ({TRACE_VERSION})")
                name = rec.get("name", name)
                interval = float(rec.get("interval", interval))
            elif kind == "interval":
                arrivals.append(float(rec["arrivals"]))
                if "p_hot" in rec:
                    p_hot.append(float(rec["p_hot"]))
                if "hot_rack" in rec:
                    hot_rack.append(int(rec["hot_rack"]))
                if "rack_weights" in rec:
                    rack_weights.append(
                        [float(w) for w in rec["rack_weights"]])
            elif kind == "incident":
                incidents.append(Incident(
                    kind=rec["kind"], start=int(rec["start"]),
                    end=int(rec["end"]),
                    servers=tuple(rec.get("servers", ())),
                    factor=float(rec.get("factor", 0.25)),
                    tier_mult=tuple(rec.get("tier_mult", (1.0, 1.0, 1.0)))))
            else:
                raise ValueError(f"{path}:{ln}: unknown record type "
                                 f"{kind!r}")
    if p_hot and len(p_hot) != len(arrivals):
        raise ValueError(f"{path}: p_hot must be annotated on all intervals "
                         f"or none ({len(p_hot)}/{len(arrivals)} annotated)")
    if hot_rack and len(hot_rack) != len(arrivals):
        raise ValueError(f"{path}: hot_rack must be annotated on all "
                         f"intervals or none "
                         f"({len(hot_rack)}/{len(arrivals)} annotated)")
    if rack_weights and len(rack_weights) != len(arrivals):
        raise ValueError(f"{path}: rack_weights must be annotated on all "
                         f"intervals or none "
                         f"({len(rack_weights)}/{len(arrivals)} annotated)")
    return Trace(name=name, interval=interval,
                 arrivals=np.asarray(arrivals, np.float64),
                 p_hot=np.asarray(p_hot, np.float64) if p_hot else None,
                 hot_rack=np.asarray(hot_rack, np.int64) if hot_rack else None,
                 incidents=tuple(incidents),
                 rack_weights=(np.asarray(rack_weights, np.float64)
                               if rack_weights else None))


def _load_csv(path: Path) -> Trace:
    name, interval = path.stem, 1.0
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if rows and rows[0] and rows[0][0].startswith("#"):
        meta = rows.pop(0)
        kv = dict(zip(meta[::2], meta[1::2]))
        name = kv.get("# name", name)
        interval = float(kv.get("interval", interval))
    if not rows:
        raise ValueError(f"{path}: empty CSV trace")
    cols = [c.strip() for c in rows.pop(0)]
    if "arrivals" not in cols:
        raise ValueError(f"{path}: CSV trace needs an `arrivals` column, "
                         f"got {cols}")
    data = {c: [] for c in cols}
    for r in rows:
        for c, v in zip(cols, r):
            data[c].append(v)
    return Trace(
        name=name, interval=interval,
        arrivals=np.asarray(data["arrivals"], np.float64),
        p_hot=(np.asarray(data["p_hot"], np.float64)
               if "p_hot" in data else None),
        hot_rack=(np.asarray(data["hot_rack"], np.int64)
                  if "hot_rack" in data else None))


# ---------------------------------------------------------------------------
# Compiler: Trace -> Scenario (unit-mean + change-point merging)
# ---------------------------------------------------------------------------


def _interval_knobs(trace: Trace):
    """Per-interval aux knobs (everything except the arrival track):
    (p_hot, hot_rack, tier_mult, slow_servers-items) tuples.  Intervals
    with identical aux knobs form the runs inside which arrival merging
    is allowed — aux changes are exact change-points that survive any
    merge tolerance."""
    n = trace.num_intervals
    tier = np.ones((n, 3), np.float64)
    slow: List[Dict[int, float]] = [{} for _ in range(n)]
    for inc in trace.incidents:
        for i in range(inc.start, inc.end):
            if inc.kind == "straggler":
                for s in inc.servers:
                    slow[i][s] = slow[i].get(s, 1.0) * inc.factor
            else:
                tier[i] *= inc.tier_mult
    keys = []
    for i in range(n):
        keys.append((
            None if trace.p_hot is None else float(trace.p_hot[i]),
            0 if trace.hot_rack is None else int(trace.hot_rack[i]),
            tuple(float(m) for m in tier[i]),
            tuple(sorted(slow[i].items())),
            None if trace.rack_weights is None
            else tuple(float(w) for w in trace.rack_weights[i]),
        ))
    return keys


def _segment_runs(lam: np.ndarray, keys: Sequence, tol: float) -> List[int]:
    """Greedy change-point segmentation: one pass over intervals, breaking
    wherever the aux knobs change or the arrival band (max - min of the
    open segment) would exceed `tol`.  Returns segment start indices."""
    starts = [0]
    lo = hi = lam[0]
    for i in range(1, len(lam)):
        lo, hi = min(lo, lam[i]), max(hi, lam[i])
        if keys[i] != keys[i - 1] or hi - lo > tol:
            starts.append(i)
            lo = hi = lam[i]
    return starts


def trace_to_scenario(trace: Trace, max_segments: int = 64,
                      tol: float = 0.05, normalize: bool = True) -> Scenario:
    """Compile a trace into a piecewise-constant `Scenario` on [0, 1).

    normalize    -- divide arrivals by their mean so the compiled
                    ``lam_mult`` track has unit time-average (same long-run
                    offered load as every built-in scenario); pass False to
                    replay the raw counts as absolute multipliers.
    tol          -- initial arrival-band tolerance for merging, in units of
                    the (normalized) multiplier; adjacent intervals whose
                    arrivals stay within one band collapse into a segment.
    max_segments -- bound on the compiled segment count: the tolerance
                    doubles until the schedule fits.  Aux change-points
                    (skew annotations, incident boundaries) are never
                    merged away, so a trace whose aux knobs change more
                    than `max_segments` times cannot be compiled — quantize
                    the annotations instead.

    Merging replaces each segment's arrivals with their plain mean over
    equal-length intervals, so the trace's time-average arrival rate is
    preserved exactly at any tolerance.
    """
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    if tol <= 0:
        raise ValueError(f"tol must be > 0, got {tol}")
    lam = trace.arrivals
    if normalize:
        mean = float(lam.mean())
        if mean <= 0:
            raise ValueError(f"trace {trace.name!r} has zero mean arrivals; "
                             "nothing to normalize")
        lam = lam / mean
    keys = _interval_knobs(trace)
    aux_runs = 1 + sum(keys[i] != keys[i - 1] for i in range(1, len(keys)))
    if aux_runs > max_segments:
        raise ValueError(
            f"trace {trace.name!r} has {aux_runs} annotation/incident "
            f"change-points but max_segments={max_segments}; quantize the "
            f"p_hot/hot_rack annotations or raise max_segments")
    # Widen the arrival band until the schedule fits, then binary-refine
    # back toward the tightest feasible tolerance — the compiled schedule
    # uses as much of the segment budget as the trace's structure needs.
    starts = _segment_runs(lam, keys, tol)
    if len(starts) > max_segments:
        lo, hi = tol, tol
        while len(starts) > max_segments:
            lo, hi = hi, hi * 2.0
            starts = _segment_runs(lam, keys, hi)
        for _ in range(16):
            mid = 0.5 * (lo + hi)
            mid_starts = _segment_runs(lam, keys, mid)
            if len(mid_starts) <= max_segments:
                hi, starts = mid, mid_starts
            else:
                lo = mid
    n = trace.num_intervals
    bounds = starts + [n]
    segments = []
    for a, b in zip(bounds, bounds[1:]):
        p_hot, hot_rack, tier, slow, weights = keys[a]
        segments.append(Segment(
            start=a / n,
            lam_mult=float(lam[a:b].mean()),
            p_hot=p_hot,
            hot_rack=hot_rack,
            tier_mult=tier,
            slow_servers=dict(slow),
            rack_weights=weights))
    return Scenario(f"trace:{trace.name}", tuple(segments))


# ---------------------------------------------------------------------------
# Synthetic reference traces + the bundled copies
# ---------------------------------------------------------------------------

# the port's own copies of the bundled files, byte for byte the
# reference's (`synthesize_trace(kind, 0)` saved)
_TRACE_DIR = Path(__file__).resolve().parent / "traces"
_BUNDLED_FILES = {"diurnal_week": "diurnal_week.jsonl",
                  "flash_day": "flash_day.csv"}


def synthesize_trace(kind: str = "diurnal_week", seed: int = 0) -> Trace:
    """Deterministic reference traces (the bundled files are this
    function's exact output for seed 0; pinned by tests/test_trace.py).

    "diurnal_week" -- 7 days of 10-minute intervals (1008): sinusoidal
        day/night load with a weekend dip, business-hours key skew
        (``p_hot`` stepping 0.45 -> 0.62), and a 6-hour straggler
        incident on day 3.
    "flash_day"    -- one day of 5-minute intervals (288): flat load with
        Poisson noise and a 2.6x flash crowd during 14:00-15:00.  No
        annotations or incidents, so it round-trips through CSV.
    """
    if kind not in _BUNDLED_FILES:
        raise ValueError(f"unknown synthetic trace kind {kind!r}; "
                         f"expected one of {tuple(_BUNDLED_FILES)}")
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, list(_BUNDLED_FILES).index(kind)]))
    if kind == "diurnal_week":
        per_day = 144  # 10-minute intervals
        n = 7 * per_day
        u = (np.arange(n) % per_day) / per_day  # time of day in [0, 1)
        day = np.arange(n) // per_day
        base = 120.0 * (1.0 + 0.35 * np.sin(2.0 * np.pi * (u - 0.25)))
        base = base * np.where(day >= 5, 0.72, 1.0)  # weekend dip
        arrivals = rng.poisson(base).astype(np.float64)
        # business-hours key skew, quantized to two levels so the compiled
        # schedule stays bounded (3 aux runs per day)
        p_hot = np.where((u >= 0.375) & (u < 0.75), 0.62, 0.45)
        incidents = (Incident("straggler",
                              start=3 * per_day + 60, end=3 * per_day + 96,
                              servers=(4, 5), factor=0.3),)
        return Trace("diurnal_week", interval=600.0, arrivals=arrivals,
                     p_hot=p_hot, incidents=incidents)
    n = 288  # flash_day: 5-minute intervals
    base = np.full(n, 95.0)
    base[168:180] *= 2.6  # flash crowd 14:00-15:00
    arrivals = rng.poisson(base).astype(np.float64)
    return Trace("flash_day", interval=300.0, arrivals=arrivals)


def bundled_traces() -> Tuple[str, ...]:
    """Names of the example traces bundled under
    ``repro_torch/workloads/traces/``."""
    return tuple(sorted(_BUNDLED_FILES))


def load_bundled(name: str) -> Trace:
    """Load one of the bundled example traces by name."""
    try:
        fname = _BUNDLED_FILES[name]
    except KeyError:
        raise ValueError(f"unknown bundled trace {name!r}; "
                         f"available: {bundled_traces()}") from None
    return load_trace(_TRACE_DIR / fname)


@register_scenario("trace")
def trace_scenario(path: Optional[Union[str, Path]] = None,
                   name: Optional[str] = None, max_segments: int = 64,
                   tol: float = 0.05, normalize: bool = True) -> Scenario:
    """Replay a recorded cluster trace (JSONL/CSV of per-interval arrival
    counts, key-skew annotations, and incident windows), compiled to the
    same piecewise schedule as every synthetic scenario; `path` loads a
    trace file, `name` one of the bundled examples (default
    "diurnal_week")."""
    if path is not None and name is not None:
        raise ValueError("pass either path= or name=, not both")
    tr = load_trace(path) if path is not None \
        else load_bundled(name or "diurnal_week")
    return trace_to_scenario(tr, max_segments=max_segments, tol=tol,
                             normalize=normalize)


# ---------------------------------------------------------------------------
# Export hook: re-record a run as a trace
# ---------------------------------------------------------------------------


def trace_from_arrivals(steps: Sequence[float], num_intervals: int,
                        name: str = "recorded", horizon: Optional[float] = None,
                        interval: Optional[float] = None) -> Trace:
    """Bin recorded arrival times (engine steps, slots, seconds — any
    monotone clock) into a per-interval `Trace`, the inverse of
    `arrival_steps`: export a live run, `save_trace` it, and the same
    traffic replays deterministically via ``scenario="trace"``.

    horizon  -- clock span covered by the trace; default: just past the
                last arrival.
    interval -- wall seconds per bin recorded as metadata; default:
                horizon / num_intervals (one clock unit == one second).
    """
    if num_intervals < 1:
        raise ValueError(f"num_intervals must be >= 1, got {num_intervals}")
    steps = np.asarray(steps, np.float64)
    if steps.size and ((steps < 0).any() or not np.isfinite(steps).all()):
        raise ValueError("arrival steps must be finite and >= 0")
    if horizon is None:
        horizon = float(steps.max()) + 1.0 if steps.size else float(num_intervals)
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    if steps.size and steps.max() >= horizon:
        raise ValueError(f"arrivals at step {steps.max()} fall outside "
                         f"horizon {horizon}")
    counts, _ = np.histogram(steps, bins=num_intervals, range=(0.0, horizon))
    return Trace(name=name,
                 interval=float(interval if interval is not None
                                else horizon / num_intervals),
                 arrivals=counts.astype(np.float64))
