"""Host-side structured event tracing with a Chrome trace-event exporter
(counterpart of `repro.telemetry.events`, a copy), and the program's
spans and counters on `torch.profiler`'s timeline.

One `EventRecorder` per run: consumers (`serve/engine.py`,
`replication/host.py`) emit typed events — route decisions, admissions,
failures, repair starts/commits, decode spans — into a bounded ring
buffer (a deque: the newest `capacity` events win, and the eviction
count is reported, never hidden).  `to_chrome()` serializes the buffer
as Chrome trace-event JSON, the format Perfetto
(https://ui.perfetto.dev) and `chrome://tracing` load directly.

Timestamps are microseconds (`ts`/`dur`), per the trace-event spec.
Emitters on a virtual clock (the engine's steps, the lifecycle's time)
pass explicit ``ts_us`` values — the convention throughout this repo is
ONE CLOCK UNIT = 1 ms, i.e. ``ts_us = clock * 1000`` — while wall-clock
spans (`span`, the engine's decode timer) read `now_us`: Unix-epoch
microseconds, the clock `torch.profiler` stamps its host events with, so
a recorder's trace and a profiler's export overlay in Perfetto.  Phase
codes used: ``X`` complete (ts + dur), ``i`` instant, ``C`` counter,
``M`` metadata.

Program spans and counters (`span`, `count`, `collecting`,
`recording`).  The program marks its phases with ``with span(name):``
and its work with ``count(name, value)``.  Both are live only while
tracing is on: while a `torch.profiler` runs, or while `recording` has
installed a recorder.  Off, a span costs one check of a module global
and of the profiler's enabled flag, and opens nothing.  On, a span opens
a ``torch.profiler.record_function(name)`` range when the profiler runs
(the profiler's host timeline, which it shares with the device trace)
and writes an ``X`` event through `EventRecorder.span` when a recorder
is installed.  A counter counts only inside a `collecting` block of the
calling thread (the program opens one around a run it counts; `counting`
says whether a count would be kept) and is dropped elsewhere.  Its value
is a host number or a device tensor; a tensor is kept by reference and
summed on its device only at `flush_counts`, which the program calls
once its results are on the host, or at the block's end, so counting
reads nothing back inside a loop.  A flush adds each counter's total to
the process-wide `COUNTS` and writes it as a ``C`` event to the
installed recorder.  Span names contain no ``kernel`` and
do not start with ``void ``, ``Memcpy`` or ``Memset``: readers of a
device trace take such names, which the profiler also draws on the
device's timeline, for device work.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch
from torch.autograd import profiler as _profiler

#: trace-event phases this recorder emits / the validator accepts
PHASES = ("X", "B", "E", "i", "I", "C", "M")

#: per-microsecond scale for emitters on a step/virtual clock (1 unit = 1 ms)
CLOCK_UNIT_US = 1000.0


class EventRecorder:
    """Ring-buffered trace-event sink shared by every host-side emitter."""

    def __init__(self, capacity: int = 65_536, pid: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pid = pid
        self._events: deque = deque(maxlen=capacity)
        self.emitted = 0

    # -- clocks -------------------------------------------------------------
    @staticmethod
    def now_us() -> float:
        """Wall-clock Unix-epoch microseconds: `torch.profiler`'s clock."""
        return time.time_ns() * 1e-3

    # -- emitters -----------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        self.emitted += 1
        self._events.append(ev)

    def instant(self, name: str, cat: str = "event",
                ts_us: Optional[float] = None, tid: int = 0,
                **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": float(self.now_us() if ts_us is None else ts_us),
                    "pid": self.pid, "tid": int(tid), "args": dict(args)})

    def counter(self, name: str, value: float, cat: str = "counter",
                ts_us: Optional[float] = None, tid: int = 0) -> None:
        self._push({"name": name, "cat": cat, "ph": "C",
                    "ts": float(self.now_us() if ts_us is None else ts_us),
                    "pid": self.pid, "tid": int(tid),
                    "args": {"value": float(value)}})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "span", tid: int = 0, **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "X",
                    "ts": float(ts_us), "dur": float(max(dur_us, 0.0)),
                    "pid": self.pid, "tid": int(tid), "args": dict(args)})

    def metadata(self, name: str, /, tid: int = 0, **args: Any) -> None:
        """Perfetto naming events, e.g.
        ``metadata("thread_name", tid=3, name="replica3")`` (the event
        name is positional-only so ``name=`` lands in args)."""
        self._push({"name": name, "ph": "M", "ts": 0.0, "pid": self.pid,
                    "tid": int(tid), "args": dict(args)})

    @contextmanager
    def span(self, name: str, cat: str = "host", tid: int = 0, **args: Any):
        """Wall-clock span: wraps a host-side region (e.g. a kernel
        dispatch path) as one complete event."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, cat=cat, tid=tid,
                          **args)

    # -- introspection / export ---------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (emitted - retained)."""
        return self.emitted - len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"emitted": self.emitted, "dropped": self.dropped,
                          "capacity": self.capacity},
        }

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")
        return path


# -- program spans and counters ---------------------------------------------

_OFF = nullcontext()
# .recorder: the calling thread's recorder; .pending: its open
# `collecting` block's counter values by name
_LOCAL = threading.local()
_INSTALLED = 0               # recorders installed, over all threads
_INSTALLED_LOCK = threading.Lock()
COUNTS: Dict[str, float] = {}
_COUNTS_LOCK = threading.Lock()


def _installed() -> Optional[EventRecorder]:
    return getattr(_LOCAL, "recorder", None) if _INSTALLED else None


class _Span:
    """One region on the profiler's timeline, the recorder's, or both."""

    __slots__ = ("name", "recorder", "opts", "_range", "_event")

    def __init__(self, name: str, recorder: Optional[EventRecorder],
                 opts: Dict[str, Any]):
        self.name, self.recorder, self.opts = name, recorder, opts

    def __enter__(self):
        self._range = self._event = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.recorder is not None:
            self._event = self.recorder.span(self.name, **self.opts)
            self._event.__enter__()
        return self

    def __exit__(self, *exc):
        if self._event is not None:
            self._event.__exit__(*exc)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A program span named `name` (see the module docstring): a no-op
    context while tracing is off."""
    if not (_INSTALLED or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, _installed(), {})


def maybe_span(tracer: Optional[EventRecorder], name: str,
               cat: str = "host", tid: int = 0, **args: Any):
    """`span(name)` writing to `tracer` (with these event fields) in place
    of the installed recorder; with ``tracer=None``, `span(name)`."""
    if tracer is None:
        return span(name)
    return _Span(name, tracer, dict(cat=cat, tid=tid, **args))


@contextmanager
def recording(recorder: EventRecorder):
    """Install `recorder` for the calling thread: the program's spans and
    counters write to it until the block ends."""
    global _INSTALLED
    before = getattr(_LOCAL, "recorder", None)
    _LOCAL.recorder = recorder
    with _INSTALLED_LOCK:
        _INSTALLED += 1
    try:
        yield recorder
    finally:
        with _INSTALLED_LOCK:
            _INSTALLED -= 1
        _LOCAL.recorder = before


def _pending() -> Optional[Dict[str, list]]:
    """The calling thread's open `collecting` block's values, while
    tracing is on; else None."""
    if _INSTALLED or _profiler._is_profiler_enabled:
        return getattr(_LOCAL, "pending", None)
    return None


def counting() -> bool:
    """Whether `count` would keep a value here: tracing is on and the
    calling thread has a `collecting` block open.  A caller whose value
    costs work to compute asks first."""
    return _pending() is not None


def count(name: str, value) -> None:
    """Add `value` (a host number or a device tensor of counts) to the
    counter `name` at the next `flush_counts`; nothing while tracing is
    off or outside a `collecting` block."""
    pending = _pending()
    if pending is not None:
        pending.setdefault(name, []).append(value)


@contextmanager
def collecting():
    """The calling thread's counters count inside this block and are
    flushed at `flush_counts` or at its end (dropped if it raises).  A
    block inside another is part of it."""
    if getattr(_LOCAL, "pending", None) is not None:
        yield
        return
    _LOCAL.pending = {}
    try:
        yield
        flush_counts()
    finally:
        _LOCAL.pending = None


def _total(values: list) -> float:
    """The sum of host numbers and tensors, the tensors summed on their
    device in one reduction."""
    host = [v for v in values if not isinstance(v, torch.Tensor)]
    dev = [v.reshape(-1) for v in values if isinstance(v, torch.Tensor)]
    total = sum(host)
    if dev:
        flat = torch.cat(dev)
        wide = torch.float64 if flat.is_floating_point() else torch.int64
        total += flat.sum(dtype=wide).item()
    return total


def flush_counts() -> None:
    """Sum the calling thread's pending counter values into `COUNTS` and
    write each total as a ``C`` event to the installed recorder.  The
    program calls it after its results have come to the host."""
    pending = getattr(_LOCAL, "pending", None)
    if not pending:
        return
    recorder = _installed()
    for name, values in pending.items():
        total = _total(values)
        with _COUNTS_LOCK:
            COUNTS[name] = COUNTS.get(name, 0) + total
        if recorder is not None:
            recorder.counter(name, total)
    pending.clear()


def validate_chrome_trace(doc: Any) -> None:
    """Raise ValueError unless `doc` is a loadable Chrome trace-event
    object (the schema check the tests pin: Perfetto's JSON importer
    requires exactly these fields)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with a 'traceEvents' list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key, types in (("name", str), ("ph", str),
                           ("ts", (int, float)), ("pid", int), ("tid", int)):
            if not isinstance(ev.get(key), types):
                raise ValueError(f"event {i} ({ev.get('name')!r}) is "
                                 f"missing/mistyped field {key!r}")
        if ev["ph"] not in PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"complete event {i} ({ev['name']!r}) "
                             f"has no numeric 'dur'")


def load_trace(path: Union[str, Path]) -> Dict[str, Any]:
    """Load + validate a saved Chrome trace JSON file."""
    with open(path) as f:
        doc = json.load(f)
    validate_chrome_trace(doc)
    return doc
