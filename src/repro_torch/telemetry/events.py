"""Host-side structured event tracing with a Chrome trace-event exporter
(counterpart of `repro.telemetry.events`, a copy: plain Python).

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
spans (`span`, the engine's decode timer) use a `perf_counter` anchored
at recorder construction.  Phase codes used: ``X`` complete (ts + dur),
``i`` instant, ``C`` counter, ``M`` metadata.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

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
        self._t0 = time.perf_counter()

    # -- clocks -------------------------------------------------------------
    def now_us(self) -> float:
        """Wall-clock microseconds since recorder construction."""
        return (time.perf_counter() - self._t0) * 1e6

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


def maybe_span(tracer: Optional[EventRecorder], name: str,
               cat: str = "host", tid: int = 0, **args: Any):
    """`tracer.span(...)` or a no-op context when tracing is off — the
    zero-overhead guard every instrumented call site uses."""
    if tracer is None:
        return nullcontext()
    return tracer.span(name, cat=cat, tid=tid, **args)


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
