"""The traced window: `torch.profiler` over one study, read from outside
the program.

`capture` runs a call under the profiler (CPU and CUDA activities) inside
a span named `SPAN`, and returns a `Trace`: the device's operations in
the span (kernels, copies and sets), the host's operations, the span's
length and the device's busy time (the union of its operations'
intervals).  `breakdown` lists the device operations that took most time
and the longest idle gaps, each labelled by the innermost host operation
running at its middle.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

SPAN = "portbench.study"
TOP = 10
NAME_CHARS = 96
_COPIES = ("Memcpy", "Memset")


class Op(NamedTuple):
    name: str
    start: int     # ns
    end: int       # ns

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Trace:
    """What one traced window holds, as the metric readers see it."""

    def __init__(self, kernels: List[Op], device_ops: List[Op],
                 host_ops: List[Op], window: Tuple[int, int], slots: int,
                 shape: Dict[str, int]):
        self.kernels = kernels
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.window = window
        self.window_s = (window[1] - window[0]) * 1e-9
        self.slots = slots
        self.shape = shape
        self.merged = _merge(device_ops, window)
        self.busy_s = sum(b - a for a, b in self.merged) * 1e-9


def _merge(ops: List[Op], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The union of the ops' intervals clipped to the window, in order."""
    lo, hi = window
    out: List[List[int]] = []
    for a, b in sorted((max(o.start, lo), min(o.end, hi)) for o in ops):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_kind(name: str) -> str:
    """"copy" (a copy or a set), "kernel", or "other" (an annotation or a
    synchronisation the profiler draws on the device's timeline, which
    is no work of the device's) for a device event's name."""
    if name.startswith(_COPIES):
        return "copy"
    if name.startswith("void ") or "kernel" in name.lower():
        return "kernel"
    return "other"


def _read(prof, slots: int, shape: Dict[str, int]) -> Trace:
    from torch.autograd import DeviceType

    kernels, device_ops, host_ops, spans = [], [], [], []
    others: Dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            kind = device_kind(op.name)
            if kind == "other":
                others[op.name] = others.get(op.name, 0) + 1
                continue
            device_ops.append(op)
            if kind == "kernel":
                kernels.append(op)
        elif op.name == SPAN:
            spans.append(op)
        else:
            host_ops.append(op)
    if others:
        print(f"portbench: device events left out of busy time: "
              f"{json.dumps(others)}", file=sys.stderr)
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} spans named "
                           f"{SPAN!r}, want 1")
    window = (spans[0].start, spans[0].end)

    def inside(op):
        return op.end > window[0] and op.start < window[1]

    return Trace([k for k in kernels if inside(k)],
                 [d for d in device_ops if inside(d)],
                 [h for h in host_ops if inside(h)], window, slots, shape)


def capture(fn, slots: int, shape: Dict[str, int]):
    """(fn's result, its `Trace`): `fn` runs once under the profiler in
    the span; `slots` is the number of simulated slots it runs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            out = fn()
            torch.cuda.synchronize()
    return out, _read(prof, slots, shape)


def _labeller(host: List[Op]):
    """t (ns) -> the innermost host op running at t."""
    start = np.asarray([op.start for op in host], np.int64)
    end = np.asarray([op.end for op in host], np.int64)

    def label(t: float) -> str:
        hit = np.flatnonzero((start <= t) & (t <= end))
        if hit.size == 0:
            return f"{SPAN}:python"
        return host[hit[np.argmin(end[hit] - start[hit])]].name[:NAME_CHARS]

    return label


def breakdown(trace: Trace) -> Dict[str, list]:
    """The device ops that took most time, summed by name, and the
    longest idle gaps of the window with what the host was doing."""
    by_name: Dict[str, float] = {}
    lo, hi = trace.window
    for op in trace.device_ops:
        name = op.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + \
            (min(op.end, hi) - max(op.start, lo)) * 1e-9
    top = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    edges = [lo] + [x for ab in trace.merged for x in ab] + [hi]
    gaps = np.asarray([(a, b) for a, b in zip(edges[::2], edges[1::2])
                       if b > a], dtype=np.int64).reshape(-1, 2)
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:TOP]
    label = _labeller(trace.host_ops)
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[label((a + b) / 2),
                           (b - a) * 1e-9] for a, b in longest.tolist()]}
