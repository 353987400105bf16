"""The program's own spans in a traced window, and the device work each
phase launched.

While the profiler runs, the program opens a ``record_function`` range
for each of its phases (`repro_torch.telemetry.span`): host ops of the
trace named ``study``, ``study.<part>`` or ``fleet.<part>``.
`attribution` finds them, matches the window's launch calls (the CUDA
runtime's and driver's kernel launches, copies and sets, in start order)
one for one to the device's operations in start order, which one stream
runs first in, first out, and gives each device operation the stack of
program spans open at its launch.  The phases count kernel time, as
`device_ms_per_slot` does, so the phases with set-up and finalize add up
to it; copies and sets are reported apart.  Where the nvcc-built library's
launches leave no runtime record (no launch call lies in a
``fleet.route.private`` span, and there is one ``fleet_route_kernel``
operation a span), those operations go to ``fleet.route.private``, the
one span that launches them.  The device's timestamps put a few
operations out of their launch order (an operation starts inside the
one before it), so a few pairs may differ in kind (a copy against a
kernel): up to `MAX_DISORDER` of the pairs are taken as such local
disorder.  Where the counts differ, or more of the kinds, no phase is
read, and the difference goes to standard error.  A trace of a program without spans
reads None throughout.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from portbench.trace import Op, device_kind

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
_COPY_CALLS = ("cudaMemcpy", "cudaMemset")
# share of the pairs whose kinds may differ: the device's timestamps put
# a few operations out of their one-stream order (measured on an H100:
# 2-29 of 282,660-762,401 off their launch), which moves them to a
# neighbour's phase; more is a shifted match, and nothing is read
MAX_DISORDER = 1e-3
LIBRARY_KERNEL = "fleet_route_kernel"
LIBRARY_STACK = ("study", "fleet.loop", "fleet.route",
                 "fleet.route.private")
_MEMO = "_portbench_spans"

Stack = Tuple[str, ...]


class Attribution(NamedTuple):
    spans: Dict[str, List[Op]]                # the program's spans by name
    kernel_s: Optional[Dict[Stack, float]]    # kernel seconds by launch stack


def is_program_span(name: str) -> bool:
    return name == "study" or name.startswith(("study.", "fleet."))


def _stacks(spans: List[Op], launches: List[Op]) -> List[Stack]:
    """The names of the program spans open at each launch's start,
    outermost first; the spans nest, as one thread opens them."""
    spans = sorted(spans, key=lambda o: (o.start, -o.end))
    out: List[Stack] = []
    open_: List[Op] = []
    current: Stack = ()
    i = 0
    for launch in launches:
        t = launch.start
        changed = False
        while i < len(spans) and spans[i].start <= t:
            while open_ and open_[-1].end < spans[i].end:   # not around it
                open_.pop()
            open_.append(spans[i])
            i += 1
            changed = True
        while open_ and open_[-1].end < t:
            open_.pop()
            changed = True
        if changed:
            current = tuple(o.name for o in open_)
        out.append(current)
    return out


def _kind(call: str) -> str:
    return "copy" if call.startswith(_COPY_CALLS) else "kernel"


def _match(launches: List[Op], stacks: List[Stack], device: List[Op],
           private_spans: int):
    """([(launch index or None, device op)], pairs of other kinds) or why
    they do not match.  The library's operations stand apart only where
    no launch call lies in a ``fleet.route.private`` span and there is
    one of them a span."""
    library: List[Op] = []
    if len(launches) != len(device):
        library = [d for d in device if LIBRARY_KERNEL in d.name]
        rest = [d for d in device if LIBRARY_KERNEL not in d.name]
        unrecorded = (len(library) == private_spans and not any(
            st and st[-1] == LIBRARY_STACK[-1] for st in stacks))
        if not (library and unrecorded and len(launches) == len(rest)):
            return (f"{len(launches)} launch calls against {len(device)} "
                    f"device operations ({len(library)} of them "
                    f"{LIBRARY_KERNEL})")
        device = rest
    off = [i for i, (call, op) in enumerate(zip(launches, device))
           if _kind(call.name) != device_kind(op.name)]
    if len(off) > MAX_DISORDER * len(device):
        i = off[0]
        return (f"{len(off)} of {len(device)} launch calls are not of the "
                f"kind of their device operation, the first {i} "
                f"({launches[i].name} against {device[i].name[:60]})")
    return list(enumerate(device)) + [(None, d) for d in library], len(off)


def attribution(trace) -> Attribution:
    """The program's spans and the kernel seconds by launch stack, worked
    out once a trace."""
    memo = getattr(trace, _MEMO, None)
    if memo is not None:
        return memo
    spans: Dict[str, List[Op]] = {}
    launches: List[Op] = []
    for op in trace.host_ops:
        if is_program_span(op.name):
            spans.setdefault(op.name, []).append(op)
        elif op.name.startswith(LAUNCHES):
            launches.append(op)
    kernel_s: Optional[Dict[Stack, float]] = None
    if spans:
        launches.sort(key=lambda o: o.start)
        device = sorted(trace.device_ops, key=lambda o: o.start)
        stacks = _stacks([o for v in spans.values() for o in v], launches)
        pairs = _match(launches, stacks, device,
                       len(spans.get(LIBRARY_STACK[-1], ())))
        if isinstance(pairs, str):
            print(f"portbench.spans: no phase is read: {pairs}",
                  file=sys.stderr)
        else:
            pairs, off = pairs
            kernel_s, copy_s = {}, {}
            for i, op in pairs:
                stack = LIBRARY_STACK if i is None else stacks[i]
                into = kernel_s if device_kind(op.name) == "kernel" \
                    else copy_s
                into[stack] = into.get(stack, 0.0) + op.seconds
            _report(kernel_s, copy_s, device, off)
    memo = Attribution(spans, kernel_s)
    setattr(trace, _MEMO, memo)
    return memo


def _report(kernel_s: Dict[Stack, float], copy_s: Dict[Stack, float],
            device: List[Op], off: int) -> None:
    """To standard error, the attribution behind the phase metrics: kernel
    and copy seconds by the innermost span of their launch, and how far
    the device's timestamps stray from its one-stream order (operations
    that start before the one before them ends, which one stream never
    runs)."""
    def inner(by_stack):
        out: Dict[str, float] = {}
        for stack, s in by_stack.items():
            key = stack[-1] if stack else "(no program span)"
            out[key] = out.get(key, 0.0) + s
        return json.dumps(dict(sorted(out.items(), key=lambda x: -x[1])))

    early = [b for a, b in zip(device, device[1:]) if b.start < a.end]
    print(f"portbench.spans: {off} pairs of other kinds, {len(early)} "
          f"operations ({sum(op.seconds for op in early)} s) start inside "
          f"the one before; kernel s {sum(kernel_s.values())} by innermost "
          f"span {inner(kernel_s)}; copy and set s "
          f"{sum(copy_s.values())} {inner(copy_s)}", file=sys.stderr)


def union_seconds(intervals: Iterable[Tuple[int, int]]) -> float:
    """The length of a union of (start, end) ns intervals, in s."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total * 1e-9


def host_seconds(trace, names: Iterable[str]) -> Optional[float]:
    """Host time inside any span of `names` (their union), in s; None
    where the trace holds none of them."""
    spans = attribution(trace).spans
    ops = [o for n in names for o in spans.get(n, ())]
    if not ops:
        return None
    return union_seconds((o.start, o.end) for o in ops)


def kernel_ms_per_slot(trace, names: Iterable[str]) -> Optional[float]:
    """Device time of the kernels launched inside a span of `names`, at
    any depth, in ms a simulated slot; None where the trace holds none
    of those spans or the launches do not match."""
    names = set(names)
    found = attribution(trace)
    if not names & set(found.spans) or found.kernel_s is None \
            or not trace.slots:
        return None
    s = sum(v for stack, v in found.kernel_s.items() if names & set(stack))
    return s * 1e3 / trace.slots
