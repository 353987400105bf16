"""Share of the program's slot loop (its span ``fleet.loop``) in which
no operation ran on the device, in %."""

from portbench import spans


def read(trace):
    loops = spans.attribution(trace).spans.get("fleet.loop")
    if not loops:
        return None
    length = sum(o.end - o.start for o in loops) * 1e-9
    busy = spans.union_seconds(
        (max(a, o.start), min(b, o.end)) for o in loops
        for a, b in trace.merged if a < o.end and b > o.start)
    return 100.0 * (1.0 - busy / length) if length > 0 else None
