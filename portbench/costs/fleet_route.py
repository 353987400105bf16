"""Cost of one launch of ``fleet_route`` (``csrc/fleet_route.cu``): the
fused workload and private argmin of a slot's B tasks in each of N
cells, over M servers, K tiers and a (D, M) ancestor table.

Counted from shapes alone: each input read once (q, serving, est and the
tasks' locals per cell; the ancestor table once across cells), each
output written once (server, tier, score per task), whatever the kernel
reads again.  The operations are the fewest these inputs need: the
workload (K divides, K - 1 adds, the residual's divide and add a
server) and a divide, a multiply and a subtract for each (task, server)
pair of the task's private set, which holds at least one whole
top-level group.
"""

from __future__ import annotations

from portbench import peaks

KERNEL = "fleet_route_kernel"   # substring of the kernel's name in a trace


def bytes_moved(cells: int, servers: int, tiers: int, depth: int,
                batch: int) -> int:
    per_cell = (4 * (servers * tiers + servers + servers * tiers + 3 * batch)
                + 12 * batch)
    return cells * per_cell + 4 * depth * servers


def operations(cells: int, servers: int, tiers: int, batch: int,
               top_group: int) -> int:
    return cells * (servers * (2 * tiers + 1) + 3 * batch * top_group)


def bound_seconds(cells: int, servers: int, tiers: int, depth: int,
                  batch: int, top_group: int):
    """(seconds, "bytes" or "operations"): the least time one launch can
    take on the card, and which of the two terms sets it."""
    t_bytes = bytes_moved(cells, servers, tiers, depth, batch) \
        / peaks.HBM_BYTES_PER_S
    t_ops = operations(cells, servers, tiers, batch, top_group) \
        / peaks.F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
