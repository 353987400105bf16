"""``fleet_route``'s share of its roofline, in %: the least time its
launches could take (`portbench.costs.fleet_route`, at the cell's N, M,
K, D and B) over the time they took on the device."""

from portbench.costs import fleet_route as cost


def read(trace):
    runs = [k for k in trace.kernels if cost.KERNEL in k.name]
    if not runs:
        return None
    shape = trace.shape
    bound, _ = cost.bound_seconds(shape["cells"], shape["servers"],
                                  shape["tiers"], shape["depth"],
                                  shape["batch"], shape["top_group"])
    return 100.0 * bound * len(runs) / sum(k.seconds for k in runs)
