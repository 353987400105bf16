"""Cells cut to a size the CPU tests can hold: the manifest's cells with
a 24-server cluster (racks of 6, or racks of 4 in pods of 12), a batch of
24, 2 loads x 3 estimates x 2 seeds and 40 slots.  Private routing goes
through `kernels.ops.fleet_route`, as on the card, whose plain version
runs off the card."""

from __future__ import annotations

import dataclasses

from portbench import spec

CLUSTERS = {"rack10k": dict(num_servers=24, group_sizes=[6]),
            "fattree8k": dict(num_servers=24, group_sizes=[4, 12])}


def cut(name: str, horizon: int = 40, warmup: int = 10) -> spec.Cell:
    cell = spec.cell(name)
    config = dict(cell.config, **CLUSTERS[cell.config["name"]],
                  max_arrivals=24,
                  fleet=dict(cell.config["fleet"], use_kernel=True))
    traffic = dict(cell.traffic, loads=[0.6, 0.95], eps_grid=[0.3],
                   seeds_per_study=2, horizon=horizon, warmup=warmup)
    return dataclasses.replace(cell, config=config, traffic=traffic)
