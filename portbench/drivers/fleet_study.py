"""Driver of a fleet robustness study: the user's entry
``repro_torch.core.robustness.run_study(..., fleet=FleetConfig)`` over a
grid of loads x estimates x seeds, one whole study a call.

The mix (``traffic/<mix>.json``) gives the policy (and power-of-d's
``d``), the grid, the seeds a study and the study's horizon and warm-up;
the configuration gives the cluster, its rates, the batch and the fleet
path's settings.  ``correct`` compares every cell of every study of the
window with the plain reference (``reference/fleet.py``), bit for bit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.reference import fleet as ref

WARM_SLOTS = 4


def seeds(cell, seed: int) -> List[int]:
    """The study's seeds for ``--seed s``: n s ... n s + n - 1, n the
    mix's seeds a study."""
    n = int(cell.traffic["seeds_per_study"])
    return [n * int(seed) + i for i in range(n)]


def cells_per_study(cell) -> int:
    t = cell.traffic
    estimates = 1 + len(t["eps_grid"]) * len(t["signs"])
    return len(t["loads"]) * estimates * int(t["seeds_per_study"])


def shape(cell) -> Dict[str, int]:
    """The sizes the cost counts read."""
    c = cell.config
    groups = c["group_sizes"]
    return {"cells": cells_per_study(cell), "servers": c["num_servers"],
            "tiers": len(groups) + 2, "depth": len(groups),
            "batch": c["max_arrivals"],
            "top_group": groups[-1] if groups else c["num_servers"]}


def candidates(traffic: Dict[str, Any]) -> int:
    """Uniform candidates a task draws: the mix's ``d`` under power-of-d,
    else 0."""
    return int(traffic["d"]) if traffic["policy"] == "pandas_po2" else 0


def study_config(cell, study_seeds, loads, eps_grid, horizon: int,
                 warmup: int):
    """The program's `StudyConfig` and `FleetConfig` for the cell."""
    from repro_torch.core import locality as loc
    from repro_torch.core import robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.sharding.sim import FleetConfig

    c, t = cell.config, cell.traffic
    sim_cfg = sim.SimConfig(
        topo=loc.Topology(c["num_servers"], tuple(c["group_sizes"])),
        true_rates=loc.Rates(tuple(c["rates"])), p_hot=c["p_hot"],
        max_arrivals=c["max_arrivals"], horizon=horizon, warmup=warmup)
    study = rb.StudyConfig(sim=sim_cfg, loads=tuple(loads),
                           eps_grid=tuple(eps_grid),
                           error_mode=t["error_mode"],
                           seeds=tuple(study_seeds))
    return study, FleetConfig(**c["fleet"])


def run_study(cell, study, fleet, device) -> Dict[str, np.ndarray]:
    """One call of the user's entry; the (L, E, S) outputs."""
    from repro_torch.core import robustness as rb

    policy = cell.traffic["policy"]
    out = rb.run_study(study, algos=(policy,),
                       signs=tuple(cell.traffic["signs"]), fleet=fleet,
                       device=device)
    return {"delay": out["delay"][policy],
            "throughput": out["throughput"][policy],
            "final_n": out["final_n"][policy]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Study:
    """The cell's study at one ``--seed``."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.sharding import sim as fleet_sim

        t = cell.traffic
        entry_d = fleet_sim.candidates(t["policy"])
        if entry_d != candidates(t):
            raise ValueError(f"the entry runs {t['policy']} with "
                             f"{entry_d} candidates; the mix asks for "
                             f"{candidates(t)}")
        self.cell, self.device = cell, torch.device(device)
        self.seeds = seeds(cell, seed)
        self.slots = int(t["horizon"])
        self.shape = shape(cell)
        self.cells = cells_per_study(cell)
        self.study, self.fleet = study_config(
            cell, self.seeds, t["loads"], t["eps_grid"], t["horizon"],
            t["warmup"])

    def warm(self) -> None:
        """A study of one cell (the highest load, exact rates, the first
        seed) for a few slots, on the cell's own cluster, batch and fleet
        path: every operation of a slot runs once and the built
        fleet_route library is loaded.  The program runs eager PyTorch
        and one nvcc-built library, which compile nothing per shape."""
        t = self.cell.traffic
        warm, _ = study_config(self.cell, self.seeds[:1], t["loads"][-1:],
                               (), WARM_SLOTS, 1)
        run_study(self.cell, warm, self.fleet, self.device)
        _sync(self.device)

    def call(self) -> Dict[str, np.ndarray]:
        out = run_study(self.cell, self.study, self.fleet, self.device)
        _sync(self.device)
        return out

    def end_to_end(self, calls: int, seconds: float) -> Dict[str, float]:
        return {"cell_slots_per_s": calls * self.cells * self.slots / seconds}

    def attempted(self, calls: int) -> int:
        return calls * self.cells

    def reference(self, dtype=torch.float32) -> Dict[str, np.ndarray]:
        return ref.study(self.cell.config, self.cell.traffic, self.seeds,
                         self.device, dtype=dtype)

    def check(self, outputs):
        want = self.reference()
        unequal = sum(ref.compare(out, want) for out in outputs)
        return {"cells_unequal": {"value": unequal, "limit": 0}}, unequal


def prepare(cell, seed: int, device) -> Study:
    return Study(cell, seed, device)


def control(cell, seed: int, device, program: bool) -> Dict[str, Any]:
    """At the cell's own size: the control, the plain reference computed
    in bfloat16 in the program's place, against the float32 reference;
    with ``program``, the program's own study against it too."""
    work = Study(cell, seed, device) if program else None
    study_seeds = seeds(cell, seed)
    t0 = time.perf_counter()
    want = ref.study(cell.config, cell.traffic, study_seeds, device)
    row = {"reference_s": time.perf_counter() - t0,
           "cells": int(want["delay"].size)}
    ctl = ref.study(cell.config, cell.traffic, study_seeds, device,
                    dtype=torch.bfloat16)
    row["control_cells_unequal"] = ref.compare(ctl, want)
    row["control_delay_max_rel_gap"] = float(
        abs(ctl["delay"] / want["delay"] - 1).max())
    if work is not None:
        work.warm()
        row["program_cells_unequal"] = ref.compare(work.call(), want)
    return row
