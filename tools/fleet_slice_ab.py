#!/usr/bin/env python3
"""Time the one-cell fleet slice of two or more source trees, in turns.

    python3 tools/fleet_slice_ab.py ROOT_A ROOT_B [--pairs 5]

Each turn runs in a fresh process that imports `repro_torch` from
ROOT/src, builds that tree's `fleet_route` kernel, and times one
`simulate("balanced_pandas", ...)` call on the card at the configuration
of `chip_smoke.py` phase 4 (Topology(10008, 6), rho 0.8 of the hot-rack
capacity, max_arrivals 5474, horizon 512, warmup 128, estimates
"network" eps 0.2 sign -1, seed 0), set-up included, as that phase
does.  It prints one JSON line a turn (the tree, slots/s over the call,
the mean delay), then the median slots/s of each tree.  The turns of a
pair alternate their order (A B, B A, A B, ...), so that neither tree
always runs first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def turn(root: str) -> dict:
    """One timed call of the fleet slice with the package under `root`."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.core import locality as loc, simulator as sim
    from repro_torch.kernels import _build

    _build.build_all(["fleet_route"])
    topo, rates = loc.Topology(10008, 6), loc.Rates()
    lam = 0.8 * loc.capacity_hot_rack(topo, rates, 0.5)
    cfg = sim.SimConfig(topo, rates, p_hot=0.5,
                        max_arrivals=int(2.05 * lam), horizon=512,
                        warmup=128)
    est = sim.make_estimates(cfg, "network", 0.2, -1)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.simulate("balanced_pandas", cfg, lam, est, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tree": root, "slots_per_s": cfg.horizon / wall, "wall_s": wall,
            "mean_delay": out["mean_delay"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", help="source trees to compare")
    ap.add_argument("--pairs", type=int, default=5,
                    help="turns of each tree")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.roots[0])), flush=True)
        return 0
    rates = {root: [] for root in args.roots}
    for i in range(args.pairs):
        order = args.roots if i % 2 == 0 else args.roots[::-1]
        for root in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn", root],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            rates[root].append(row["slots_per_s"])
            print(json.dumps(row), flush=True)
    print(json.dumps({"median_slots_per_s": {
        root: statistics.median(r) for root, r in rates.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
