"""Derives the delay band of the port's drift study against the JAX
reference's, on the CPU (tests/test_torch_drift_study.py states it).

    PYTHONPATH=src python tools/drift_band.py [--sets 3] [--seeds 24]
        [--scenarios stragglers,rack_congestion]

Runs both drift studies at Topology(24, 6), load 0.75, horizon 1500 /
warmup 500, for the given scenarios: the reference on
seeds 0..N-1 (its own key schedule), the port on `--sets` disjoint sets
of N seeds (its own draws), and prints each arm's mean delay, the seed
std and the relative gap of each port set to the reference.
"""

from __future__ import annotations

import argparse

import torch

from repro.core import robustness as rrb, simulator as rsim
from repro_torch.core import robustness as rb, simulator as sim

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--scenarios", default="stragglers,rack_congestion")
    args = ap.parse_args(argv)
    scenarios = tuple(args.scenarios.split(","))
    torch.set_num_threads(1)
    n = args.seeds
    ref = rrb.drift_study(rrb.StudyConfig(
        sim=rsim.default_config(horizon=1500, warmup=500),
        seeds=tuple(range(n))), scenarios)
    ports = [rb.drift_study(rb.StudyConfig(
        sim=sim.default_config(horizon=1500, warmup=500),
        seeds=tuple(range(100 * (i + 1), 100 * (i + 1) + n))), scenarios,
        device="cpu") for i in range(args.sets)]
    for scen in scenarios:
        for arm in ("fixed_prior", "blind_ewma"):
            d = ref["delay"][scen][arm]
            line = (f"{scen:16s} {arm:12s} reference {d.mean():.4f} "
                    f"(seed std {d.std(ddof=1):.4f})  port")
            for p in ports:
                g = p["delay"][scen][arm]
                line += (f" {g.mean():.4f} ({g.mean() / d.mean() - 1:+.2%},"
                         f" std {g.std(ddof=1):.4f})")
            print(line, flush=True)


if __name__ == "__main__":
    main()
