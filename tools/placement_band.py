"""Derives the delay band of the port's placement study against the JAX
reference's, on the CPU (tests/test_torch_placement_sim.py states it).

    PYTHONPATH=src python tools/placement_band.py [--sets 3] [--seeds 16]
        [--horizon 600] [--test-seeds 4]

Runs both placement studies at Topology(24, 6), load 0.7, horizon H /
warmup H/4, Balanced-PANDAS under the static scenario on the four
placements: the reference on seeds 0..N-1 (its own key schedule), the
port on `--sets` disjoint sets of N seeds (its own draws).  Prints each
placement's mean delay and seed std, each port set's relative gap, and
the band a test comparing the two packages' means over `--test-seeds`
seeds needs: the largest gap plus three standard errors of the
difference of two such means.  Then the port's fluid capacity of each
placement from 300 sampled types over 20 seeds: mean, std and the
tolerance two independent samples need (three standard deviations of
their difference, relative).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro.core import robustness as rrb
from repro_torch.core import robustness as rb


def _cfg(mod, horizon, seeds):
    return mod.StudyConfig(
        sim=mod.sim.SimConfig(mod.loc.Topology(24, 6), mod.loc.Rates(),
                              horizon=horizon, warmup=horizon // 4),
        seeds=tuple(seeds))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=600)
    ap.add_argument("--test-seeds", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    n, h = args.seeds, args.horizon
    kw = dict(policies=("balanced_pandas",), scenarios=("static",),
              load=0.7, capacity_samples=300)
    ref = rrb.placement_study(_cfg(rrb, h, range(n)), **kw)
    ports = [rb.placement_study(
        _cfg(rb, h, range(100 * (i + 1), 100 * (i + 1) + n)), **kw,
        device="cpu") for i in range(args.sets)]
    band = 0.0
    for plc in rrb.PLACEMENTS:
        d = ref["delay"][plc]["static"]["balanced_pandas"]
        line = (f"{plc:10s} reference {d.mean():.4f} (seed std "
                f"{d.std(ddof=1):.4f})  port")
        stds, gaps = [d.std(ddof=1)], []
        for p in ports:
            g = p["delay"][plc]["static"]["balanced_pandas"]
            gaps.append(abs(g.mean() / d.mean() - 1))
            stds.append(g.std(ddof=1))
            line += (f" {g.mean():.4f} ({g.mean() / d.mean() - 1:+.2%}, "
                     f"std {g.std(ddof=1):.4f})")
        se = max(stds) * np.sqrt(2.0 / args.test_seeds) / d.mean()
        need = max(gaps) + 3 * se
        band = max(band, need)
        print(f"{line}  needs {need:.2%}", flush=True)
    print(f"band over {args.test_seeds} seeds at horizon {h}: {band:.2%}")
    from repro_torch.core import locality as loc
    from repro_torch.placement import placement_capacity
    topo = loc.Topology(24, 6)
    for plc in rb.PLACEMENTS:
        c = np.array([placement_capacity(topo, loc.Rates(), 0.5, plc,
                                         n_samples=300, seed=s, device="cpu")
                      for s in range(20)])
        print(f"{plc:10s} capacity over 300 types: mean {c.mean():.4f} std "
              f"{c.std(ddof=1):.4f} needs "
              f"{3 * np.sqrt(2) * c.std(ddof=1) / c.mean():.2%}")


if __name__ == "__main__":
    main()
