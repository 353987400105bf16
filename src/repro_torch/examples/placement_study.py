"""Placement x policy study on the port: what hierarchy-aware replica
placement buys each scheduler, at K=3 (flat racks) and K=4 (pods).

The study sweeps the registered placements (uniform / hdfs / spread /
hot_aware) against one policy per family (full-scan PANDAS, blind-EWMA
PANDAS, MaxWeight) under the scenarios that move locality and network
structure (hot_shift, rack_congestion), at the same offered load —
`0.7 x` the uniform static fluid capacity — so every delta is a
placement effect.

    python -m repro_torch.examples.placement_study [--full | --smoke]
    python -m repro_torch.examples.placement_study --topology k4

Writes experiments/figures_torch/placement_study_{k3,k4}.csv and prints
the per-scenario tables.  ``--smoke``: one topology, one scenario, tiny
horizon, with a stability gate (every arm's throughput tracks the
offered load) and a bitwise gate (placement="uniform" reproduces the
default sample path).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.core import locality as loc, robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, smoke_sim, smoke_study


def _topologies(which: str):
    k3 = ("k3", loc.Topology(24, 6), loc.Rates())
    k4 = ("k4", loc.Topology(24, (6, 12)), loc.Rates((0.5, 0.45, 0.35,
                                                      0.25)))
    return {"k3": (k3,), "k4": (k4,), "both": (k3, k4)}[which]


def smoke(cfg_s: sim.SimConfig, cfg: rb.StudyConfig, load: float,
          device=None):
    """The bitwise gate on `cfg_s`, then the hot_shift study on `cfg`
    with its stability gate.  Returns the study."""
    device = resolve_device(device)
    # bitwise gate: the uniform placement IS the default sample path
    est = sim.make_estimates(cfg_s, "network", 0.0, -1)
    base = sim.simulate("balanced_pandas", cfg_s, 3.0, est, seed=0,
                        device=device)
    unif = sim.simulate("balanced_pandas", cfg_s, 3.0, est, seed=0,
                        placement="uniform", device=device)
    assert base == unif, (base, unif)

    study = rb.placement_study(cfg, scenarios=("hot_shift",), load=load,
                               capacity_samples=500, device=device)
    print(rb.summarize_placement(study))
    lam = study["load"] * study["capacity_uniform"]
    for plc in study["placements"]:
        for pol in study["policies"]:
            thr = float(study["throughput"][plc]["hot_shift"][pol].mean())
            assert thr > 0.9 * lam, (plc, pol, thr, lam)
    print("placement smoke OK")
    return study


def write_csv(study, label: str, seeds, path: Path) -> None:
    """One row a (placement, scenario, policy, seed)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["topology", "placement", "fluid_capacity",
                    "scenario", "policy", "seed", "mean_delay",
                    "throughput", "final_n"])
        for plc in study["placements"]:
            cap = study["capacity"][plc]
            for scen in study["scenarios"]:
                for pol in study["policies"]:
                    for si, seed in enumerate(seeds):
                        w.writerow([
                            label, plc,
                            "" if cap is None else f"{cap:.4f}",
                            scen, pol, seed,
                            float(study["delay"][plc][scen][pol][si]),
                            float(study["throughput"][plc][scen][pol][si]),
                            float(study["final_n"][plc][scen][pol][si]),
                        ])


def run(cfgs: Sequence[Tuple[str, rb.StudyConfig]], load: float,
        device=None, outdir: Path = FIG_DIR):
    """The study for each ``(label, cfg)``: its table and its CSV.
    Returns ``{label: study}``."""
    device = resolve_device(device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = {}
    for label, cfg in cfgs:
        study = rb.placement_study(cfg, load=load, device=device)
        topo = cfg.sim.topo
        print(f"== {label}: M={topo.num_servers}, K={topo.num_tiers} ==")
        print(rb.summarize_placement(study))
        path = outdir / f"placement_study_{label}.csv"
        write_csv(study, label, cfg.seeds, path)
        print(f"wrote {path}")
        out[label] = study
    return out


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: one topology/scenario, tiny horizon")
    ap.add_argument("--topology", default="both", choices=("k3", "k4",
                                                           "both"))
    ap.add_argument("--load", type=float, default=0.7)
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(smoke_sim(400, 100), smoke_study(), args.load, device)
    horizon, warmup = (30_000, 8_000) if args.full else (8_000, 2_000)
    seeds = (0, 1) if args.full else (0,)
    cfgs = [(label, rb.StudyConfig(
        sim=sim.SimConfig(topo=topo, true_rates=rates, p_hot=0.5,
                          max_arrivals=24, horizon=horizon, warmup=warmup),
        seeds=seeds)) for label, topo, rates in _topologies(args.topology)]
    return run(cfgs, args.load, device)


if __name__ == "__main__":
    main()
