"""Drift study on the port: fixed-prior vs blind-EWMA Balanced-PANDAS
under the registered time-varying scenarios (the experiment the paper
motivates but never runs).

    python -m repro_torch.examples.drift_study [--full | --smoke]
    python -m repro_torch.examples.drift_study --scenarios stragglers,mmpp
    python -m repro_torch.examples.drift_study --topology k4

Both arms start from the exact static rates, so the fixed prior is the
best possible frozen estimate; any blind win is pure drift-tracking.
Writes experiments/figures_torch/drift_study{,_k4}.csv and prints the
per-scenario table.  ``--topology k4`` runs the same study on the pod
topology (Topology(24, (6, 12)), 4-tier rates).  ``--smoke``: 2
scenarios x 2 policies at a tiny horizon, asserting only that every run
stays stable (throughput tracks arrivals).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.core import locality as loc, robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, smoke_study

SMOKE_SCENARIOS = ("stragglers", "rack_congestion")  # 2 x 2 arms


def sim_cfg(topology: str, horizon: int, warmup: int) -> sim.SimConfig:
    if topology == "k4":
        return sim.SimConfig(topo=loc.Topology(24, (6, 12)),
                             true_rates=loc.Rates((0.5, 0.45, 0.35, 0.25)),
                             max_arrivals=24, horizon=horizon, warmup=warmup)
    return sim.default_config(horizon=horizon, warmup=warmup)


def assert_stable(study) -> None:
    """Every arm keeps up with the offered load: throughput over 0.9 x
    lam in every scenario."""
    lam = study["load"] * study["capacity"]
    for scen in study["scenarios"]:
        for arm in study["arms"]:
            thr = float(study["throughput"][scen][arm].mean())
            assert thr > 0.9 * lam, (scen, arm, thr, lam)


def write_csv(study, seeds, path: Path) -> None:
    """One row a (scenario, arm, seed): delay, throughput, final_n."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["scenario", "arm", "seed", "mean_delay", "throughput",
                    "final_n"])
        for scen in study["scenarios"]:
            for arm in study["arms"]:
                for si, seed in enumerate(seeds):
                    w.writerow([
                        scen, arm, seed,
                        float(study["delay"][scen][arm][si]),
                        float(study["throughput"][scen][arm][si]),
                        float(study["final_n"][scen][arm][si]),
                    ])


def run(cfg: rb.StudyConfig, scenarios, smoke: bool = False,
        topology: str = "k3", device=None, outdir: Path = FIG_DIR):
    """The study and its table; with `smoke` the stability gate, else the
    CSV.  Returns the study."""
    device = resolve_device(device)
    study = rb.drift_study(cfg, scenarios=scenarios, device=device)
    print(rb.summarize_drift(study))
    if smoke:
        assert_stable(study)
        print("scenario smoke OK")
        return study
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = "" if topology == "k3" else f"_{topology}"
    path = outdir / f"drift_study{suffix}.csv"
    write_csv(study, cfg.seeds, path)
    print(f"wrote {path}")
    return study


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: 2 scenarios x 2 policies, tiny horizon")
    ap.add_argument("--scenarios", default=None,
                    help="comma list (default: all registered drift scenarios)")
    ap.add_argument("--topology", default="k3", choices=("k3", "k4"),
                    help="k3: the paper's flat racks; k4: pods "
                         "(Topology(24, (6, 12)), 4-tier rates)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = smoke_study()
        scenarios = SMOKE_SCENARIOS
    elif args.full:
        cfg = rb.StudyConfig(sim=sim_cfg(args.topology, 30_000, 8_000),
                             seeds=(0, 1))
        scenarios = rb.DRIFT_SCENARIOS
    else:
        cfg = rb.StudyConfig(sim=sim_cfg(args.topology, 8_000, 2_000),
                             seeds=(0,))
        scenarios = rb.DRIFT_SCENARIOS
    if args.scenarios:
        scenarios = tuple(s.strip() for s in args.scenarios.split(","))
    return run(cfg, scenarios, smoke=args.smoke, topology=args.topology,
               device=device)


if __name__ == "__main__":
    main()
