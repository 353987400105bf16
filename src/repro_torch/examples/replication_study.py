"""Replication-lifecycle study on the port: what adaptive replication and
failure repair buy (and cost) when the scenario actually kills servers.

The study sweeps the registered controllers (fixed / popularity /
repair) against the failure scenarios (server_loss, rack_loss) for the
two schedulers whose robustness gap the paper cares about
(Balanced-PANDAS vs JSQ-MW), at rho in {0.7, 0.95} of the *healthy*
static fluid capacity — so the delay deltas decompose into capacity
lost to dead servers and foreground slots consumed by the
re-replication storm.

    python -m repro_torch.examples.replication_study [--full | --smoke]

Writes experiments/figures_torch/replication_study.csv and prints the
per-scenario tables.  ``--smoke``: one scenario, tiny horizon, with a
bitwise gate (replication="fixed" under a static scenario reproduces
the default sample path) and a repair gate (the repair controller
actually restores the replication factor the loss window destroyed).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.core import locality as loc, robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, smoke_sim, smoke_study

METRICS = ("delay", "throughput", "availability", "data_loss",
           "mean_replication", "repair_moves")


def smoke(cfg_s: sim.SimConfig, cfg: rb.StudyConfig, load: float,
          device=None):
    """The bitwise gate on `cfg_s`, then server_loss at `load` on `cfg`
    with the repair gate.  Returns the study."""
    device = resolve_device(device)
    # bitwise gate: fixed + static IS the default sample path
    est = sim.make_estimates(cfg_s, "network", 0.0, -1)
    base = sim.simulate("balanced_pandas", cfg_s, 3.0, est, seed=0,
                        device=device)
    fixed = sim.simulate("balanced_pandas", cfg_s, 3.0, est, seed=0,
                         replication="fixed", device=device)
    assert base == fixed, (base, fixed)

    study = rb.replication_study(cfg, scenarios=("server_loss",),
                                 policies=("balanced_pandas",),
                                 loads=(load,), device=device)
    print(rb.summarize_replication(study))
    # repair gate: the repair controller ends the run back at factor 3,
    # the no-repair control arm does not
    rep = study["mean_replication"]["server_loss"]
    fix_r = float(rep["fixed"]["balanced_pandas"][0].mean())
    rep_r = float(rep["repair"]["balanced_pandas"][0].mean())
    assert rep_r > fix_r, (fix_r, rep_r)
    mv = study["repair_moves"]["server_loss"]
    assert float(mv["repair"]["balanced_pandas"][0].mean()) > 0
    assert float(mv["fixed"]["balanced_pandas"][0].mean()) == 0
    print("replication smoke OK")
    return study


def write_csv(study, seeds, path: Path) -> None:
    """One row a (scenario, controller, policy, load, seed)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["scenario", "controller", "policy", "load", "seed",
                    "mean_delay", "throughput", "availability",
                    "data_loss_frac", "mean_replication", "repair_moves"])
        for scen in study["scenarios"]:
            for ctrl in study["replications"]:
                for pol in study["policies"]:
                    for li, rho in enumerate(study["loads"]):
                        for si, seed in enumerate(seeds):
                            cell = [study[m][scen][ctrl][pol]
                                    for m in METRICS]
                            w.writerow([scen, ctrl, pol, float(rho), seed]
                                       + [float(c[li][si]) for c in cell])


def run(cfg: rb.StudyConfig, loads: Sequence[float], device=None,
        outdir: Path = FIG_DIR):
    """The study, its table and its CSV.  Returns the study."""
    device = resolve_device(device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    study = rb.replication_study(cfg, loads=tuple(loads), device=device)
    print(rb.summarize_replication(study))
    path = outdir / "replication_study.csv"
    write_csv(study, cfg.seeds, path)
    print(f"wrote {path}")
    return study


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: one scenario, tiny horizon")
    ap.add_argument("--loads", type=float, nargs="+", default=(0.7, 0.95))
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(smoke_sim(400, 100), smoke_study(1200, 300),
                     args.loads[0], device)
    horizon, warmup = (30_000, 8_000) if args.full else (8_000, 2_000)
    seeds = (0, 1) if args.full else (0,)
    cfg = rb.StudyConfig(
        sim=sim.SimConfig(topo=loc.Topology(24, 6), true_rates=loc.Rates(),
                          p_hot=0.5, max_arrivals=24, horizon=horizon,
                          warmup=warmup),
        seeds=seeds)
    return run(cfg, args.loads, device)


if __name__ == "__main__":
    main()
