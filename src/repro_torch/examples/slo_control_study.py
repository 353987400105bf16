"""SLO control study on the port: what each control-plane lever buys at
the tail.

The paper compares schedulers under a FIXED offered load; a production
cluster also gets to refuse and reshape that load.  This study runs the
control-plane arms {none, admission, autoscale, both} for the
mean-optimal scheduler (``balanced_pandas``) and its SLO-conditioned
variant (``slo_pandas``) at rho in {0.90, 0.95, 0.99} of the static
fluid capacity, telemetry on:

  * **admission** — a token bucket refilling at 93% of capacity: at
    rho = 0.99 it sheds the few percent of arrivals that push the system
    past the stability knee, collapsing the p99;
  * **autoscale** — the proactive headroom planner: a no-op at the knee
    (everything stays on) but the descale floor shows up at moderate rho;
  * **slo_pandas** — scheduling-only control: drains the longest queues
    while the live p99 estimate breaches the SLO, shedding nothing.

Means use the MEASURED admitted rate as the Little's-law denominator, so
they stay comparable across arms.

    python -m repro_torch.examples.slo_control_study [--full | --smoke]

Writes experiments/figures_torch/slo_control.csv and prints the per-load
table.  ``--smoke``: a tiny horizon with a bitwise gate (``control=None``
builds NOTHING — every metric of every registered policy is bitwise
identical to the uncontrolled simulator) and a shed-rate sanity gate
(the admission arm sheds at rho = 0.99).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import locality as loc, robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, smoke_sim, smoke_study

METRICS = ("mean", "p50", "p95", "p99", "shed_rate", "throughput")


def smoke(cfg_s: sim.SimConfig, cfg: rb.StudyConfig, device=None):
    """The bitwise gate for every registered policy and the shed gate on
    `cfg_s`, then the study at rho 0.99 on `cfg`.  Returns the study."""
    from repro_torch.core.policy import available_policies
    device = resolve_device(device)
    # Bitwise gate: control=None must run the exact uncontrolled loop
    # for every registered policy (slo_pandas without telemetry
    # included: signals are absent, so it IS balanced_pandas).
    est = sim.make_estimates(cfg_s, "network", 0.0, -1)
    for pol in available_policies():
        off = sim.simulate(pol, cfg_s, 3.0, est, seed=0, device=device)
        on = sim.simulate(pol, cfg_s, 3.0, est, seed=0, control=None,
                          device=device)
        for k, v in off.items():
            assert np.array_equal(np.asarray(v), np.asarray(on[k])), \
                (pol, k)

    # Shed gate: one overloaded arm with the study's token bucket
    # must shed and stay conserved (offered == admitted + shed).
    cap = loc.capacity_hot_rack(cfg_s.topo, cfg_s.true_rates, cfg_s.p_hot)
    res = sim.simulate(
        "balanced_pandas", cfg_s, 1.2 * cap, est, seed=0,
        control=rb.control_arm_spec("admission", cap), device=device)
    shed = float(res["ctl_shed_rate"])
    assert 0.0 < shed < 1.0, shed
    assert int(res["ctl_offered"]) == \
        int(res["ctl_admitted"]) + int(res["ctl_shed"])

    study = rb.control_study(cfg, loads=(0.99,), device=device)
    print(rb.summarize_control(study))
    adm = study["shed_rate"]["balanced_pandas"]["admission"]
    assert float(np.mean(adm)) > 0.0, "admission arm shed nothing"
    print("slo-control smoke OK")
    return study


def write_csv(study, seeds, path: Path) -> None:
    """One row a (policy, arm, load, seed)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["policy", "arm", "load", "seed", "mean_delay",
                    "delay_p50", "delay_p95", "delay_p99", "shed_rate",
                    "throughput"])
        for pol in study["policies"]:
            for arm in study["arms"]:
                for li, rho in enumerate(study["loads"]):
                    for si, seed in enumerate(seeds):
                        w.writerow(
                            [pol, arm, float(rho), seed]
                            + [float(study[m][pol][arm][li][si])
                               for m in METRICS])


def run(cfg: rb.StudyConfig, loads: Sequence[float], device=None,
        outdir: Path = FIG_DIR):
    """The study, its table and its CSV.  Returns the study."""
    device = resolve_device(device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    study = rb.control_study(cfg, loads=tuple(loads), device=device)
    print(rb.summarize_control(study))
    path = outdir / "slo_control.csv"
    write_csv(study, cfg.seeds, path)
    print(f"wrote {path}")
    return study


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: tiny horizon, bitwise + shed gates")
    ap.add_argument("--loads", type=float, nargs="+",
                    default=(0.90, 0.95, 0.99))
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(smoke_sim(400, 100), smoke_study(), device)
    horizon, warmup = (40_000, 10_000) if args.full else (12_000, 3_000)
    seeds = (0, 1) if args.full else (0,)
    cfg = rb.StudyConfig(
        sim=sim.default_config(horizon=horizon, warmup=warmup), seeds=seeds)
    return run(cfg, args.loads, device)


if __name__ == "__main__":
    main()
