"""Tail-latency study on the port: p50/p95/p99 sojourn vs the
Little's-law mean in heavy traffic.

The paper's comparison is stated in mean delay, but a production SLO is
a percentile — and mean ordering between schedulers need not match tail
ordering.  The dense simulator's recorder (`repro_torch.telemetry`)
measures per-task sojourns in the slot loop through an FCFS-coupled
arrival-slot ring and a fixed-bin histogram, so this study sweeps rho in
{0.90, 0.95, 0.99} of the static fluid capacity for Balanced-PANDAS vs
JSQ-MaxWeight vs FIFO at K=3 and reports where the p99 winner diverges
from the mean winner.

    python -m repro_torch.examples.tail_latency_study [--full | --smoke]

Writes experiments/figures_torch/tail_latency.csv and prints the
per-load table.  ``--smoke``: a tiny horizon with a bitwise gate (the
recorder is pure observation — every metric the plain run produces is
bitwise identical with telemetry on) and a percentile sanity gate (p99
>= p95 >= p50 > 0 on a stable arm).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, smoke_sim, smoke_study


def smoke(cfg_s: sim.SimConfig, cfg: rb.StudyConfig, device=None):
    """The bitwise gate on `cfg_s` for every registered policy that reads
    no live signals, then the study at rho 0.9 on `cfg` with the
    percentile gate.  Returns the study."""
    from repro_torch.core.policy import available_policies, get_policy_cls
    device = resolve_device(device)
    # Bitwise gate: telemetry consumes no draw and mutates no policy
    # state, for every registered policy except the ones that OPT IN to
    # reading the live signals (`uses_signals`, e.g. slo_pandas).
    est = sim.make_estimates(cfg_s, "network", 0.0, -1)
    for pol in available_policies():
        if getattr(get_policy_cls(pol), "uses_signals", False):
            continue
        off = sim.simulate(pol, cfg_s, 3.0, est, seed=0, device=device)
        on = sim.simulate(pol, cfg_s, 3.0, est, seed=0, telemetry=True,
                          device=device)
        for k, v in off.items():
            assert np.array_equal(np.asarray(v), np.asarray(on[k])), \
                (pol, k)
        assert "delay_p99" in on and "delay_p99" not in off

    study = rb.tail_study(cfg, loads=(0.9,), device=device)
    print(rb.summarize_tail(study))
    # Percentile sanity on the delay-optimal arm: finite, ordered,
    # positive, and every completion matched to its arrival.
    p50, p95, p99 = (float(study[m]["balanced_pandas"][0].mean())
                     for m in ("p50", "p95", "p99"))
    assert 0.0 < p50 <= p95 <= p99 < float("inf"), (p50, p95, p99)
    assert float(study["unmatched"]["balanced_pandas"][0].mean()) == 0.0
    print("tail-latency smoke OK")
    return study


def write_csv(study, seeds, path: Path) -> None:
    """One row a (policy, load, seed): mean and percentiles."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["policy", "load", "seed", "mean_delay", "delay_p50",
                    "delay_p95", "delay_p99"])
        for pol in study["policies"]:
            for li, rho in enumerate(study["loads"]):
                for si, seed in enumerate(seeds):
                    w.writerow([pol, float(rho), seed]
                               + [float(study[m][pol][li][si])
                                  for m in ("mean", "p50", "p95", "p99")])


def run(cfg: rb.StudyConfig, loads: Sequence[float], device=None,
        outdir: Path = FIG_DIR):
    """The study, its table and its CSV.  Returns the study."""
    device = resolve_device(device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    study = rb.tail_study(cfg, loads=tuple(loads), device=device)
    print(rb.summarize_tail(study))
    path = outdir / "tail_latency.csv"
    write_csv(study, cfg.seeds, path)
    print(f"wrote {path}")
    return study


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: tiny horizon, bitwise + sanity gates")
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
