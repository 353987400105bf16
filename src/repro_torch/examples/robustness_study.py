"""Full reproduction of the paper's Figures 1-6 (robustness of scheduling
algorithms to processing-rate estimation errors) on the port.

    python -m repro_torch.examples.robustness_study [--full]

Writes experiments/figures_torch/robustness_study.csv and prints the
per-figure summaries plus the headline-claims check.  --full uses
paper-scale horizons; the default is a reduced but qualitatively
faithful sweep.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.examples import FIG_DIR, figures


def summarize(name: str, out) -> None:
    """Print one figure's point count and, per algo, its worst delay and
    largest sensitivity."""
    print(f"-- {name}: {len(out)} points")
    for algo in sorted({r["algo"] for r in out}):
        sub = [r for r in out if r["algo"] == algo]
        worst = max(r["mean_delay"] for r in sub)
        sens = max((abs(r.get("sensitivity", 0.0)) for r in sub),
                   default=0.0)
        print(f"   {algo:16s} worst delay {worst:8.2f} slots"
              f"   max sensitivity {sens:6.1%}")


def write_csv(rows, outdir: Path = FIG_DIR) -> Path:
    """The rows as ``robustness_study.csv`` under `outdir`: one column a
    key of any row, sorted."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    path = outdir / "robustness_study.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    return path


def run(fast: bool = True, device=None, outdir: Path = FIG_DIR):
    """Figures 1-6, their summaries, the headline claims and the CSV;
    returns (rows, claims)."""
    device = resolve_device(device)
    rows = []
    for name, fn in (("fig1", figures.fig1_precise),
                     ("fig2", figures.fig2_highload),
                     ("fig3/4", figures.fig34_under),
                     ("fig5/6", figures.fig56_over)):
        out = fn(fast, device=device)
        rows.extend(out)
        summarize(name, out)
    claims = figures.headline_claims(rows)
    print("headline claims:", claims)
    print(f"wrote {write_csv(rows, outdir)}")
    return rows, claims


def main(argv: Optional[Sequence[str]] = None, device=None) -> None:
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    run(fast=not args.full, device=device)


if __name__ == "__main__":
    main()
