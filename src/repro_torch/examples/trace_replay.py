"""Trace replay on the port: one recorded cluster trace drives the
simulator and the live serving engine from a single compiled Scenario.

    python -m repro_torch.examples.trace_replay [--smoke | --full]
    python -m repro_torch.examples.trace_replay --trace flash_day
    python -m repro_torch.examples.trace_replay --trace path/to/my.jsonl

The pipeline:

  1. load a bundled (or user-supplied JSONL/CSV) trace and compile it to
     a piecewise `Scenario` (`repro_torch.workloads.trace`: unit-mean
     arrival normalization + change-point merging);
  2. simulator leg — the paper's drift experiment on recorded traffic:
     fixed-prior vs blind-EWMA Balanced-PANDAS replaying the trace
     (`robustness.drift_study`), results to
     experiments/figures_torch/trace_replay_<trace>.csv;
  3. serving leg — the same Scenario times request submission and
     replica slowdowns on the live continuous-batching engine
     (`replay.replay_trace`), and the run is re-recorded through the
     engine's trace export hook to
     experiments/traces_torch/replay_rerecorded.jsonl;
  4. the re-recorded trace is loaded back and compiled again, closing the
     record -> replay -> re-record loop deterministically.

``--smoke``: tiny horizons, plus assertions that every arm stays stable
and that the export hook round-trips bit-for-bit.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch import workloads as wl
from repro_torch.core import robustness as rb, simulator as sim
from repro_torch.examples import FIG_DIR, drift_study, replay, smoke_study

EXPORT = Path("experiments/traces_torch/replay_rerecorded.jsonl")


def load(trace: str):
    """A bundled trace by name, else a trace file by path."""
    if trace in wl.bundled_traces():
        return wl.load_bundled(trace)
    return wl.load_trace(trace)


def check_round_trip(export, max_segments: int):
    """The export loads back to the same trace twice and compiles to the
    same Scenario twice; returns (trace, scenario)."""
    rerec = wl.load_trace(export)
    rescn = wl.trace_to_scenario(rerec, max_segments=max_segments)
    again = wl.load_trace(export)
    assert again == rerec, "trace export must round-trip bit-for-bit"
    assert wl.trace_to_scenario(again, max_segments=max_segments) \
        == rescn, "recompiling the same trace must be deterministic"
    return rerec, rescn


def run(trace: str, cfg: rb.StudyConfig, max_segments: int = 64,
        smoke: bool = False, fast: bool = True, device=None,
        export: Path = EXPORT, outdir: Path = FIG_DIR):
    """The four steps; with `smoke` the stability gate, else the CSV.
    Returns the drift study."""
    device = resolve_device(device)
    # -- 1. one Scenario for every layer ----------------------------------
    tr = load(trace)
    scn = wl.trace_to_scenario(tr, max_segments=max_segments)
    print(f"trace {tr.name!r}: {tr.num_intervals} intervals "
          f"({tr.duration / 3600.0:.1f} h) -> {len(scn.segments)} "
          f"segments, mean lam_mult {scn.mean_lam_mult:.4f}")

    # -- 2. simulator: fixed prior vs blind EWMA on recorded traffic ------
    study = rb.drift_study(cfg, scenarios={"static": "static",
                                           scn.name: scn}, device=device)
    print(rb.summarize_drift(study))

    # -- 3. serving engine on the same Scenario ---------------------------
    rows = replay.replay_trace(scn, fast=fast, export_path=str(export),
                               device=device)
    for name, steps, derived in rows:
        print(f"{name}: drained in {steps:.0f} engine steps ({derived})")

    # -- 4. the re-recorded run replays deterministically ------------------
    rerec, rescn = check_round_trip(export, max_segments)
    print(f"re-recorded {rerec.num_intervals} intervals "
          f"({int(rerec.arrivals.sum())} arrivals) -> "
          f"{len(rescn.segments)} segments; replay round-trip OK")

    if smoke:
        drift_study.assert_stable(study)
        print("trace-replay smoke OK")
        return study

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    csv_path = outdir / f"trace_replay_{tr.name}.csv"
    drift_study.write_csv(study, cfg.seeds, csv_path)
    print(f"wrote {csv_path}")
    return study


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="diurnal_week",
                    help="bundled trace name, or a path to a .jsonl/.csv "
                         "trace file")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale horizons")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: tiny horizons + determinism assertions")
    ap.add_argument("--max-segments", type=int, default=64)
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = smoke_study()
    elif args.full:
        cfg = rb.StudyConfig(sim=sim.default_config(horizon=30_000,
                                                    warmup=8_000),
                             seeds=(0, 1))
    else:
        cfg = rb.StudyConfig(sim=sim.default_config(horizon=8_000,
                                                    warmup=2_000),
                             seeds=(0,))
    return run(args.trace, cfg, args.max_segments, smoke=args.smoke,
               fast=not args.full, device=device)


if __name__ == "__main__":
    main()
