"""The reference's tail-latency study at the cut depth `chip_smoke.py`
phase 15a runs on the card, computed on the CPU for comparison.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tail_reference.py \
        [--horizon 1000 --warmup 250 --seeds 8]

`repro.core.robustness.tail_study` at `default_config()` (Topology(24,
6), Rates(0.5, 0.45, 0.25), max_arrivals 24), loads 0.90/0.95/0.99 of
the hot-rack capacity, exact estimates, `TelemetryConfig()` defaults,
over balanced_pandas, jsq_maxweight and fifo: prints `summarize_tail`
and the accounting (dropped, unmatched) per policy and load.  A few
minutes on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro.core import robustness as rb, simulator as sim


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--horizon", type=int, default=1000)
    ap.add_argument("--warmup", type=int, default=250)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = rb.StudyConfig(sim=sim.default_config(horizon=args.horizon,
                                                warmup=args.warmup),
                         seeds=tuple(range(args.seeds)))
    study = rb.tail_study(cfg)
    print(rb.summarize_tail(study))
    for pol in study["policies"]:
        print(f"{pol}: dropped {study['dropped'][pol].mean(-1).tolist()} "
              f"unmatched {study['unmatched'][pol].mean(-1).tolist()} "
              f"(means over seeds, one entry a load)")


if __name__ == "__main__":
    main()
