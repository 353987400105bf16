"""The reference's SLO-control study at the cut depth `chip_smoke.py`
phase 16a runs on the card, computed on the CPU for comparison.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/control_reference.py \
        [--horizon 600 --warmup 150 --seeds 8]

`repro.core.robustness.control_study` at `default_config()`
(Topology(24, 6), Rates(0.5, 0.45, 0.25), max_arrivals 24), loads
0.90/0.95/0.99 of the hot-rack capacity, exact estimates, telemetry on,
the arms none / admission / autoscale / both over balanced_pandas and
slo_pandas, ``slo_target`` 40 and ``admit_frac`` 0.93: prints
`summarize_control`, then each policy's p50/p95 and each controlled
arm's shed rate per load (means over seeds).  A few minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json

from repro.core import robustness as rb, simulator as sim


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--horizon", type=int, default=600)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = rb.StudyConfig(sim=sim.default_config(horizon=args.horizon,
                                                warmup=args.warmup),
                         seeds=tuple(range(args.seeds)))
    study = rb.control_study(cfg, admit_frac=0.93, slo_target=40.0)
    print(rb.summarize_control(study))
    table = {f"{pol}/{arm}": {m: study[m][pol][arm].mean(-1).tolist()
                              for m in ("mean", "p50", "p95", "p99",
                                        "shed_rate", "throughput")}
             for pol in study["policies"] for arm in study["arms"]}
    print(json.dumps(table))


if __name__ == "__main__":
    main()
