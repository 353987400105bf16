"""Readings that set the limits of ``correct``, on the card at a cell's
own size.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 \\
        [--program]

For each seed, the cell's driver reads the control: the plain reference
computed in the nearest lower precision (for the fleet study bfloat16
workloads, scores and water levels) and put in the program's place,
against the reference in the configuration's precision (the upper
reading).  With ``--program`` the program's own run at that seed is
read too (the lower reading).  One JSON line a seed, then a summary:
each control reading's least and each program reading's most.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if args.program:
        sys.path.insert(0, str(spec.ROOT / "src"))
    rows = []
    for seed in args.seeds:
        row = dict(workload=args.workload, seed=seed,
                   **cell.driver.control(cell, seed, "cuda", args.program))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload}
    for key in rows[0]:
        if key.startswith("control_"):
            summary[key + "_min"] = min(r[key] for r in rows)
        elif key.startswith("program_"):
            summary[key + "_max"] = max(r[key] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
