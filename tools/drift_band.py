"""Derives the delay band of the port's drift study against the JAX
reference's, on the CPU (tests/test_torch_drift_study.py and
tests/test_torch_drift_band.py state it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/drift_band.py \
        [--sets 3] [--seeds 24] [--scenarios stragglers,rack_congestion] \
        [--horizon 1500 --warmup 500] [--test-seeds 12] [--iid] \
        [--workers 6]

Runs both drift studies at Topology(24, 6), load 0.75, for the given
scenarios: the reference on seeds 0..N-1 (its own key schedule), the port
on `--sets` disjoint sets of N seeds (its own draws), and with ``--iid``
the port fed i.i.d. numpy draws on the same sets (tools/tail_band.py's
`IidDenseSource`).  Prints each arm's mean delay, the seed std and the
relative gap of each port set to the reference; the pooled port sets
against the reference (and against the i.i.d. sets) in standard errors;
and the band of a test that compares `--test-seeds` seeds a side: the
largest gap of a set plus three standard errors of each mean at that
seed count (the seed std relative to the mean, the larger of the two
packages' and of the two arms'), as `DRIFT_BAND`'s comment derives it.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp

import numpy as np
import torch

ARMS = ("fixed_prior", "blind_ewma")


def _run(job):
    """One package (ref, port or iid) over one seed set: {(scenario,
    arm): (S,) delays}."""
    pkg, seeds, scenarios, horizon, warmup = job
    torch.set_num_threads(1)
    if pkg == "ref":
        from repro.core import robustness as rb, simulator as sim
        kw = {}
    else:
        from repro_torch.core import robustness as rb, simulator as sim
        kw = {"device": "cpu"}
        if pkg == "iid":
            from tail_band import IidDenseSource
            sim.DenseDeviceSource = IidDenseSource
    out = rb.drift_study(rb.StudyConfig(
        sim=sim.default_config(horizon=horizon, warmup=warmup),
        seeds=tuple(seeds)), scenarios, **kw)
    return {(s, a): np.asarray(out["delay"][s][a], np.float64)
            for s in scenarios for a in ARMS}


def _mean_se(x):
    return x.mean(), x.std(ddof=1) / np.sqrt(len(x))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--scenarios", default="stragglers,rack_congestion")
    ap.add_argument("--horizon", type=int, default=1500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--test-seeds", type=int, default=12)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    scenarios = tuple(args.scenarios.split(","))
    n = args.seeds
    sets = [tuple(range(100 * (i + 1), 100 * (i + 1) + n))
            for i in range(args.sets)]
    jobs = [("ref", tuple(range(n)), (s,), args.horizon, args.warmup)
            for s in scenarios]
    for pkg in ("port", "iid") if args.iid else ("port",):
        jobs += [(pkg, st, (s,), args.horizon, args.warmup)
                 for st in sets for s in scenarios]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        parts = pool.map(_run, jobs, chunksize=1)
    res = {}
    for (pkg, seeds, (scen,), _, _), out in zip(jobs, parts):
        for (s, a), v in out.items():
            res.setdefault((pkg, s, a), []).append(v)
    print(f"drift study, Topology(24, 6), load 0.75, horizon {args.horizon}"
          f" / warmup {args.warmup}: reference seeds 0-{n - 1}, the port on "
          f"{args.sets} sets of {n} seeds")
    for scen in scenarios:
        gaps, cvs = [], []
        for arm in ARMS:
            d = res[("ref", scen, arm)][0]
            line = (f"{scen:16s} {arm:12s} reference {d.mean():.4f} "
                    f"(seed std {d.std(ddof=1):.4f})  port")
            cvs.append(d.std(ddof=1) / d.mean())
            for g in res[("port", scen, arm)]:
                gaps.append(abs(g.mean() / d.mean() - 1))
                cvs.append(g.std(ddof=1) / g.mean())
                line += (f" {g.mean():.4f} ({g.mean() / d.mean() - 1:+.2%},"
                         f" std {g.std(ddof=1):.4f})")
            print(line, flush=True)
            pooled = {p: _mean_se(np.concatenate(res[(p, scen, arm)]))
                      for p in ("ref", "port", "iid")
                      if (p, scen, arm) in res}
            line = f"{'':16s} {arm:12s} pooled:"
            for p, (m, se) in pooled.items():
                line += f" {p} {m:.4f} +- {se:.4f}"
            for a, b in (("port", "ref"), ("port", "iid"), ("ref", "iid")):
                if a in pooled and b in pooled:
                    dm = pooled[a][0] - pooled[b][0]
                    z = dm / np.hypot(pooled[a][1], pooled[b][1])
                    line += f"  {a}-{b} {dm / pooled[b][0]:+.2%} (z {z:+.2f})"
            print(line, flush=True)
        se = max(cvs) / np.sqrt(args.test_seeds)
        print(f"{scen:16s} band at {args.test_seeds} seeds a side: largest "
              f"gap {max(gaps):.2%} + 3 x 2 x {se:.2%} = "
              f"{max(gaps) + 6 * se:.2%}", flush=True)


if __name__ == "__main__":
    main()
