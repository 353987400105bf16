"""Three arms of the heavy-traffic studies on the CPU: the JAX reference on
its own keys, the port on its own draws, and the port on i.i.d. numpy
draws, each over many seeds, with standard errors (ROADMAP Queue 3).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tail_band.py \
        [--study tail|control] [--seeds 96] [--horizon H --warmup W] \
        [--workers 6] [--arms ref,port,iid] [--json OUT]

``--study tail`` runs `tail_study` at `default_config()` (Topology(24, 6),
Rates(0.5, 0.45, 0.25), max_arrivals 24), loads 0.90/0.95/0.99, over
balanced_pandas and jsq_maxweight (``--policies``), horizon 2000 / warmup
500 by default; ``--study control`` runs `control_study` at load 0.99
with its four arms over balanced_pandas and slo_pandas, at
tools/control_reference.py's depth (600 / 150) by default.  The arms:

  ref  -- `repro.core.robustness` (the reference's key schedule);
  port -- `repro_torch.core.robustness` on the CPU (`DenseDeviceSource`:
          torch generators);
  iid  -- the port fed `IidDenseSource`: `DenseDeviceSource`'s block
          layout filled from `numpy.random.Generator(PCG64)` float32
          uniforms, the count by the same inverse CDF.

Every arm runs seeds 0..N-1 of its own generators, split over
``--workers`` processes.  Prints, per policy (and control arm) and load,
each arm's mean delay, p95 and p99 over seeds with the standard error of
the mean, and the gaps port - iid and ref - iid in units of their
standard error.  The rule (ROADMAP Queue 3): port within 3 SE of iid and
ref beyond 3 SE of iid points at the reference's key schedule; port
beyond 3 SE of iid at a fault in the port's draws; all within 3 SE at
seed noise.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os

import numpy as np
import torch

from repro_torch.core.rng import DenseDeviceSource

TAIL_POLICIES = ("balanced_pandas", "jsq_maxweight")
METRICS = ("mean", "p95", "p99")


class IidDenseSource(DenseDeviceSource):
    """`DenseDeviceSource` with its generators replaced by numpy's PCG64:
    seed s draws its arrival blocks from ``PCG64([s, 0])``, its policy
    blocks from ``PCG64([s, 1])`` and its chunk reads from ``PCG64([s,
    2])``, float32 uniforms in [0, 1) in the same layout, so every law
    but the generator's is the port's.  CPU only."""

    def __init__(self, cells, *args, **kw):
        super().__init__(cells, *args, **kw)
        seeds = sorted({int(s) for s, _ in cells})

        def gens(stream):
            return [np.random.Generator(np.random.PCG64([s, stream]))
                    for s in seeds]

        self.arr_gens, self.pol_gens = gens(0), gens(1)
        if self.read_gens is not None:
            self.read_gens = gens(2)

    def _block(self, gens, size: int) -> torch.Tensor:
        blk = torch.from_numpy(np.stack([g.random(size, dtype=np.float32)
                                         for g in gens]))
        return blk if self.cell_seed is None else blk[self.cell_seed.cpu()]


def _run(job):
    """One arm over a chunk of seeds: {key: (L, S) array} with key
    ``policy/metric`` (tail) or ``policy/arm/metric`` (control)."""
    arm, study, seeds, horizon, warmup, policies = job
    torch.set_num_threads(1)
    if arm == "ref":
        from repro.core import robustness as rb, simulator as sim
        kw = {}
    else:
        from repro_torch.core import robustness as rb, simulator as sim
        kw = {"device": "cpu"}
        if arm == "iid":
            sim.DenseDeviceSource = IidDenseSource
    cfg = rb.StudyConfig(sim=sim.default_config(horizon=horizon,
                                                warmup=warmup),
                         seeds=tuple(seeds))
    out = {}
    if study == "tail":
        res = rb.tail_study(cfg, policies=policies, **kw)
        for pol in policies:
            for m in METRICS:
                out[f"{pol}/{m}"] = np.asarray(res[m][pol], np.float64)
    else:
        res = rb.control_study(cfg, policies=policies, loads=(0.99,),
                               admit_frac=0.93, slo_target=40.0, **kw)
        for pol in policies:
            for a in res["arms"]:
                for m in METRICS:
                    out[f"{pol}/{a}/{m}"] = np.asarray(res[m][pol][a],
                                                       np.float64)
    return arm, out


def _stats(x):
    """Mean and standard error of the mean over the last axis."""
    return x.mean(-1), x.std(-1, ddof=1) / np.sqrt(x.shape[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--study", choices=("tail", "control"), default="tail")
    ap.add_argument("--seeds", type=int, default=96)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--arms", default="ref,port,iid")
    ap.add_argument("--policies", default=None)
    ap.add_argument("--json", default=None, help="write the per-seed values")
    args = ap.parse_args(argv)
    tail = args.study == "tail"
    horizon = args.horizon or (2000 if tail else 600)
    warmup = args.warmup if args.warmup is not None else horizon // 4
    policies = tuple(args.policies.split(",")) if args.policies else (
        TAIL_POLICIES if tail else ("balanced_pandas", "slo_pandas"))
    loads = (0.90, 0.95, 0.99) if tail else (0.99,)
    arms = tuple(args.arms.split(","))
    per = max(1, -(-args.seeds * len(arms) // args.workers))
    jobs = [(arm, args.study, list(range(lo, min(lo + per, args.seeds))),
             horizon, warmup, policies)
            for arm in arms for lo in range(0, args.seeds, per)]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with mp.get_context("spawn").Pool(args.workers) as pool:
        parts = pool.map(_run, jobs, chunksize=1)
    res = {arm: {} for arm in arms}
    for arm, out in parts:    # in job order: seeds ascending
        for k, v in out.items():
            res[arm].setdefault(k, []).append(v)
    res = {arm: {k: np.concatenate(v, -1) for k, v in d.items()}
           for arm, d in res.items()}
    print(f"{args.study} study, horizon {horizon} / warmup {warmup}, "
          f"{args.seeds} seeds an arm; mean +- standard error over seeds; "
          f"gap z = difference / its standard error")
    for key in sorted({k.rsplit("/", 1)[0] for k in res[arms[0]]}):
        for li, rho in enumerate(loads):
            for m in METRICS:
                st = {a: _stats(res[a][f"{key}/{m}"][li]) for a in arms}
                line = f"{key:28s} {rho:4.2f} {m:4s}"
                for a in arms:
                    line += f"  {a} {st[a][0]:9.4f} +- {st[a][1]:.4f}"
                for a, b in (("port", "iid"), ("ref", "iid"),
                             ("ref", "port")):
                    if a in st and b in st:
                        d = st[a][0] - st[b][0]
                        se = np.hypot(st[a][1], st[b][1])
                        line += (f"  {a}-{b} {d:+.4f} "
                                 f"({d / st[b][0]:+.2%}, z {d / se:+.2f})")
                print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"study": args.study, "horizon": horizon,
                       "warmup": warmup, "seeds": args.seeds,
                       "loads": loads,
                       "values": {a: {k: v.tolist() for k, v in d.items()}
                                  for a, d in res.items()}}, f)


if __name__ == "__main__":
    main()
