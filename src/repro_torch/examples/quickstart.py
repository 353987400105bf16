"""Quickstart on the port: the paper's result on all three layers.

1. Queueing layer — Balanced-PANDAS vs JSQ-MaxWeight under rate
   mis-estimation (the paper's core experiment, reduced horizon).
2. Kernel layer — the batched routing kernel (`ops.wwl_route`, the CUDA
   `wwl_route` on the card) vs its plain version, exactly.
3. Framework layer — 20 training steps of a small LM fed by the
   locality-aware data pipeline.  The pipeline synthesizes Zipf-skewed
   tokens (`token_skew`) and the optimizer warms up within the run, so
   the loss drop is a real signal, not noise.  The reference trains on a
   (1, 1) device mesh; the port's is one card
   (`launch.mesh.single_card_mesh()`), which its trainer runs on
   without taking a mesh.

    python -m repro_torch.examples.quickstart [--fast]

``--fast``: reduced horizons, 12 training steps, same assertions.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

ALGOS = ("balanced_pandas", "pandas_po2", "jsq_maxweight")
# (mode, eps, sign): exact, rates 30% low, rates 30% high
SETTINGS = (("network", 0.0, -1), ("per_server", 0.3, -1),
            ("per_server", 0.3, +1))
M_ROUTE, B_ROUTE = 1024, 128


def queueing(horizon: int, warmup: int, device) -> dict:
    """Layer 1: mean delay per algo and estimate setting at rho 0.95."""
    from repro_torch.core import locality as loc, simulator as sim
    cfg = sim.default_config(horizon=horizon, warmup=warmup)
    cap = loc.capacity_hot_rack(cfg.topo, cfg.true_rates, cfg.p_hot)
    lam = 0.95 * cap
    print(f"== queueing: M={cfg.topo.num_servers}, capacity={cap:.1f} "
          f"tasks/slot, load=0.95 ==")
    delays = {}
    for algo in ALGOS:
        row = []
        for mode, eps, sign in SETTINGS:
            est = sim.make_estimates(cfg, mode, eps, sign, seed=7)
            out = sim.simulate(algo, cfg, lam, est, seed=0, device=device)
            row.append(out["mean_delay"])
        delays[algo] = row
        print(f"  {algo:16s} delay: exact={row[0]:6.2f} -30%={row[1]:6.2f} "
              f"+30%={row[2]:6.2f}  (slots)")
    print("  -> Balanced-PANDAS holds its delay under mis-estimated rates.")
    return delays


def route_inputs(m: int = M_ROUTE, b: int = B_ROUTE):
    """Layer 2's inputs as numpy: workloads, (M, 3) rates, a rack map of
    racks of 32 and (B, 3) sorted local servers, seeded 0."""
    rng = np.random.default_rng(0)
    wl = rng.uniform(0, 50, m).astype(np.float32)
    er = np.tile(np.asarray([0.5, 0.45, 0.25], np.float32), (m, 1))
    sr = (np.arange(m) // 32).astype(np.int32)
    tl = np.sort(rng.integers(0, m, (b, 3)).astype(np.int32), 1)
    return wl, er, sr, tl


def routing(device):
    """Layer 2: `ops.wwl_route` against `ref.wwl_route`, exactly; returns
    the kernel's (server, tier, score) as numpy."""
    from repro_torch.kernels import ops, ref
    args = [torch.as_tensor(x, device=device) for x in route_inputs()]
    s_k, t_k, w_k = ops.wwl_route(*args)
    s_r, t_r, _ = ref.wwl_route(*args)
    assert torch.equal(s_k, s_r) and torch.equal(t_k, t_r)
    t_np = t_k.cpu().numpy()
    print(f"== kernel: wwl_route({B_ROUTE} tasks x {M_ROUTE} servers) "
          f"matches oracle; locality mix {np.bincount(t_np, minlength=3)} ==")
    return s_k.cpu().numpy(), t_np, w_k.cpu().numpy()


def training(steps: int, device):
    """Layer 3: granite-moe-1b's smoke config through the locality-aware
    pipeline; returns the trainer's history."""
    from repro_torch.configs import registry, runtime
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg_m = registry.get_smoke_config("granite_moe_1b")
    plan = runtime.plan_for(cfg_m, "train_4k", "train")
    # quickstart-sized optimizer: the production plan warms up over 100
    # steps, which would leave the LR (and the loss) flat for this run
    plan = dataclasses.replace(plan, opt=dataclasses.replace(
        plan.opt, warmup_steps=5, decay_steps=200))
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg_m.vocab_size,
                                       seq_len=64, global_batch=4, seed=0,
                                       token_skew=1.2))
    tr = Trainer(cfg_m, TrainerConfig(seq_len=64, global_batch=4,
                                      steps=steps, log_every=5), plan,
                 pipeline=pipe, device=device)
    hist = tr.run()
    print("== training (granite-moe smoke config, locality-aware pipeline) ==")
    for h in hist:
        print(f"  step {h['step']:3d} loss {h['loss']:.3f} "
              f"locality(l/r/rem)="
              f"{tuple(round(x, 2) for x in h['data_locality'])}")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2, \
        (hist[0]["loss"], hist[-1]["loss"])
    return hist


def run(horizon: int, warmup: int, steps: int, device=None) -> dict:
    """The three layers; returns their results: ``delays`` ({algo:
    [exact, -30%, +30%]}), ``route`` (server, tier, score) and
    ``history``."""
    device = resolve_device(device)
    out = {"delays": queueing(horizon, warmup, device),
           "route": routing(device),
           "history": training(steps, device)}
    print("done.")
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="reduced horizons, same assertions")
    args = ap.parse_args(argv)
    horizon, warmup = (2500, 600) if args.fast else (8000, 2000)
    return run(horizon, warmup, 12 if args.fast else 20, device)


if __name__ == "__main__":
    main()
