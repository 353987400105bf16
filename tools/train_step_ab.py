#!/usr/bin/env python3
"""Time the full-width training step of `chip_smoke.py` phase 17a with a
stage's layer parameters cut two ways, in turns, in one process.

    python3 tools/train_step_ab.py [--steps 2] [--profile]

"index" takes layer r as ``stacked[r]`` (`transformer._index`, how the
stage loop cut its layers before training came): autograd turns each
layer's gradient into a zero-filled tensor of the whole stack and adds
them up.  "unbind" (`transformer._unbind`, what the
train step runs) cuts each stacked leaf once, so the backward stacks
the layers' gradients once.  mamba2-1.3b at full width (bf16, random
weights from seed 0), `plan_for(cfg, "train_4k", "train")` with the
quickstart's warmup, global batch 8 x 512 tokens from phase 17a's
pipeline.  After one warm-up step a variant, the variants run in the
order index, unbind, unbind, index, each for ``--steps`` steps timed by
the host clock ending in a synchronise; it prints one JSON line a turn
(ms a step, the peak device memory of the turn) and, with
``--profile``, one profiled step a variant (device kernel time and
launches, `torch.profiler` on the device alone).  The two variants give
the same losses (printed).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry, runtime
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    unbind = T._unbind
    variants = {"unbind": unbind,
                "index": lambda tree, n: [T._index(tree, r)
                                          for r in range(n)]}
    cfg = registry.get_config("mamba2_13b")
    plan = runtime.plan_for(cfg, "train_4k", "train")
    plan = dataclasses.replace(plan, opt=dataclasses.replace(
        plan.opt, warmup_steps=5, decay_steps=200))
    pipe = DataPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=8,
        token_skew=1.2, tokens_per_chunk=256), slow_hosts={0: 0.1})
    tr = Trainer(cfg, TrainerConfig(seq_len=512, global_batch=8,
                                    log_every=1), plan, pipeline=pipe,
                 device=dev)
    tr.init_state()
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)

    def run(name, steps):
        T._unbind = variants[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run(steps)
        torch.cuda.synchronize()
        return {"variant": name, "ms_a_step":
                (time.perf_counter() - t0) * 1e3 / steps,
                "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
                "loss": tr.history[-1]["loss"]}

    for name in variants:          # warm-up, one step each
        print(json.dumps(dict(run(name, 1), turn="warm-up")), flush=True)
    for name in ("index", "unbind", "unbind", "index"):
        print(json.dumps(run(name, args.steps)), flush=True)
    if args.profile:
        for name in ("index", "unbind"):
            T._unbind = variants[name]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tr.run(1)
                torch.cuda.synchronize()
            kern = [(e.self_device_time_total, e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            top = sorted(kern, reverse=True)[:4]
            print(json.dumps({
                "variant": name, "profiled": True,
                "device_ms": sum(k[0] for k in kern) / 1e3,
                "launches": sum(k[1] for k in kern),
                "top": [[k[2][:100], k[0] / 1e3, k[1]] for k in top]}),
                flush=True)
    T._unbind = unbind
    return 0


if __name__ == "__main__":
    sys.exit(main())
