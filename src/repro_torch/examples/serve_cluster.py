"""Serve a small model with batched requests through the port's
continuous-batching engine, comparing schedulers under a straggling
replica.

    python -m repro_torch.examples.serve_cluster [--requests 24]

A 4-replica / 2-pod fleet serves real greedy decoding of chatglm3-6b's
smoke config (weights drawn from a seeded generator on the device);
replica 1 is 5x slow and the routers only learn it through observed
service times (blind estimation).  Balanced-PANDAS keeps latency flat;
FIFO (Hadoop default) pays the full straggler cost.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

ARCH = "chatglm3_6b"
SCHEDULERS = ("balanced_pandas", "pandas_po2", "jsq_maxweight", "fifo")


def run(requests: int = 24, new_tokens: int = 6, device=None) -> dict:
    """Each scheduler drains the same requests; returns ``{scheduler:
    (engine, drained requests)}``."""
    from repro_torch.configs import registry
    from repro_torch.models import params as P
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine

    dev = resolve_device(device)
    cfg = registry.get_smoke_config(ARCH)
    prm = P.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(requests)]

    print(f"serving {requests} requests x {new_tokens} new tokens "
          f"on 4 replicas (2 pods), replica 1 is 5x slow\n")
    results = {}
    for scheduler in SCHEDULERS:
        ecfg = EngineConfig(num_replicas=4, replicas_per_pod=2,
                            slots_per_replica=2, max_len=64,
                            prefill_buckets=(16,), scheduler=scheduler)
        eng = ServingEngine(cfg, prm, ecfg, slow_replicas={1: 5.0},
                            device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens,
                        prefix_id=i % 6) for i, p in enumerate(prompts)]
        t0 = time.monotonic()
        out = eng.run_until_drained(reqs, max_steps=1500)
        wall = time.monotonic() - t0
        lat = np.mean([r.finish_time - r.arrival for r in out])
        spread = np.bincount([r.replica for r in out], minlength=4)
        results[scheduler] = (eng, out)
        print(f"{scheduler:16s} engine_steps={eng.steps:4d} "
              f"wall={wall:5.1f}s mean_latency={lat * 1e3:7.0f}ms "
              f"replica spread={spread.tolist()} "
              f"tier mix={eng.assign_tiers}")
    print("\n(sample output tokens, request 0:", out[0].generated[:8], ")")
    return results


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=6)
    args = ap.parse_args(argv)
    return run(args.requests, args.new_tokens, device)


if __name__ == "__main__":
    main()
