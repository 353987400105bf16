"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine with the Balanced-PANDAS request
router over N replica groups on the card, with the arch's smoke config,
as the reference's launcher does.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, device=None) -> None:
    """`device=None` means the card (and raises without one)."""
    from repro_torch.core.policy import available_routers
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3_6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--scheduler", default="balanced_pandas",
                    choices=list(available_routers()))
    ap.add_argument("--replicas", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import registry
    from repro_torch.models import params as P
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine

    dev = resolve_device(device)
    cfg = registry.get_smoke_config(args.arch)
    prm = P.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    ecfg = EngineConfig(num_replicas=args.replicas,
                        replicas_per_pod=max(args.replicas // 2, 1),
                        slots_per_replica=2, max_len=64,
                        prefill_buckets=(16,), scheduler=args.scheduler)
    eng = ServingEngine(cfg, prm, ecfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               12).astype(np.int32),
                    max_new_tokens=6, prefix_id=i % 5)
            for i in range(args.requests)]
    out = eng.run_until_drained(reqs)
    lat = [r.finish_time - r.arrival for r in out]
    print(f"scheduler={args.scheduler} drained {len(out)} requests in "
          f"{eng.steps} engine steps; mean latency "
          f"{np.mean(lat) * 1e3:.0f}ms; tier mix {eng.assign_tiers}")


if __name__ == "__main__":
    main()
