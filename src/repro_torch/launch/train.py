"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains an arch's smoke config (or, with ``--full``, its full config) with
the whole substrate stack on one device: the locality-aware pipeline ->
the train step (`launch.steps`) -> checkpoints (``--ckpt-dir``), under
`configs.runtime.plan_for(cfg, "train_4k", "train")`, and prints the
reference's line a logged step.  The reference's ``--mesh`` and
``--multi-pod`` pick a device mesh; the port runs on one card and takes
neither.  ``python -m repro_torch.launch.train --arch mamba2_13b --full
--steps 3 --seq-len 512 --global-batch 8`` trains mamba2-1.3b at full
width on the card.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[dict]:
    """`device=None` means the card (and raises without one).  Returns
    the trainer's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3_6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the full (production) config, not the smoke one")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry, runtime
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_smoke_config(args.arch))
    plan = runtime.plan_for(cfg, "train_4k", "train")
    trainer = Trainer(cfg, TrainerConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        steps=args.steps, ckpt_dir=args.ckpt_dir), plan, device=device)
    hist = trainer.run()
    for rec in hist:
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"gnorm {rec['grad_norm']:.3f} {rec['wall_s'] * 1e3:.0f}ms "
              f"locality {tuple(round(x, 2) for x in rec['data_locality'])}")
    return hist


if __name__ == "__main__":
    main()
