"""Fault tolerance on the port: train, 'lose' chips, replan the mesh,
restore the atomic checkpoint and keep training.

    python -m repro_torch.examples.elastic_restart

mamba2-1.3b's smoke config trains 6 steps with a checkpoint every 3.
The reference then loses 4 of its 8 host devices, replans its mesh with
`plan_elastic_mesh` and restores the checkpoint with the new mesh's
shardings.  On one card a lost chip leaves nothing to resume on, so the
port computes and prints the same replan for 4 surviving chips, then
restores the checkpoint (`Trainer.restore_or_init`) onto the same card
and trains 4 more steps; the loss must end below where phase 1 began.
"""

from __future__ import annotations

import tempfile
from typing import Optional, Sequence


def run(device=None):
    """The two phases; returns their histories (h1, h2)."""
    from repro_torch.configs import registry, runtime
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.elastic import plan_elastic_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get_smoke_config("mamba2_13b")
    plan = runtime.plan_for(cfg, "train_4k", "train")
    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as ckpt:
        print(f"phase 1: mesh {mesh_lib.single_card_mesh()} — 6 steps, "
              f"checkpoint every 3")
        tr1 = Trainer(cfg, TrainerConfig(seq_len=64, global_batch=8,
                                         steps=6, ckpt_dir=ckpt,
                                         ckpt_every=3, log_every=2), plan,
                      device=device)
        h1 = tr1.run()
        print(f"  loss {h1[0]['loss']:.3f} -> {h1[-1]['loss']:.3f}")

        # --- the reference loses 4 of 8 chips ------------------------------
        surviving = 4
        shape, names = plan_elastic_mesh(surviving, model_axis=2,
                                         pod_size=10**9)
        print(f"phase 2: lost 4 chips; replanned mesh {shape} axes {names} "
              f"(one card here: restoring onto the same device)")
        tr2 = Trainer(cfg, TrainerConfig(seq_len=64, global_batch=8, steps=4,
                                         ckpt_dir=ckpt, log_every=2), plan,
                      device=device)
        start = tr2.restore_or_init()
        print(f"  restored step {start} from the atomic checkpoint, resuming")
        h2 = tr2.run()
    print(f"  loss continues {h2[0]['loss']:.3f} -> {h2[-1]['loss']:.3f}")
    assert h2[-1]["loss"] < h1[0]["loss"]
    print("elastic restart OK")
    return h1, h2


def main(argv: Optional[Sequence[str]] = None, device=None):
    """`device=None` means the card (and raises without one).  Takes no
    flags, as the reference's script."""
    import argparse
    argparse.ArgumentParser().parse_args(argv)
    return run(device)


if __name__ == "__main__":
    main()
