"""Train a ~100M-parameter dense LM for a few hundred steps through the
port's full training stack (locality-aware pipeline -> train step ->
atomic checkpoints) on one card.

    python -m repro_torch.examples.train_100m --steps 300      # full run
    python -m repro_torch.examples.train_100m --steps 20       # smoke

The reference runs the production mesh through ``--mesh``; the port runs
on one card, whose mesh is 1x1 (`launch.mesh.single_card_mesh()`), so
``--mesh`` takes ``1x1`` and nothing else.  Checkpoints go to
``experiments/train_100m_ckpt_torch`` by default, apart from the
reference's ``experiments/train_100m_ckpt``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from repro_torch.launch import mesh as mesh_lib


def model_config():
    """~100M params: 12L, d=768, 12 heads, ff=2048, 32k vocab, float32."""
    from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages
    return ModelConfig(
        name="lm-100m", family="dense", d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=2048, vocab_size=32_000,
        stages=uniform_stages(12, LayerSpec(kind="attn")),
        tie_embeddings=True, dtype="float32")


def parse_mesh(spec: str) -> dict:
    """``--mesh``'s value as axis sizes; only one card's 1x1 exists."""
    shape = tuple(int(x) for x in spec.split("x"))
    mesh = mesh_lib.single_card_mesh()
    if shape != tuple(mesh.values()):
        raise ValueError(
            f"--mesh {spec}: the port runs on one card, whose mesh is 1x1 "
            f"(launch/mesh.py has no multi-device mesh)")
    return mesh


def run(steps: int, seq_len: int, global_batch: int, ckpt_dir: str,
        device=None) -> List[dict]:
    """Trains `model_config()`; returns the trainer's history."""
    from repro_torch.configs import runtime
    from repro_torch.models.config import param_count
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = model_config()
    print(f"model: {param_count(cfg) / 1e6:.1f}M parameters")
    plan = runtime.plan_for(cfg, "train_4k", "train")
    tr = Trainer(cfg, TrainerConfig(
        seq_len=seq_len, global_batch=global_batch, steps=steps,
        ckpt_dir=ckpt_dir, ckpt_every=max(steps // 3, 10), log_every=5),
        plan, device=device)
    hist = tr.run()
    for h in hist:
        print(f"step {h['step']:4d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f} {h['wall_s']:.1f}s/step")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f}); checkpoints in {ckpt_dir}")
    return hist


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[dict]:
    """`device=None` means the card (and raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default="experiments/train_100m_ckpt_torch")
    args = ap.parse_args(argv)
    parse_mesh(args.mesh)
    return run(args.steps, args.seq_len, args.global_batch, args.ckpt_dir,
               device)


if __name__ == "__main__":
    main()
