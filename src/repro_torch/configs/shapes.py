"""Assigned input-shape sets and input specs of the port (counterpart of
`repro.configs.shapes`).

Every LM architecture is paired with four shapes:
  train_4k     seq 4,096   x global_batch 256   -> train step
  prefill_32k  seq 32,768  x global_batch 32    -> prefill
  decode_32k   cache 32,768 x global_batch 128  -> serve step (1 new token)
  long_500k    cache 524,288 x global_batch 1   -> serve step; requires a
               sub-quadratic/bounded-cache family (SSM / hybrid / windowed)

`applicable()` encodes the mandated skips (full-attention archs skip
long_500k).  `input_specs` gives `TensorSpec` (shape, dtype) records,
torch dtypes, where the reference gives `jax.ShapeDtypeStruct`s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, RunShape] = {
    "train_4k": RunShape("train_4k", "train", 4_096, 256),
    "prefill_32k": RunShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": RunShape("decode_32k", "decode", 32_768, 128),
    "long_500k": RunShape("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: RunShape) -> Optional[str]:
    """None if runnable; otherwise the (documented) skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 500k decode needs an unbounded "
                "KV cache and quadratic prefill; skipped per assignment "
                "(see DESIGN.md §Arch-applicability)")
    return None


def input_specs(cfg: ModelConfig, shape: RunShape) -> Dict[str, TensorSpec]:
    """(shape, dtype) stand-ins for every model input of this cell.

    train: {tokens, labels [, frontend|frames]}
    prefill: {tokens [, frontend|frames]}
    decode: {tokens (B,1), lengths (B,)} (+ caches, built separately).
    Modality frontends are stubs: precomputed embeddings arrive as inputs.
    """
    b = shape.global_batch
    t = shape.seq_len
    emb = torch_dtype(cfg.dtype)
    tok = lambda s: TensorSpec(s, torch.int32)

    if shape.kind in ("train", "prefill"):
        n_text = t
        specs: Dict[str, TensorSpec] = {}
        if cfg.frontend == "vision":
            n_text = t - cfg.num_frontend_tokens
            specs["frontend"] = TensorSpec(
                (b, cfg.num_frontend_tokens, cfg.d_model), emb)
        if cfg.is_encdec:
            specs["frames"] = TensorSpec(
                (b, cfg.num_audio_frames, cfg.d_model), emb)
        specs["tokens"] = tok((b, n_text))
        if shape.kind == "train":
            specs["labels"] = tok((b, n_text))
        return specs

    # decode: one new token against a seq_len cache
    return {"tokens": tok((b, 1)), "lengths": TensorSpec((b,), torch.int32)}
