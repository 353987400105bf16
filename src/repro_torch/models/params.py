"""Parameter trees of the port (counterpart of `repro.models.params`).

Every parameter is declared once as a `ParamDef` (shape + init rule), with
the reference's keys and its stacked per-stage layout: a stage's block
parameters carry a leading ``repeats`` axis.  A tree is a nested ``dict``
of tensors.  Two views:

  * `init_params`    — random tensors on the device, drawn with the
                       reference's rules (fan-in normal, embed x 0.02,
                       ones, zeros, the Mamba a_log and dt_bias draws);
                       the generator differs from JAX's, so the values
                       do too;
  * `from_reference` — the JAX package's tree, handed over as numpy
                       arrays, as the port's tree (the tests use it so the
                       two models compute the same function);
  * `abstract_params` — shapes and dtypes on the ``meta`` device.

Every layer of the reference is declared: dense and cross-attention,
Mamba-2, dense and MoE MLPs, the encoder stack (``enc_stages``,
``enc_final``) and learned positions (``pos_embed``, ``enc_pos_embed``).
A modality frontend has no parameters: its embeddings arrive as inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import LayerSpec, ModelConfig, Stage
from repro_torch.models.layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed | a_log | dt_bias
    fan_in_dims: Tuple[int, ...] = (0,)  # dims treated as fan-in for scaling


def _norm_defs(cfg: ModelConfig, name: str) -> Dict[str, ParamDef]:
    d = {f"{name}_scale": ParamDef((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        d[f"{name}_bias"] = ParamDef((cfg.d_model,), "zeros")
    return d


def _attn_defs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, ParamDef]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs: Dict[str, ParamDef] = {
        "wq": ParamDef((d, qd)),
        "wk": ParamDef((d, kvd)),
        "wv": ParamDef((d, kvd)),
        "wo": ParamDef((qd, d)),
    }
    if cfg.attn_bias:
        defs["bq"] = ParamDef((qd,), "zeros")
        defs["bk"] = ParamDef((kvd,), "zeros")
        defs["bv"] = ParamDef((kvd,), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((cfg.head_dim,), "ones")
        defs["k_norm"] = ParamDef((cfg.head_dim,), "ones")
    if spec.cross:
        defs.update({
            "xq": ParamDef((d, qd)),
            "xk": ParamDef((d, kvd)),
            "xv": ParamDef((d, kvd)),
            "xo": ParamDef((qd, d)),
        })
    return defs


def _mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDef((d, ff)),
            "w_up": ParamDef((d, ff)),
            "w_down": ParamDef((ff, d)),
        }
    return {
        "w_up": ParamDef((d, ff)),
        "w_down": ParamDef((ff, d)),
    }


def _moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The router (d, E) and the stacked experts (E, d, ff) / (E, ff, d),
    each expert's fan-in its own d or ff (dim 1)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    defs = {"router": ParamDef((d, e))}
    if cfg.act in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d, ff), fan_in_dims=(1,))
    defs["w_up"] = ParamDef((e, d, ff), fan_in_dims=(1,))
    defs["w_down"] = ParamDef((e, ff, d), fan_in_dims=(1,))
    return defs


def _mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    ssm = cfg.ssm
    d = cfg.d_model
    din = ssm.d_inner(d)
    gn = ssm.n_groups * ssm.d_state
    h = ssm.num_heads(d)
    conv_dim = din + 2 * gn
    return {
        "in_proj": ParamDef((d, 2 * din + 2 * gn + h)),
        "conv_w": ParamDef((ssm.conv_kernel, conv_dim), "normal", (0,)),
        "conv_b": ParamDef((conv_dim,), "zeros"),
        "a_log": ParamDef((h,), "a_log"),
        "d_skip": ParamDef((h,), "ones"),
        "dt_bias": ParamDef((h,), "dt_bias"),
        "gate_norm_scale": ParamDef((din,), "ones"),
        "out_proj": ParamDef((din, d)),
    }


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of `cfg` (decoder and encoder) is of a
    kind the port has: attention (self, with cross-attention if asked)
    or Mamba-2."""
    for st in cfg.stages + cfg.enc_stages:
        for sl in st.block:
            if sl.kind not in ("attn", "mamba"):
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {sl.kind!r} of {sl} is not "
                    f"one the port has (attn, mamba)")


def layer_defs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    defs: Dict[str, Any] = {}
    defs.update(_norm_defs(cfg, "ln1"))
    if spec.kind == "mamba":
        defs["mamba"] = _mamba_defs(cfg)
    else:
        defs["attn"] = _attn_defs(cfg, spec)
        if spec.cross:
            defs.update(_norm_defs(cfg, "ln_cross"))
    if spec.moe or cfg.d_ff > 0:  # mamba2-style layers have no MLP block
        defs.update(_norm_defs(cfg, "ln2"))
        defs["moe" if spec.moe else "mlp"] = (_moe_defs(cfg) if spec.moe
                                              else _mlp_defs(cfg))
        if cfg.post_norm:
            defs.update(_norm_defs(cfg, "post2"))
    if cfg.post_norm:
        defs.update(_norm_defs(cfg, "post1"))
    return defs


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in the reference's leaf order (keys
    sorted at every level, as `jax.tree.leaves` orders a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _stack(defs: Dict[str, Any], repeats: int) -> Dict[str, Any]:
    """Add the leading stacked-layer axis."""
    return tree_map(lambda d: ParamDef((repeats,) + d.shape, d.init,
                                       tuple(x + 1 for x in d.fan_in_dims)),
                    defs)


def stage_defs(cfg: ModelConfig, stage: Stage) -> Dict[str, Any]:
    return _stack({f"sub{i}": layer_defs(cfg, sl)
                   for i, sl in enumerate(stage.block)}, stage.repeats)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), "embed"),
        "stages": {f"stage{i}": stage_defs(cfg, st)
                   for i, st in enumerate(cfg.stages)},
    }
    defs.update(_norm_defs(cfg, "final"))
    if cfg.enc_stages:
        defs["enc_stages"] = {f"stage{i}": stage_defs(cfg, st)
                              for i, st in enumerate(cfg.enc_stages)}
        defs.update(_norm_defs(cfg, "enc_final"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab))
    if cfg.learned_pos:
        defs["pos_embed"] = ParamDef((cfg.learned_pos, cfg.d_model), "embed")
        if cfg.enc_stages:
            defs["enc_pos_embed"] = ParamDef(
                (max(cfg.num_audio_frames, 1), cfg.d_model), "embed")
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None):
    """Random parameters on `device` (None: the card), in `dtype` (default
    ``cfg.dtype``).  `generator` must live on that device.  Tensors are
    drawn one at a time in float32 and cast, so the peak beyond the tree
    itself is one float32 tensor (6.3 GB for chatglm3-6b's stacked
    ``w_gate``)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        if d.init in ("a_log", "dt_bias"):
            # Mamba-2: a_log = log U[1, 16); dt_bias = inverse-softplus
            # of dt ~ U[1e-3, 1e-1)
            lo, hi = (1.0, 16.0) if d.init == "a_log" else (1e-3, 1e-1)
            u = torch.rand(d.shape, generator=generator, device=dev,
                           dtype=torch.float32) * (hi - lo) + lo
            u = u.log() if d.init == "a_log" else u.expm1().log()
            return u.to(dt)
        if d.init == "embed":
            std = 0.02
        else:
            fan_in = max(int(np.prod([d.shape[i] for i in d.fan_in_dims])), 1)
            std = 1.0 / math.sqrt(fan_in)
        x = torch.randn(d.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(std).to(dt)

    return tree_map(make, model_defs(cfg))


def abstract_params(cfg: ModelConfig, dtype=None):
    """`init_params`'s shapes and dtypes on the ``meta`` device (no
    memory)."""
    dt = torch_dtype(dtype or cfg.dtype)
    return tree_map(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                    model_defs(cfg))


def from_reference(tree, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree on `device`
    (None: the card), dtypes kept."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
            return torch.as_tensor(a.astype(np.float32), device=dev).to(
                torch.bfloat16)
        return torch.tensor(a, device=dev)  # copies: JAX's are read-only

    return tree_map(conv, tree)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
