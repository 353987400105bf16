"""Model forward passes of the port (counterpart of
`repro.models.transformer`): the stage-stacked decoder.

Each Stage's block parameters carry a leading ``repeats`` axis; the
reference scans it with `jax.lax.scan`, the port walks it with a Python
loop over views of the stacked tensors.  New K/V of every layer are
collected and committed once per stage after the loop (the deferred
commit), as in the reference; so are the Mamba layers' new ``ssm`` and
``conv`` states, which the port writes into the stacked cache in place
where the reference hands back new arrays.

Entry points:
  forward(...)      — full-sequence logits (training / prefill)
  decode_step(...)  — one token against caches
  init_caches(...)  — stacked per-stage cache dicts
  lm_loss(...)      — next-token cross-entropy (training)

``impl`` takes the reference's values: ``"xla"`` is the plain PyTorch
attention (`layers.mha_xla` / `mha_chunked`), ``"pallas"`` the
hand-written flash-attention kernel through `kernels.ops.flash_attention`
for causal layers — on a CUDA tensor the CUDA kernel, on a CPU tensor its
plain version `kernels.ref.mha` — and ``"pallas_ssd"`` the hand-written
SSD scan through `kernels.ops.ssd` for Mamba layers (the CUDA kernel, or
its plain version `kernels.ref.ssd`); every other value takes the plain
chunked SSD (`ssm_ops.ssd_chunked`) there.  Decode always takes the plain
two-piece softmax (`layers.mha_decode`) and the plain one-step SSD
update, as in the reference.

Training differentiates this forward with autograd.  As in the
reference, it runs ``impl="xla"``: plain attention and the plain chunked
SSD (none of the hand-written kernels has a backward, nor has any of the
reference's Pallas kernels).  ``remat=True`` wraps each iteration of the
stage loop, one stacked block, in `torch.utils.checkpoint.checkpoint`
(the reference's `jax.checkpoint` around its scan body): one saved input
a block, the block recomputed in the backward pass.  A layer's
parameters are views of the stacked tensors (`_unbind`), so their
gradients flow into the stacked leaves, stacked once a leaf.  What
waits: `encode` (the encoder-decoder models) and the mesh `ctx`, which
one card does not need.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.config import LayerSpec, ModelConfig, Stage
from repro_torch.models.params import check_supported


def _sublayer(lp: Dict[str, Any], cfg: ModelConfig, spec: LayerSpec,
              x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, Any]], impl: str):
    """One residual block: (attention | mamba) + (MLP | MoE).  Returns
    (x, new, aux): the new K/V of an attention layer or the new states of
    a Mamba layer (None without a cache), and the MoE's float32 aux loss
    (None without an MoE)."""
    h = L.norm(lp, cfg, x, "ln1")
    if spec.kind == "attn":
        h, new = L.attention(lp, cfg, spec, h, positions,
                             cache=None if cache is None else cache["kv"],
                             impl=impl)
    else:
        h, new = M.mamba_block(
            lp, cfg, h, cache=None if cache is None else cache["ssm_cache"],
            use_kernel=(impl == "pallas_ssd"))
    if cfg.post_norm:
        h = L.norm(lp, cfg, h, "post1")
    x = x + h
    aux = None
    if spec.moe or cfg.d_ff > 0:  # mamba2-style layers have no MLP block
        h = L.norm(lp, cfg, x, "ln2")
        if spec.moe:
            h, aux = L.moe_mlp(lp["moe"], cfg, h)
        else:
            h = L.mlp(lp["mlp"], cfg, h)
        if cfg.post_norm:
            h = L.norm(lp, cfg, h, "post2")
        x = x + h
    return x, new, aux


def _add_aux(total: torch.Tensor, aux: Optional[torch.Tensor]):
    """The reference's float32 ``aux + a`` (nothing to add for a layer
    without an MoE)."""
    return total if aux is None else total + aux


def _index(tree, r: int):
    """Layer `r` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree, repeats: int) -> list:
    """The layers of a stacked tree as a list of trees of views, cut by
    one `unbind` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer (`_index`) would make each layer's gradient
    a zero-filled tensor of the whole stack and add them up (a full-size
    add a layer)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, repeats) for k, v in tree.items()}
        return [{k: layers[r] for k, layers in per_key.items()}
                for r in range(repeats)]
    return tree.unbind(0)


def _block(layer_p, cfg: ModelConfig, stage: Stage, x: torch.Tensor,
           positions: torch.Tensor, impl: str, aux: torch.Tensor):
    """One stacked block without caches (the unit `remat` recomputes):
    (x, aux plus its sub-layers' aux, in block order)."""
    for i, spec in enumerate(stage.block):
        x, _, a = _sublayer(layer_p[f"sub{i}"], cfg, spec, x, positions,
                            None, impl)
        aux = _add_aux(aux, a)
    return x, aux


def _stage_forward(sp: Dict[str, Any], cfg: ModelConfig, stage: Stage,
                   x: torch.Tensor, positions: torch.Tensor,
                   cache: Optional[Dict[str, Any]], impl: str,
                   remat: bool = False):
    """Run the stacked block `stage.repeats` times; cache leaves carry a
    leading (repeats,) dim and are committed once after the loop.  With
    `remat` (and no cache) each block runs under activation
    checkpointing.  Returns (x, new caches, the stage's float32 aux:
    its MoE layers' in order from 0, as the reference's scan carries
    it)."""
    layers = _unbind(sp, stage.repeats)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is None:
        for layer_p in layers:
            if remat:
                x, aux = checkpoint(_block, layer_p, cfg, stage, x,
                                    positions, impl, aux,
                                    use_reentrant=False)
            else:
                x, aux = _block(layer_p, cfg, stage, x, positions, impl, aux)
        return x, None, aux
    new = {f"sub{i}": [] for i in range(len(stage.block))}
    for r, layer_p in enumerate(layers):
        layer_cache = _index(cache, r)
        for i, spec in enumerate(stage.block):
            x, out, a = _sublayer(layer_p[f"sub{i}"], cfg, spec, x,
                                  positions, layer_cache[f"sub{i}"], impl)
            new[f"sub{i}"].append(out)
            aux = _add_aux(aux, a)
    return x, _commit_stage_cache(stage, cache, new, positions), aux


def _commit_stage_cache(stage: Stage, cache, new, positions):
    """Apply the deferred commits, one write per stage, sub-layer and
    cache leaf, in place: K/V through `layers.commit_kv`; a Mamba layer's
    ``ssm`` (L, B, H, P, N) float32 and ``conv`` (L, B, K-1, C) states
    stacked over the stage's layers and copied over the old ones."""
    for i, spec in enumerate(stage.block):
        outs = new[f"sub{i}"]
        if spec.kind == "attn":
            k = torch.stack([kv["k"] for kv in outs])   # (L, B, H, T, D)
            v = torch.stack([kv["v"] for kv in outs])
            L.commit_kv(cache[f"sub{i}"]["kv"], k, v, positions)
        else:
            for name, old in cache[f"sub{i}"]["ssm_cache"].items():
                old.copy_(torch.stack([mc[name] for mc in outs]))
    return cache


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(L.torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.norm(params, cfg, x, "final")
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w.to(x.dtype)).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding rows
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, L.NEG_INF)
    return logits


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None, impl: str = "xla",
            remat: bool = False):
    """Full-sequence forward.  tokens: (B, T) integer.

    Returns (logits (B, T, V) float32, new_caches, aux); aux is the
    float32 sum over stages of the MoE layers' load-balancing losses (0
    without an MoE layer), as the reference's.  With `caches`, the new
    K/V and Mamba states are committed into them in place and the same
    dicts come back.  `remat` checkpoints each
    block (training; ignored with `caches`).  It defaults to False where
    the reference's defaults to True: the port's serving paths call
    `forward` without it, and only a differentiated forward can tell.
    """
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for i, st in enumerate(cfg.stages):
        stage_cache = None if caches is None else caches[f"stage{i}"]
        x, nc, a = _stage_forward(params["stages"][f"stage{i}"], cfg, st, x,
                                  positions, stage_cache, impl, remat)
        aux = aux + a
        if nc is not None:
            new_caches[f"stage{i}"] = nc
    return _head(params, cfg, x), (new_caches or None), aux


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                lengths: torch.Tensor,
                caches: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1), lengths (B,) current cache lengths.
    Returns (logits (B, 1, V), new_caches); the MoE aux is dropped, as in
    the reference."""
    positions = lengths[:, None].to(torch.int32)
    logits, new_caches, _ = forward(params, cfg, tokens, positions=positions,
                                    caches=caches, impl="xla")
    return logits, new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device=None) -> Dict[str, Any]:
    """Stacked cache dicts matching the stage structure, on `device`
    (None: the card): ``{"kv": ...}`` for an attention sub-layer,
    ``{"ssm_cache": {"ssm", "conv"}}`` for a Mamba one."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    caches: Dict[str, Any] = {}
    for i, st in enumerate(cfg.stages):
        sub: Dict[str, Any] = {}
        for j, spec in enumerate(st.block):
            if spec.kind == "attn":
                kv = L.init_kv_cache(cfg, spec, batch * st.repeats, max_len,
                                     dt, dev)
                name = "kv"
            else:
                kv = M.init_mamba_cache(cfg, batch * st.repeats, dt, dev)
                name = "ssm_cache"
            sub[f"sub{j}"] = {name: {
                leaf: a.reshape((st.repeats, batch) + a.shape[1:])
                for leaf, a in kv.items()}}
        caches[f"stage{i}"] = sub
    return caches


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "xla", remat: bool = True, aux_weight: float = 0.01):
    """Next-token cross-entropy.  batch: tokens (B, T), labels (B, T) with
    -1 for ignored positions.  Returns (total, {"ce", "moe_aux",
    "ntokens"}) as the reference does: total = ce + aux_weight x the
    model's MoE aux (0 without an MoE layer).  The label's logit is a
    gather where the reference takes a one-hot einsum (a sum with one
    non-zero term: the same value)."""
    logits, _, aux = forward(params, cfg, batch["tokens"], impl=impl,
                             remat=remat)
    labels = batch["labels"]
    valid = labels >= 0
    labels_c = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)                       # (B, T)
    ll = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    ce = torch.where(valid, logz - ll, 0.0)
    ntok = torch.clamp(valid.sum(), min=1)
    loss = ce.sum() / ntok
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux, "ntokens": ntok}
