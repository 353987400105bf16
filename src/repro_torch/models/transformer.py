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
  encode(...)       — the encoder stack (encoder-decoder models)
  init_caches(...)  — stacked per-stage cache dicts
  abstract_caches(...) — their shapes on the ``meta`` device
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
gradients flow into the stacked leaves, stacked once a leaf.

The encoder-decoder (whisper-medium): `encode` runs the encoder stages
over stub frame embeddings; a decoder layer with ``cross`` attends over
the encoder's output through `layers.cross_attention`.  A prefill given
``enc_out`` computes each layer's cross K/V and writes them into the
stacked cache in place; a decode (no ``enc_out``) reads them from the
cache.  The encoder and cross-attention take the plain attention under
every ``impl``, as in the reference (its kernel takes causal layers
only).  A vision model (internvl2-2b) takes ``frontend`` embeddings put
before the token embeddings, one causal stream.

Left out: the mesh `ctx` and the reference's ``kv_heads=`` cache
override (GQA-expanded caches for tensor parallelism), which one card
does not need.
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
              cache: Optional[Dict[str, Any]],
              enc_out: Optional[torch.Tensor], impl: str):
    """One residual block: (attention | mamba) [+ cross-attention] + (MLP
    | MoE).  Returns (x, out, aux): `out` holds the new K/V of an
    attention layer (``"kv"``) or the new states of a Mamba layer
    (``"ssm_cache"``) when a cache is given, and the cross K/V computed
    from `enc_out` (``"cross"``) when a cache is given with it; aux is
    the MoE's float32 aux loss (None without an MoE)."""
    out: Dict[str, Any] = {}
    h = L.norm(lp, cfg, x, "ln1")
    if spec.kind == "attn":
        h, new = L.attention(lp, cfg, spec, h, positions,
                             cache=None if cache is None else cache["kv"],
                             impl=impl)
        name = "kv"
    else:
        h, new = M.mamba_block(
            lp, cfg, h, cache=None if cache is None else cache["ssm_cache"],
            use_kernel=(impl == "pallas_ssd"))
        name = "ssm_cache"
    if cache is not None:
        out[name] = new
    if cfg.post_norm:
        h = L.norm(lp, cfg, h, "post1")
    x = x + h
    if spec.cross:
        h = L.norm(lp, cfg, x, "ln_cross")
        # a prefill passes enc_out (cross K/V computed, then cached); a
        # decode passes none and reads the cached projections
        if enc_out is not None:
            kv = L.encode_cross_kv(lp, cfg, enc_out)
            if cache is not None:
                out["cross"] = kv
        elif cache is not None:
            kv = (cache["cross"]["k"], cache["cross"]["v"])
        else:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"enc_out or a cache holding the cross K/V")
        x = x + L.cross_attention(lp, cfg, h, kv)
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
    return x, out, aux


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
           positions: torch.Tensor, impl: str, aux: torch.Tensor,
           enc_out: Optional[torch.Tensor]):
    """One stacked block without caches (the unit `remat` recomputes):
    (x, aux plus its sub-layers' aux, in block order)."""
    for i, spec in enumerate(stage.block):
        x, _, a = _sublayer(layer_p[f"sub{i}"], cfg, spec, x, positions,
                            None, enc_out, impl)
        aux = _add_aux(aux, a)
    return x, aux


def _stage_forward(sp: Dict[str, Any], cfg: ModelConfig, stage: Stage,
                   x: torch.Tensor, positions: torch.Tensor,
                   cache: Optional[Dict[str, Any]], impl: str,
                   remat: bool = False,
                   enc_out: Optional[torch.Tensor] = None):
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
                                    positions, impl, aux, enc_out,
                                    use_reentrant=False)
            else:
                x, aux = _block(layer_p, cfg, stage, x, positions, impl, aux,
                                enc_out)
        return x, None, aux
    new = {f"sub{i}": [] for i in range(len(stage.block))}
    for r, layer_p in enumerate(layers):
        layer_cache = _index(cache, r)
        for i, spec in enumerate(stage.block):
            x, out, a = _sublayer(layer_p[f"sub{i}"], cfg, spec, x,
                                  positions, layer_cache[f"sub{i}"], enc_out,
                                  impl)
            new[f"sub{i}"].append(out)
            aux = _add_aux(aux, a)
    return x, _commit_stage_cache(stage, cache, new, positions), aux


def _commit_stage_cache(stage: Stage, cache, new, positions):
    """Apply the deferred commits, one write per stage, sub-layer and
    cache leaf, in place: K/V through `layers.commit_kv`; a Mamba layer's
    ``ssm`` (L, B, H, P, N) float32 and ``conv`` (L, B, K-1, C) states
    stacked over the stage's layers and copied over the old ones; a
    prefill's cross K/V (L, B, Hkv, S, D) copied over the old ones (a
    decode computes none and leaves them)."""
    for i, spec in enumerate(stage.block):
        outs, entry = new[f"sub{i}"], cache[f"sub{i}"]
        if spec.kind == "attn":
            k = torch.stack([o["kv"]["k"] for o in outs])  # (L, B, H, T, D)
            v = torch.stack([o["kv"]["v"] for o in outs])
            L.commit_kv(entry["kv"], k, v, positions)
        else:
            for name, old in entry["ssm_cache"].items():
                old.copy_(torch.stack([o["ssm_cache"][name] for o in outs]))
        if spec.cross and "cross" in outs[0]:
            for j, name in enumerate(("k", "v")):
                entry["cross"][name].copy_(
                    torch.stack([o["cross"][j] for o in outs]))
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


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           impl: str = "xla") -> torch.Tensor:
    """Encoder stack over stub frame embeddings (B, S, d): the frames in
    the model dtype plus ``enc_pos_embed[:S]``, the encoder stages at
    positions 0..S-1, then the ``enc_final`` norm.  The reference always
    runs it under remat, which changes no value; the port checkpoints
    each block only where autograd records (grad mode on)."""
    check_supported(cfg)
    x = frames.to(L.torch_dtype(cfg.dtype))
    if cfg.learned_pos and "enc_pos_embed" in params:
        x = x + params["enc_pos_embed"][:x.shape[1]].to(x.dtype)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=x.device)[None].expand(b, s)
    for i, st in enumerate(cfg.enc_stages):
        x, _, _ = _stage_forward(params["enc_stages"][f"stage{i}"], cfg, st,
                                 x, pos, None, impl, torch.is_grad_enabled())
    return L.norm(params, cfg, x, "enc_final")


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None, impl: str = "xla",
            remat: bool = False):
    """Full-sequence forward.  tokens: (B, T) integer.

    frontend: (B, Nf, d) precomputed patch embeddings (a vision model),
    cast to the model dtype and put before the token embeddings.
    enc_out: (B, S, d) the encoder's output (an encoder-decoder model).
    Positions default to ``arange`` over the whole stream (frontend rows
    included); a model with learned positions adds ``pos_embed`` at
    them.

    Returns (logits (B, T', V) float32, new_caches, aux), T' = Nf + T
    with a frontend, T otherwise; aux is the float32 sum over stages of
    the MoE layers' load-balancing losses (0 without an MoE layer), as
    the reference's.  With `caches`, the new K/V and Mamba states (and a
    prefill's cross K/V) are committed into them in place and the same
    dicts come back.  `remat` checkpoints each block (training; ignored
    with `caches`).  It defaults to False where the reference's defaults
    to True: the port's serving paths call `forward` without it, and
    only a differentiated forward can tell.
    """
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], 1)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
    if cfg.learned_pos:
        # negative (pad) positions wrap, as in the reference; a position
        # at or past the table has no row (the reference clamps it)
        x = x + params["pos_embed"][positions.long()].to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for i, st in enumerate(cfg.stages):
        stage_cache = None if caches is None else caches[f"stage{i}"]
        x, nc, a = _stage_forward(params["stages"][f"stage{i}"], cfg, st, x,
                                  positions, stage_cache, impl, remat,
                                  enc_out)
        aux = aux + a
        if nc is not None:
            new_caches[f"stage{i}"] = nc
    return _head(params, cfg, x), (new_caches or None), aux


def prefill_impl(cfg: ModelConfig) -> str:
    """The prefill's kernel route: ``"pallas_ssd"`` (the SSD scan) when
    the model has a Mamba layer, else ``"pallas"`` (flash attention)."""
    return ("pallas_ssd" if any(sl.kind == "mamba" for st in cfg.stages
                                for sl in st.block) else "pallas")


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                lengths: torch.Tensor,
                caches: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1), lengths (B,) current cache lengths.
    Returns (logits (B, 1, V), new_caches); the MoE aux is dropped, as in
    the reference.  A cross-attention layer reads its K/V from the
    cache."""
    positions = lengths[:, None].to(torch.int32)
    logits, new_caches, _ = forward(params, cfg, tokens, positions=positions,
                                    caches=caches, impl="xla")
    return logits, new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device=None, enc_len: int = 0) -> Dict[str, Any]:
    """Stacked cache dicts matching the stage structure, on `device`
    (None: the card): ``{"kv": ...}`` for an attention sub-layer,
    ``{"ssm_cache": {"ssm", "conv"}}`` for a Mamba one, and for a
    cross-attention layer ``{"cross": {"k", "v"}}``, zeros of (repeats,
    B, Hkv, S, D) with S = `enc_len` or ``cfg.num_audio_frames``.  The
    reference's cross ``k`` and ``v`` are one array; the port's are two
    tensors, since it writes caches in place."""
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
            entry = {name: {leaf: a.reshape((st.repeats, batch) + a.shape[1:])
                            for leaf, a in kv.items()}}
            if spec.cross:
                shape = (st.repeats, batch, cfg.num_kv_heads,
                         enc_len or cfg.num_audio_frames, cfg.head_dim)
                entry["cross"] = {
                    leaf: torch.zeros(shape, dtype=L.torch_dtype(dt),
                                      device=dev) for leaf in ("k", "v")}
            sub[f"sub{j}"] = entry
        caches[f"stage{i}"] = sub
    return caches


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                    enc_len: int = 0) -> Dict[str, Any]:
    """`init_caches`' shapes and dtypes on the ``meta`` device (no
    memory)."""
    return init_caches(cfg, batch, max_len, dtype, device="meta",
                       enc_len=enc_len)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            impl: str = "xla", remat: bool = True, aux_weight: float = 0.01):
    """Next-token cross-entropy.  batch: tokens (B, T), labels (B, T) with
    -1 for ignored positions, and ``frames`` (B, S, d) for an
    encoder-decoder (encoded first) or ``frontend`` (B, Nf, d) for a
    vision model (its rows of the logits are dropped before the loss).
    Returns (total, {"ce", "moe_aux", "ntokens"}) as the reference does:
    total = ce + aux_weight x the model's MoE aux (0 without an MoE
    layer).  The label's logit is a gather where the reference takes a
    one-hot einsum (a sum with one non-zero term: the same value)."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["frames"], impl=impl)
    frontend = batch.get("frontend")
    logits, _, aux = forward(params, cfg, batch["tokens"], frontend=frontend,
                             enc_out=enc_out, impl=impl, remat=remat)
    labels = batch["labels"]
    if cfg.num_frontend_tokens and frontend is not None:
        logits = logits[:, frontend.shape[1]:]
    valid = labels >= 0
    labels_c = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)                       # (B, T)
    ll = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    ce = torch.where(valid, logz - ll, 0.0)
    ntok = torch.clamp(valid.sum(), min=1)
    loss = ce.sum() / ntok
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux, "ntokens": ntok}
