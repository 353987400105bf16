"""Model layers of the port (counterpart of `repro.models.layers`): norms,
RoPE, attention (plain PyTorch and the hand-written kernel), MLP.

Plain functions on tensors, as in the reference: `fn(params_subtree, cfg,
x, ...) -> y`.  Compute is float32 inside, activations flow in
``cfg.dtype``.  Attention logits are taken in float32 from the stored
values (q and k upcast before the product, as the reference's
``preferred_element_type=float32``); probabilities are rounded to the
value dtype before the second product, as there.

`moe_mlp` is the reference's top-k routed MoE with one dispatch group
(one card: the reference's single-device ``dp_size`` 1).
`cross_attention` and `encode_cross_kv` are the decoder's attention over
the encoder's output (whisper-medium), plain attention as in the
reference.  Left out: the mesh `ctx` (sharding constraints,
GQA-expanded caches, aligned in-place cache writes, the MoE's per-shard
groups and all-to-alls) — one card needs no mesh.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import LayerSpec, ModelConfig

NEG_INF = -2.0e38  # masked-logit fill of the reference (not -inf)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config dtype name ("bfloat16", "float32") or a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


# ------------------------------------------------------------------ norms --

def norm(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
         prefix: str) -> torch.Tensor:
    scale = p[f"{prefix}_scale"].float()
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * scale \
            + p[f"{prefix}_bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * scale
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the head_dim axis (gemma3 qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- rope --

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading `fraction` of head dims.

    x: (B, H, T, D); positions: (B, T).
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None, :, None].float() * freq          # (B,1,T,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# -------------------------------------------------------------- attention --

# Above this many query positions, full-sequence attention switches to the
# query-chunked formulation (memory O(bq*T), window-limited K/V slices).
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_Q = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def mha_chunked(q, k, v, qpos, kpos, *, causal: bool, window: int,
                softcap: float, scale: float,
                block_q: int = CHUNK_Q) -> torch.Tensor:
    """Query-chunked attention for long prefill (plain path).

    Loops over query blocks so logits never exceed (B, H, bq, S); for
    causal sliding-window layers each block reads only the K/V slice
    [block_end - window - bq, block_end), as the reference does.
    """
    b, h, t, d = q.shape
    s = k.shape[2]
    nb = -(-t // block_q)
    pad = nb * block_q - t
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
    limited = causal and window > 0 and t == s
    kwin = min(_round_up(window + block_q, block_q), s) if limited else s
    blocks = []
    for i in range(nb):
        qi = q[:, :, i * block_q:(i + 1) * block_q]
        qpi = qpos[:, i * block_q:(i + 1) * block_q]
        if limited:
            start = min(max((i + 1) * block_q - kwin, 0), s - kwin)
            ki, vi = k[:, :, start:start + kwin], v[:, :, start:start + kwin]
            kpi = kpos[:, start:start + kwin]
        else:
            ki, vi, kpi = k, v, kpos
        # padded query rows (qpos -1) are sliced off below
        blocks.append(mha_xla(qi, ki, vi,
                              torch.where(qpi < 0, 2 ** 30, qpi), kpi,
                              causal=causal, window=window, softcap=softcap,
                              scale=scale))
    return torch.cat(blocks, 2)[:, :, :t]


def mha_xla(q, k, v, qpos, kpos, *, causal: bool, window: int,
            softcap: float, scale: float) -> torch.Tensor:
    """Masked GQA attention, the plain path (the reference's XLA path).

    q: (B, Hq, Tq, D); k, v: (B, Hkv, S, D); qpos: (B, Tq); kpos: (B, S)
    with kpos < 0 marking invalid (unfilled cache, padding) slots.
    Query head h reads kv head h // (Hq / Hkv).
    """
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = kpos[:, None, :] >= 0
    if causal:
        mask = mask & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (kpos[:, None, :] > qpos[:, :, None] - window)
    mask = mask[:, None]                                      # (B,1,Tq,S)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    den = e.sum(-1, keepdim=True)
    p = (e / torch.clamp(den, min=1e-30)).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
    return out.to(q.dtype)


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-layer KV cache.  Windowed layers get a ring buffer of size
    min(window, max_len)."""
    s = min(spec.window, max_len) if spec.window > 0 else max_len
    h = cfg.num_kv_heads
    dt = torch_dtype(dtype)
    return {
        "k": torch.zeros((batch, h, s, cfg.head_dim), dtype=dt,
                         device=device),
        "v": torch.zeros((batch, h, s, cfg.head_dim), dtype=dt,
                         device=device),
        "pos": torch.full((batch, s), -1, dtype=torch.int32, device=device),
    }


def commit_kv(cache, k_new, v_new, positions):
    """Write T new entries at slots positions % S (ring for windowed).

    Called once per stage after the layer loop (the deferred cache
    commit).  Shapes (stacked over layers): cache k/v (L,B,H,S,D), pos
    (L,B,S); k_new/v_new (L,B,H,T,D); positions (B,T).  Unstacked 4-dim
    k/v are accepted too (one layer).  If T > S only the last S tokens
    are written.  Negative (padding) positions land in slots
    ``positions % S`` with Python's sign rule, as in the reference, and
    stay masked by their negative ``pos``.

    The port writes into `cache` in place and returns it; the reference
    returns new arrays.  Its `aligned` in-place variant is a mesh
    concern and waits.
    """
    s = cache["k"].shape[-2]
    t = k_new.shape[-2]
    if t > s:
        k_new, v_new = k_new[..., -s:, :], v_new[..., -s:, :]
        positions = positions[:, -s:]
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    if ck.ndim == 4:  # one layer: view it as a stack of one
        ck, cv, cp = ck[None], cv[None], cp[None]
        k_new, v_new = k_new[None], v_new[None]
    dt = ck.dtype
    k_new, v_new = k_new.to(dt), v_new.to(dt)
    slots = torch.remainder(positions, s).long()              # (B, T)
    pos = positions.to(cp.dtype)
    for b in range(slots.shape[0]):
        ck[:, b].index_copy_(2, slots[b], k_new[:, b])
        cv[:, b].index_copy_(2, slots[b], v_new[:, b])
        cp[:, b].index_copy_(1, slots[b],
                             pos[b].expand(cp.shape[0], pos.shape[1]))
    return cache


def mha_decode(q, k_cache, v_cache, k_new, v_new, qpos, kpos, *,
               window: int, softcap: float, scale: float) -> torch.Tensor:
    """One-token attention over a STALE cache plus the current token.

    Two-piece softmax: logits over the cache (B,H,1,S) and over the self
    token (B,H,1,1) are normalized jointly, so attention never needs the
    new token written into the cache first (deferred commit).
    """
    hq = q.shape[1]
    g = hq // k_cache.shape[1]
    if g > 1:
        k_cache = k_cache.repeat_interleave(g, dim=1)
        v_cache = v_cache.repeat_interleave(g, dim=1)
        k_new = k_new.repeat_interleave(g, dim=1)
        v_new = v_new.repeat_interleave(g, dim=1)
    qf = q.float()
    lc = torch.einsum("bhqd,bhkd->bhqk", qf, k_cache.float()) * scale
    ls = torch.einsum("bhqd,bhqd->bhq", qf, k_new.float())[..., None] * scale
    if softcap > 0:
        lc = softcap * torch.tanh(lc / softcap)
        ls = softcap * torch.tanh(ls / softcap)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (kpos[:, None, :] > qpos[:, :, None] - window)
    mask = mask[:, None]
    lc = torch.where(mask, lc, NEG_INF)
    m = torch.maximum(lc.amax(-1, keepdim=True), ls)
    ec = torch.where(mask, torch.exp(lc - m), 0.0)
    es = torch.exp(ls - m)
    den = ec.sum(-1, keepdim=True) + es
    pc = (ec / den).to(v_cache.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", pc.float(), v_cache.float())
    out = out + (es / den) * v_new.float()
    return out.to(q.dtype)


def _full_attention(q, k, v, positions, spec, cfg, scale, impl):
    """Full-sequence attention dispatch: the hand-written kernel for
    ``impl="pallas"`` on a causal layer (its plain version for a CPU
    tensor), query-chunked plain attention above the threshold, one
    plain masked product otherwise."""
    if impl == "pallas" and spec.causal:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True, window=spec.window,
                                    softcap=cfg.attn_softcap, scale=scale)
    if q.shape[2] >= CHUNKED_ATTN_THRESHOLD:
        return mha_chunked(q, k, v, positions, positions, causal=spec.causal,
                           window=spec.window, softcap=cfg.attn_softcap,
                           scale=scale)
    return mha_xla(q, k, v, positions, positions, causal=spec.causal,
                   window=spec.window, softcap=cfg.attn_softcap, scale=scale)


def attention(p: Dict[str, Any], cfg: ModelConfig, spec: LayerSpec,
              x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              impl: str = "xla"):
    """Self-attention with optional KV cache.  Returns (out, kv_new):
    kv_new holds this call's K/V for the deferred commit when a cache is
    given, else None."""
    b, t, _ = x.shape
    ap = p["attn"]
    q = x @ ap["wq"].to(x.dtype)
    k = x @ ap["wk"].to(x.dtype)
    v = x @ ap["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + ap["bq"].to(x.dtype)
        k = k + ap["bk"].to(x.dtype)
        v = v + ap["bv"].to(x.dtype)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_head_norm(ap["q_norm"], q)
        k = rms_head_norm(ap["k_norm"], k)
    theta = spec.rope_theta or cfg.rope_theta
    if cfg.rope_fraction > 0 and not cfg.learned_pos:
        q = rope(q, positions, theta, cfg.rope_fraction)
        k = rope(k, positions, theta, cfg.rope_fraction)

    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else cfg.head_dim ** -0.5

    kv_out = None
    if cache is not None and t == 1:
        # Decode: attend over the stale cache + current token; the cache
        # write is deferred to one post-stage commit (commit_kv).
        out = mha_decode(q, cache["k"], cache["v"], k, v, positions,
                         cache["pos"], window=spec.window,
                         softcap=cfg.attn_softcap, scale=scale)
        kv_out = {"k": k, "v": v}
    else:
        # Full sequence (a fresh prefill attends over its own keys, exact
        # even past a ring cache); a cache write is deferred.
        out = _full_attention(q, k, v, positions, spec, cfg, scale, impl)
        if cache is not None:
            kv_out = {"k": k, "v": v}

    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim)
    return out @ ap["wo"].to(x.dtype), kv_out


def cross_attention(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, Hkv, S,
    D): plain `mha_xla` with every position 0, not causal, no window or
    softcap, at scale ``head_dim ** -0.5`` whatever ``cfg.attn_scale``
    says, as in the reference."""
    b, t, _ = x.shape
    ap = p["attn"]
    q = (x @ ap["xq"].to(x.dtype)).reshape(
        b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k, v = enc_kv
    qpos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, k.shape[2]), dtype=torch.int32, device=x.device)
    out = mha_xla(q, k, v, qpos, kpos, causal=False, window=0, softcap=0.0,
                  scale=cfg.head_dim ** -0.5)
    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim)
    return out @ ap["xo"].to(x.dtype)


def encode_cross_kv(p: Dict[str, Any], cfg: ModelConfig,
                    enc_out: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The cross-attention K/V of the encoder's output (B, S, d):
    (B, Hkv, S, D) each."""
    b, s, _ = enc_out.shape
    ap = p["attn"]
    k = (enc_out @ ap["xk"].to(enc_out.dtype)).reshape(
        b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = (enc_out @ ap["xv"].to(enc_out.dtype)).reshape(
        b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return k, v


# -------------------------------------------------------------------- MLP --

def _act(cfg: ModelConfig, gate: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("swiglu",):
        return F.silu(gate)
    return F.gelu(gate, approximate="tanh")


def mlp(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("swiglu", "geglu"):
        h = _act(cfg, x @ p["w_gate"].to(x.dtype)) * (
            x @ p["w_up"].to(x.dtype))
    else:
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


# -------------------------------------------------------------------- MoE --

def moe_mlp(p: Dict[str, Any], cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with capacity-based dispatch (Switch semantics):
    the reference's `moe_mlp` with one group.  Returns (y in x's dtype,
    the float32 load-balancing aux loss).

    * Router logits in float32 from the stored values, their softmax
      `probs`; the top k by a stable descending sort, so that equal
      logits go lowest expert first as ``jax.lax.top_k`` puts them
      (`torch.topk` orders ties arbitrarily, and the order decides each
      pair's rank, so what capacity drops, and which weight goes with
      which expert); the k kept logits renormalised by a softmax.
    * aux = E * sum_e(mean(probs)_e * f_e), f_e the share of the n k
      (token, choice) pairs that chose e, summed as the reference does,
      1 / (n k) a pair (every addend is equal, so any order of the adds
      gives the same sum).
    * Capacity: every pair is kept for n <= ``no_drop_threshold`` (cap =
      n), else cap = min(max(8, ceil(capacity_factor n k / E)), n).  The
      pairs in token-major order, choices in top-k order; a pair's rank
      is the count of earlier pairs with the same expert, and it is kept
      if rank < cap, in slot e cap + rank.
    * Dispatch: (E, cap, d) rows gathered from x (an empty slot reads a
      zero row); the expert products in x's dtype; each pair's weight in
      x's dtype times its expert's output row, as the reference's
      ``wtab``.
    * Combine without atomics: each token sums its kept pairs' rows in
      ascending slot order in x's dtype, the order of the reference's
      sequential scatter-add, starting from zero; a dropped pair adds
      nothing.  `index_add_` on the card would add a token's k rows in
      an order that changes from run to run.  The slot tables are built
      with no repeated index (a dropped pair writes to a spare entry of
      its own), so no write races another.

    Kept on purpose, as in the reference: the drop-free branch lays out
    E x n rows, E / k times what the tokens need (4x for granite-moe-1b),
    and computes all of them; a grouped product over the kept rows only
    is later speed work.  Differentiable by autograd: to x, the router
    (through the kept weights and `probs`) and the expert weights.
    """
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    b, t, d = x.shape
    n = b * t
    dev = x.device
    xf = x.reshape(n, d)
    r = moe_route(xf.float() @ p["router"].float(), cfg.moe)
    cap, slot, keep = r["cap"], r["slot"], r["keep"]

    # slot -> token: the kept slots are distinct; a dropped pair writes to
    # a spare entry of its own past e cap, so no index repeats
    pairs = torch.arange(n * k, device=dev)
    spare = torch.where(keep, slot, e * cap + pairs)
    table = torch.full((e * cap + n * k,), n, dtype=torch.long,
                       device=dev).scatter(0, spare, pairs // k)[:e * cap]
    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    xe = x_pad[table].reshape(e, cap, d)

    if cfg.act in ("swiglu", "geglu"):
        h = _act(cfg, torch.bmm(xe, p["w_gate"].to(x.dtype)))
        h = h * torch.bmm(xe, p["w_up"].to(x.dtype))
    else:
        h = F.gelu(torch.bmm(xe, p["w_up"].to(x.dtype)), approximate="tanh")
    ye = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(e * cap, d)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))])              # trash row

    # each token's k pairs in ascending slot order (dropped ones last)
    slots, order = torch.sort(slot.reshape(n, k), dim=1)
    w = r["top_w"].to(x.dtype).gather(1, order)
    rows = ye_pad[slots] * w[..., None]                         # (n, k, d)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y.reshape(b, t, d), r["aux"]


def moe_route(logits: torch.Tensor, mcfg) -> Dict[str, Any]:
    """`moe_mlp`'s routing of n tokens from their float32 router logits
    (n, E): ``top_e`` (n, k) the chosen experts in top-k order, ``top_w``
    their renormalised float32 weights, ``aux`` the load-balancing loss,
    ``cap`` the capacity, and per (token, choice) pair, token-major,
    ``keep`` and ``slot`` (e cap + rank, or E cap if dropped)."""
    n, e = logits.shape
    k = mcfg.top_k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_e = ranked.indices[:, :k]
    top_w = torch.softmax(ranked.values[:, :k], dim=-1)

    flat_e = top_e.reshape(n * k)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.full((n * k,), 1.0 / (n * k), dtype=torch.float32,
                              device=dev))
    aux = e * torch.sum(probs.mean(0) * ce)

    if n <= mcfg.no_drop_threshold:
        cap = n     # exact (drop-free) routing for decode and small batches
    else:
        cap = min(max(8, int(math.ceil(mcfg.capacity_factor * n * k / e))),
                  n)
    onehot = (flat_e[:, None] == torch.arange(e, device=dev)).long()
    rank = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = rank < cap
    return dict(top_e=top_e, top_w=top_w, aux=aux, cap=cap, keep=keep,
                slot=torch.where(keep, flat_e * cap + rank, e * cap))
