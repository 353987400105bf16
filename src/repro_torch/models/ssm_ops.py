"""Plain PyTorch SSD and causal convolution used inside the Mamba block
(counterpart of `repro.models.ssm_ops`).

`ssd_chunked` is the same math as the SSD kernel, written as einsums over
(chunks, L, L) tiles with a Python loop carrying the chunk-to-chunk
state: the block's ``use_kernel=False`` route, and an implementation
independent of both `kernels.ref.ssd` and the CUDA kernel.

Shapes: x (B, T, H, P), a_log (B, T, H) <= 0, b, c (B, T, N); returns
(y (B, T, H, P) in x's dtype, final_state (B, H, P, N) float32).
`ssd_chunked_jnp` is the reference's name for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import hlo


def _pad_time(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended along axis 1 (time)."""
    return F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad))


def ssd_chunked(x, a_log, b, c, init_state=None, *, chunk: int = 128):
    """Chunked SSD.  Pads T to whole chunks of min(chunk, T) with
    a_log = 0 and b = 0, which carry the state through unchanged."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    lt = min(chunk, t)
    pad = (-t) % lt
    if pad:
        x, a_log, b, c = (_pad_time(v, pad) for v in (x, a_log, b, c))
    nc = (t + pad) // lt

    xf = x.reshape(bsz, nc, lt, h, p).float()
    al = a_log.reshape(bsz, nc, lt, h).float()
    bf = b.reshape(bsz, nc, lt, n).float()
    cf = c.reshape(bsz, nc, lt, n).float()

    lcum = torch.cumsum(al, dim=2)                    # (B,nc,L,H)
    total = lcum[:, :, -1]                            # (B,nc,H)

    # Intra-chunk: y[l] = sum_{s<=l} exp(lcum[l]-lcum[s]) <c_l, b_s> x_s
    cb = torch.einsum("bcln,bcsn->bcls", cf, bf)      # shared across heads
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # (B,nc,L,L,H)
    tri = torch.ones((lt, lt), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None],
                        torch.exp(torch.clamp(ldiff, max=0.0)), 0.0)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", cb[..., None] * decay, xf)

    # Inter-chunk state: inj_c = sum_s exp(total-lcum[s]) x_s b_s^T
    w = torch.exp(total[:, :, None, :] - lcum)        # (B,nc,L,H)
    inj = torch.einsum("bclhp,bcln->bchpn", w[..., None] * xf, bf)
    cdecay = torch.exp(total)                         # (B,nc,H)

    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    h_prev = []                                       # state BEFORE chunk
    for j in range(nc):
        h_prev.append(state)
        state = state * cdecay[:, j, :, None, None] + inj[:, j]
    h_prev = torch.stack(h_prev, 1)                   # (B,nc,H,P,N)

    y_state = torch.einsum("bclh,bcln,bchpn->bclhp", torch.exp(lcum), cf,
                           h_prev)
    y = (y_intra + y_state).reshape(bsz, nc * lt, h, p)[:, :t]
    return y.to(x.dtype), state


def ssd_decode_step(x, a_log, b, c, state):
    """Single-token SSD update: x (B, H, P), a_log (B, H), b, c (B, N),
    state (B, H, P, N) -> (y (B, H, P), new_state)."""
    dec = torch.exp(a_log.float())[:, :, None, None]
    state = state * dec + x.float()[:, :, :, None] * b.float()[:, None,
                                                               None, :]
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    return y.to(x.dtype), state


ssd_chunked_jnp = ssd_chunked  # the reference's name


def causal_conv(x, w, bias):
    """Depthwise causal conv: x (B, T, C), w (K, C), bias (C,).  K shifted
    multiply-adds in float32 (no cuDNN, whose float32 convolution runs
    in TF32 by default on the card); an active `utils.hlo.OpCounter` is
    told the convolution's 2 B T C K flops, which the multiply-adds do
    not show (the reference's analyzer counts its convolution's)."""
    k = w.shape[0]
    t = x.shape[1]
    hlo.count_flops("causal_conv", 2 * x.shape[0] * t * x.shape[2] * k)
    xp = F.pad(x.float(), (0, 0, k - 1, 0))           # K-1 zeros in front
    wf = w.float()
    out = xp[:, 0:t] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * wf[i]
    return (out + bias.float()).to(x.dtype)


def causal_conv_step(x_new, conv_state, w, bias):
    """Decode-time conv: x_new (B, C), conv_state (B, K-1, C) holding the
    last K-1 inputs -> (y (B, C), new_state)."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full.float(), w.float()) + bias.float()
    return y.to(x_new.dtype), full[:, 1:]
