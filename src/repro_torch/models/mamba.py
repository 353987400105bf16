"""Mamba-2 block (SSD layer) of the port (counterpart of
`repro.models.mamba`): the layer of mamba2-1.3b.

Cache layout (decode): {"ssm": (B, H, P, N) float32, "conv": (B, K-1, C)};
constant-size state, so a decode step is O(1) in the sequence length.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import ssm_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    ssm = cfg.ssm
    d = cfg.d_model
    din = ssm.d_inner(d)
    gn = ssm.n_groups * ssm.d_state
    h = ssm.num_heads(d)
    return {
        "ssm": torch.zeros((batch, h, ssm.head_dim, ssm.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ssm.conv_kernel - 1, din + 2 * gn),
                            dtype=torch_dtype(dtype), device=device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """The projection's z | xs | b | c | dt pieces."""
    ssm = cfg.ssm
    din = ssm.d_inner(cfg.d_model)
    gn = ssm.n_groups * ssm.d_state
    h = ssm.num_heads(cfg.d_model)
    z, xs, b, c, dt = torch.split(proj, [din, din, gn, gn, h], dim=-1)
    return z, xs, b, c, dt


def mamba_block(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence Mamba-2 block.  x: (B, T, d).  If `cache` is given
    and T == 1, runs the O(1) decode step instead.  `use_kernel` sends
    the scan through `kernels.ops.ssd` (the CUDA kernel on the card, its
    plain version on the CPU), else through `ssm_ops.ssd_chunked`.
    Returns (out, new_cache); new_cache is None without a cache."""
    mp = p["mamba"]
    ssm = cfg.ssm
    bsz, t, d = x.shape
    din = ssm.d_inner(d)
    gn = ssm.n_groups * ssm.d_state
    h = ssm.num_heads(d)

    proj = x @ mp["in_proj"].to(x.dtype)            # (B,T,2din+2gn+H)
    z, xs, b, c, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xs, b, c], dim=-1)         # (B,T,din+2gn)
    decode = cache is not None and t == 1
    if decode:
        conv_out, conv_state = ssm_ops.causal_conv_step(
            conv_in[:, 0], cache["conv"], mp["conv_w"], mp["conv_b"])
        conv_out = conv_out[:, None, :]
    else:
        conv_out = ssm_ops.causal_conv(conv_in, mp["conv_w"], mp["conv_b"])
        conv_state = (conv_in[:, -(ssm.conv_kernel - 1):]
                      if cache is not None else None)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xs, b, c = torch.split(conv_out, [din, gn, gn], dim=-1)

    dt = F.softplus(dt.float() + mp["dt_bias"].float())     # (B,T,H)
    a_log_t = -torch.exp(mp["a_log"].float()) * dt          # <= 0
    heads = xs.reshape(bsz, t, h, ssm.head_dim)
    x_eff = heads * dt[..., None].to(x.dtype)

    init = cache["ssm"] if cache is not None else None
    if decode:
        y, ssm_state = ssm_ops.ssd_decode_step(
            x_eff[:, 0], a_log_t[:, 0], b[:, 0], c[:, 0], init)
        y = y[:, None]
    elif use_kernel:
        from repro_torch.kernels import ops as kops
        y, ssm_state = kops.ssd(x_eff, a_log_t, b, c, init_state=init,
                                block_t=ssm.chunk)
    else:
        y, ssm_state = ssm_ops.ssd_chunked(x_eff, a_log_t, b, c,
                                           init_state=init, chunk=ssm.chunk)

    y = y + heads * mp["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, t, din)

    # Gated RMSNorm (Mamba-2): norm(y * silu(z)) * scale.
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(ms + 1e-6) * mp["gate_norm_scale"].float()
    out = g.to(x.dtype) @ mp["out_proj"].to(x.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {"ssm": ssm_state, "conv": conv_state}
    return out, new_cache
