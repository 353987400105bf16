"""Three-term roofline of one NVIDIA H100 SXM (counterpart of
`repro.utils.roofline`, whose constants are a TPU v5e's).

    compute term    = FLOPs/device / PEAK_FLOPS (bf16 dense, tensor cores)
    memory term     = HBM bytes/device / HBM_BW
    collective term = link traffic/device / ICI_BW (+ DCN bytes / DCN_BW)

The port runs on one card, so nothing crosses a link: the dry run
passes 0 collective bytes and the collective term reads 0.  The term and
its two rates (NVLink 4 at 450 GB/s a direction, a 400 Gb/s NIC) stay
so that a `Roofline` reads as the reference's, key for key.

The dominant term is the projected step-time lower bound; the roofline
fraction is the algorithm's own time (`ideal_s`) over the dominant
term's.

Beside the reference's model, the bounds of the two model kernels:
`attention_cost` and `ssd_cost` give (bound_ms, bound_by, bytes, flops)
of one call, the least time the card needs for the call's inputs.
`chip_smoke.py` prints them beside each kernel's time, and
`utils.hlo.analyze` counts them for each launch of `ops.flash_attention`
and `ops.ssd` (on the card and on ``meta``).  Float32 products count at
the split-TF32 rate (`F32_SPLIT_OPS_PER_S`: three TF32 products a
float32 product, `kernels/csrc/split_tf32.cuh`), above the CUDA cores'
67 TFLOP/s, so that no float32 kernel on the tensor cores can read
over 100% of its bound.

Left out: the reference's ``HBM_PER_CHIP`` (16 GB, a v5e chip) is
`HBM_PER_CARD` here (80 GB).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

# NVIDIA H100 SXM, one card, at its 700 W limit (NVIDIA's data sheet;
# dense rates, no sparsity)
HBM_BYTES_PER_S = 3.35e12   # device memory
BF16_OPS_PER_S = 989e12     # bf16 dense, tensor cores
TF32_OPS_PER_S = 494.7e12   # TF32 dense, tensor cores
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
# float32-exact work on the tensor cores: three TF32 products a product
# (split TF32, csrc/split_tf32.cuh), about 165 TFLOP/s, 2.5x the CUDA
# cores' 67: the least time the card needs for a float32 product
F32_SPLIT_OPS_PER_S = TF32_OPS_PER_S / 3
HBM_PER_CARD = 80e9         # capacity, bytes

# the reference's names for the roofline's rates
PEAK_FLOPS = BF16_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S
ICI_BW = 450e9              # NVLink 4, one direction
DCN_BW = 50e9               # a 400 Gb/s NIC

SSD_COST_CHUNK = 128        # `ssd_cost`'s chunk: the reference's at full width


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    ici_bytes_per_device: float
    dcn_bytes_per_device: float = 0.0
    model_flops_per_device: float = 0.0
    # Analytic minimum HBM traffic for the algorithm (params once, cache
    # once, activation stream) — the memory-side analogue of MODEL_FLOPS.
    model_bytes_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.ici_bytes_per_device / ICI_BW \
            + self.dcn_bytes_per_device / DCN_BW

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def ideal_s(self) -> float:
        """Best achievable step time: the algorithm's inherent work at peak
        (useful FLOPs at the bf16 peak, or minimal HBM traffic at full
        bandwidth, whichever binds)."""
        return max(self.model_flops_per_device / PEAK_FLOPS,
                   self.model_bytes_per_device / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        """ideal_s / bound_s: 1.0 = the program does no work beyond the
        algorithm's inherent compute/traffic; lower = waste (remat,
        redundancy, layout copies) in the dominant term."""
        if self.bound_s <= 0:
            return 0.0
        return min(self.ideal_s / self.bound_s, 1.0)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "ici_bytes_per_device": self.ici_bytes_per_device,
            "dcn_bytes_per_device": self.dcn_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "model_bytes_per_device": self.model_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "ideal_s": self.ideal_s,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(kind: str, n_active_params: float, tokens: float,
                extra_attn_flops: float = 0.0) -> float:
    """Global useful FLOPs: 6*N*D for a train step (fwd+bwd), 2*N*D for
    forward-only (prefill/decode), plus explicit attention term."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens + extra_attn_flops


def attention_flops(kind: str, cfg, seq_len: int, batch: int,
                    decode: bool = False) -> float:
    """Softmax-attention FLOPs (QK^T + PV), windowing-aware."""
    if cfg.num_heads == 0:
        return 0.0
    specs = [sl for st in cfg.stages for _ in range(st.repeats)
             for sl in st.block if sl.kind == "attn"]
    total = 0.0
    d = cfg.num_heads * cfg.head_dim
    for sl in specs:
        if decode:
            ctx_len = min(sl.window, seq_len) if sl.window else seq_len
            per_layer = 4.0 * batch * 1 * ctx_len * d
        else:
            if sl.window and sl.window < seq_len:
                per_layer = 4.0 * batch * seq_len * sl.window * d
            else:
                per_layer = 4.0 * batch * seq_len * seq_len * d / 2  # causal
        total += per_layer
    mult = 3.0 if kind == "train" else 1.0  # bwd ~ 2x fwd
    return total * mult


def _bound(nbytes: int, flops: int, dtype: torch.dtype):
    """(bound_ms, bound_by, bytes, flops): the larger of the bytes over
    the HBM rate and the flops over the dtype's tensor-core rate (bf16's;
    float32's split-TF32 rate)."""
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_SPLIT_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def attention_cost(shape, causal: bool, window: int, dtype: torch.dtype):
    """(bound_ms, bound_by, bytes, flops) of attention on inputs of
    `shape` = (B, Hq, Hkv, Tq, Tk, D): q, k, v read once and o written
    once over the HBM rate, against 4 D flops for every kept (query, key)
    pair of every (batch, head) (queries at the last Tq of Tk positions)
    over the dtype's peak rate on the tensor cores."""
    b, hq, hkv, tq, tk, d = shape
    qpos = np.arange(tq) + (tk - tq)
    hi = np.minimum(tk, qpos + 1) if causal else np.full(tq, tk)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(tq)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4 * d * pairs * b * hq
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * b * hq * tq * d + 2 * b * hkv * tk * d)
    return _bound(nbytes, flops, dtype)


def ssd_cost(shape, dtype: torch.dtype):
    """(bound_ms, bound_by, bytes, flops) of the SSD scan on inputs of
    `shape` = (B, T, H, P, N): x, a, b, c and h0 read once, y and hT
    written once, over the HBM rate; against the least work, the chunked
    (SSD) form with chunks of L = min(`SSD_COST_CHUNK`, T): per (batch,
    chunk) C B^T, 2 L^2 N flops shared by the heads; per (batch, chunk,
    head) scores X (2 L^2 P), C state^T (2 L P N) and the state update
    X^T (w B) (2 L P N); elementwise decay work not counted; over the
    dtype's peak rate on the tensor cores."""
    bsz, t, h, p, n = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * (2 * bsz * t * h * p + 2 * bsz * t * n)
              + 4 * bsz * t * h + 2 * 4 * bsz * h * p * n)
    lt = min(SSD_COST_CHUNK, t)
    chunks = -(-t // lt)
    flops = bsz * chunks * (2 * lt * lt * n
                            + h * (2 * lt * lt * p + 4 * lt * p * n))
    return _bound(nbytes, flops, dtype)
