"""Hopper kernel: block-wise online-softmax attention (GQA, causal,
sliding window, softcap).

Port of the Pallas TPU kernel `repro/kernels/flash_attention.py` (see
``csrc/flash_attention.cu`` for the design and its bound).  q is
(B, Hq, Tq, D), k and v are (B, Hkv, Tk, D); query rows are offset by
Tk - Tq; float32 accumulators, output in q's dtype.  bf16 runs on the
tensor cores (`wgmma`, K/V through a TMA ring), float32 on the CUDA
cores; the dtype alone picks the kernel.

Semantics contract: `ref.mha`.  `flash_attention_cuda` takes CUDA
tensors only and raises on anything else; `ops.flash_attention` is the
dispatching entry point.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

HEAD_DIMS = (8, 32, 64, 128, 256)   # template instantiations in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tensor_map_encode_us(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         reps: int = 1000) -> float:
    """Host microseconds to encode the bf16 kernel's three TMA tensor maps
    for one launch on these tensors (mean over `reps`; nothing runs on
    the card)."""
    fn = _build.load("flash_attention").flash_attention_encode_us
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    fn.restype = ctypes.c_double
    b, hq, tq, d = q.shape
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, hq, k.shape[1], tq,
            k.shape[2], d, reps)
    if us < 0:
        raise RuntimeError("flash_attention: tensor map encoding failed")
    return us


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), all contiguous, float32 or
    bfloat16 alike, on one card, with Hq a multiple of Hkv and D one of
    `HEAD_DIMS`.  bf16 goes to the tensor-core kernel (its TMA copies
    need 16-byte aligned tensors), float32 to the CUDA-core kernel.
    Returns (B, Hq, Tq, D) in q's dtype.
    """
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_attention_cuda: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: Hq={hq} is not a multiple "
                         f"of Hkv={hkv}")
    if min(b, hq, tq, tk) < 1:
        raise ValueError(f"flash_attention_cuda: empty input {tuple(q.shape)}"
                         f", {tuple(k.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not in "
                        f"{tuple(_DTYPES)}")
    dev = q.device
    for name, x, shape in (("q", q, (b, hq, tq, d)), ("k", k, (b, hkv, tk, d)),
                           ("v", v, (b, hkv, tk, d))):
        _build.check_arg("flash_attention_cuda", name, x, q.dtype, shape,
                         dev)
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, tq, tk, d, _DTYPES[q.dtype], float(scale),
                 int(bool(causal)), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
