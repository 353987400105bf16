"""Hopper kernel: block-wise online-softmax attention (GQA, causal,
sliding window, softcap).

Port of the Pallas TPU kernel `repro/kernels/flash_attention.py` (see
``csrc/flash_attention.cu`` for the designs and their bounds).  q is
(B, Hq, Tq, D), k and v are (B, Hkv, Tk, D); query rows are offset by
Tk - Tq; float32 accumulators, output in q's dtype.  Three kernels,
picked by `route` from the dtype and the head dim:

* bf16 on the tensor cores (`wgmma`, K/V through a TMA ring);
* float32 as split TF32 on the tensor cores (D 8, 16, 32, 64, 128): each
  float32 operand enters `wgmma` as TF32 hi + lo and each product as
  three (hi hi + hi lo + lo hi, about 21 bits against one TF32
  product's 11), with float32 sums; a producer warpgroup copies the
  tiles from the caller's strides, transposes V and splits them;
* float32 at D = 256 on the CUDA cores: the split Q tile alone would
  fill a block's shared memory.

The float32 kernels take q, k, v at any strides with contiguous, 16-byte
aligned rows (the attention layer's (B, H, T, D) views of (B, T, H, D)
storage) and write o at the strides the wrapper allocates: (B, Tq, Hq,
D) storage, which the layer's reshape to (B, Tq, Hq D) reads without a
copy.  bf16 takes contiguous tensors (its TMA maps).

Semantics contract: `ref.mha`.  `flash_attention_cuda` takes CUDA
tensors, and ``meta`` tensors, for which it allocates the output it
would write and launches nothing; it raises on anything else.  Each
launch, and each ``meta`` call, reports one launch with
`utils.roofline.attention_cost`'s flops and bytes to an active
`utils.hlo.OpCounter`.  `ops.flash_attention` is the dispatching entry
point.

Left out: the reference's ``flash_attention`` (its Pallas call) is
`flash_attention_cuda` here, and its ``NEG_INF`` mask value lives in
the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES
from repro_torch.utils import hlo
from repro_torch.utils.roofline import attention_cost

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # template instantiations in the .cu
TF32_HEAD_DIMS = (8, 16, 32, 64, 128)   # float32 head dims on the tensor cores
# route codes of flash_attention_launch
F32_CUDA_CORES, BF16_TENSOR_CORES, F32_TENSOR_CORES = 0, 1, 2

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(dtype: torch.dtype, d: int) -> int:
    """The kernel a call takes: bf16 the tensor-core kernel; float32 the
    split-TF32 tensor-core kernel at D 8, 16, 32, 64 and 128 (every head
    dim of the port's configs but gemma's 256: granite-moe-1b's smoke
    config has 16, mixtral-8x22b's 8), the CUDA-core kernel at D = 256,
    whose split Q tile (128 rows x 256 x 2 x 4 bytes) would fill a
    block's shared memory.  The dtype and the shape decide, never an
    error."""
    if dtype == torch.bfloat16:
        return BF16_TENSOR_CORES
    if dtype != torch.float32:
        raise TypeError(f"flash_attention_cuda: dtype {dtype} not in "
                        f"(torch.float32, torch.bfloat16)")
    return F32_TENSOR_CORES if d in TF32_HEAD_DIMS else F32_CUDA_CORES


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


def tf32_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (64, 8) @ b (32, 8)^T as one `wgmma` .tf32 product of the raw
    float32 values (contiguous float32 on the card): what the tensor
    cores make of a float32 operand that is not a TF32 value."""
    for name, x, shape in (("a", a, (64, 8)), ("b", b, (32, 8))):
        _build.check_arg("tf32_probe", name, x, torch.float32, shape)
    fn = _build.load("flash_attention").tf32_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    out = torch.empty((64, 32), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32_probe launch failed: cudaError {err}")
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         scale: float) -> torch.Tensor:
    """Launch the CUDA kernel of `route(q.dtype, D)` on PyTorch's current
    stream.

    q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), float32 or bfloat16 alike,
    on one card, with Hq a multiple of Hkv and D one of `HEAD_DIMS`.
    bf16 needs contiguous, 16-byte aligned tensors (its TMA copies);
    float32 takes any strides with contiguous, 16-byte aligned rows
    (`_build.rows_aligned`).  Returns (B, Hq, Tq, D) in q's dtype:
    contiguous for bf16, a (B, Hq, Tq, D) view of (B, Tq, Hq, D) storage
    for float32.
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
    return _launch(q, k, v, route(q.dtype, d), causal=causal, window=window,
                   softcap=softcap, scale=scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, code: int,
            *, causal: bool, window: int, softcap: float,
            scale: float) -> torch.Tensor:
    """Launch the kernel of route code `code` on checked shapes: the
    wrapper's, or, for holding every instantiation against the plain
    version, another kernel than `route` names (the CUDA-core kernel
    below D = 256).  q, k and v must be bf16 for code 1, float32 else;
    the C side refuses a head dim its kernel lacks."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    bf16 = code == BF16_TENSOR_CORES
    dtype = torch.bfloat16 if bf16 else torch.float32
    dev = q.device
    for name, x, shape in (("q", q, (b, hq, tq, d)), ("k", k, (b, hkv, tk, d)),
                           ("v", v, (b, hkv, tk, d))):
        _build.check_arg("flash_attention_cuda", name, x, dtype, shape,
                         dev, strided=not bf16, meta=True)
        if bf16 and x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be 16-byte "
                             f"aligned")
    out = (torch.empty_like(q) if bf16 else
           torch.empty((b, tq, hq, d), dtype=q.dtype,
                       device=dev).transpose(1, 2))
    cost = ("flash_attention", attention_cost, (b, hq, hkv, tq, tk, d),
            causal, window, q.dtype)
    if dev.type == "meta":   # shapes only: counted, nothing launched
        hlo.record_kernel(*cost)
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, hq, hkv, tq, tk, d, code, float(scale),
                 int(bool(causal)), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    hlo.record_kernel(*cost)
    return out
