"""Hopper kernel: the Mamba-2 SSD (state-space duality) scan with an
initial and a final state.

Port of the Pallas TPU kernel `repro/kernels/ssd_scan.py` (see
``csrc/ssd_scan.cu`` for the design and its bound).  x is (B, T, H, P),
a the (B, T, H) float32 log-decay, b and c (B, T, N) in x's dtype, h0
the (B, H, P, N) float32 initial state; returns y (B, T, H, P) in x's
dtype and the final state (B, H, P, N) float32.

Two kernels (`route`): bf16 runs the chunked SSD form on the tensor
cores (`wgmma`, chunks of `TC_CHUNK` steps through a TMA ring), which
feeds the masked scores, the decayed b and a copy of the state to the
tensor cores each as a pair of bf16 (hi + lo), beside float32 sums and
a float32 state; float32 runs the recurrent form on the CUDA cores,
step by step in float32.

Semantics contract: `ref.ssd`.  `ssd_cuda` takes CUDA tensors only and
raises on anything else; `ops.ssd` is the dispatching entry point.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

D_STATES = (4, 8, 16, 32, 64, 128)   # template instantiations in the .cu
TC_CHUNK = 64   # steps a chunk of the tensor-core kernel
# route codes of ssd_scan_launch
RECURRENT_F32, RECURRENT_BF16, TENSOR_CORES = 0, 1, 2

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(dtype: torch.dtype, p: int, n: int) -> int:
    """The kernel a call takes: bf16 goes to the tensor cores when P is a
    multiple of 8 up to 64 (one warpgroup's 64 state rows) and N a
    multiple of 8 (the TMA copies need rows of a multiple of 16 bytes),
    which every Mamba-2 width the port serves meets (mamba2-1.3b: P 64,
    N 128); other bf16 shapes and all float32 take the recurrent
    kernel.  The dtype and the shape decide, never an error."""
    if dtype == torch.float32:
        return RECURRENT_F32
    if dtype != torch.bfloat16:
        raise TypeError(f"ssd_cuda: dtype {dtype} not in (torch.float32, "
                        f"torch.bfloat16)")
    if p % 8 == 0 and p <= 64 and n % 8 == 0:
        return TENSOR_CORES
    return RECURRENT_BF16


def ssd_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream.

    x (B, T, H, P), b and c (B, T, N), all contiguous, float32 or
    bfloat16 alike; a (B, T, H) and h0 (B, H, P, N) contiguous float32;
    all on one card, with N one of `D_STATES`.  Returns (y, hT).  The
    kernel is `route(x.dtype, P, N)`'s; on the tensor cores x, b and c
    must be 16-byte aligned (TMA), as fresh allocations are.
    """
    if x.ndim != 4 or b.ndim != 3:
        raise ValueError(f"ssd_cuda: x must be 4-d and b 3-d, got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if n not in D_STATES:
        raise ValueError(f"ssd_cuda: state dim {n} not in {D_STATES}")
    if min(bsz, t, h, p) < 1:
        raise ValueError(f"ssd_cuda: empty input {tuple(x.shape)}")
    kernel = route(x.dtype, p, n)
    dev = x.device
    for name, arg, dtype, shape in (
            ("x", x, x.dtype, (bsz, t, h, p)),
            ("a", a, torch.float32, (bsz, t, h)),
            ("b", b, x.dtype, (bsz, t, n)), ("c", c, x.dtype, (bsz, t, n)),
            ("h0", h0, torch.float32, (bsz, h, p, n))):
        _build.check_arg("ssd_cuda", name, arg, dtype, shape, dev)
        if kernel == TENSOR_CORES and dtype == x.dtype and arg.data_ptr() % 16:
            raise ValueError(f"ssd_cuda: {name} must be 16-byte aligned")
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 h0.data_ptr(), y.data_ptr(), h_final.data_ptr(), bsz, t, h,
                 p, n, kernel, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    LAUNCHES["ssd"] += 1
    return y, h_final
