"""Hopper kernel: the Mamba-2 SSD (state-space duality) scan with an
initial and a final state.

Port of the Pallas TPU kernel `repro/kernels/ssd_scan.py` (see
``csrc/ssd_scan.cu`` for the designs and their bounds).  x is
(B, T, H, P), a the (B, T, H) float32 log-decay, b and c (B, T, N) in
x's dtype, h0 the (B, H, P, N) float32 initial state or None (zeros);
returns y (B, T, H, P) in x's dtype and the final state (B, H, P, N)
float32.

Three kernels (`route`): the chunked SSD form on the tensor cores
(`wgmma`, chunks of `TC_CHUNK` steps, a state warpgroup and an output
warpgroup) in bf16, which feeds the masked scores, the decayed b and a
copy of the state each as a pair of bf16 (hi + lo), and in float32, where
every product is split TF32 (each float32 operand as TF32 hi + lo, three
products: about 21 bits against one TF32 product's 11) with float32 sums
and a float32 state; and the recurrent form on the CUDA cores, step by
step in float32, for the shapes the chunked kernels do not take.  The
float32 tensor-core kernel reads x, b and c at any strides with
contiguous, 16-byte aligned rows (`mamba_block` passes b and c as views
into the convolution's output) and takes a missing initial state as
none; the others take contiguous inputs (the bf16 tensor-core kernel's
TMA maps).

Semantics contract: `ref.ssd`.  `ssd_cuda` takes CUDA tensors, and
``meta`` tensors, for which it allocates the outputs it would write and
launches nothing; it raises on anything else.  Each launch, and each
``meta`` call, reports one launch with `utils.roofline.ssd_cost`'s flops
and bytes to an active `utils.hlo.OpCounter`.  `ops.ssd` is the
dispatching entry point.

Left out: the reference's ``ssd_chunked`` (its Pallas call) is
`ssd_cuda` here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES
from repro_torch.utils import hlo
from repro_torch.utils.roofline import ssd_cost

D_STATES = (4, 8, 16, 32, 64, 128)   # template instantiations in the .cu
TC_CHUNK = 64   # steps a chunk of the tensor-core kernels
# route codes of ssd_scan_launch
RECURRENT_F32, RECURRENT_BF16, TENSOR_CORES, TENSOR_CORES_F32 = 0, 1, 2, 3

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(dtype: torch.dtype, p: int, n: int) -> int:
    """The kernel a call takes: the chunked kernel on the tensor cores
    (bf16 `TENSOR_CORES`, float32 `TENSOR_CORES_F32`) when P is a
    multiple of 8 up to 64 (one warpgroup's 64 state rows) and N a
    multiple of 8 (a k8 step of the float32 products; 16-byte TMA rows in
    bf16), which every Mamba-2 width the port serves meets (mamba2-1.3b:
    P 64, N 128; its smoke config: P 8, N 16); the recurrent kernel for
    every other shape (N = 4, P over 64 or not a multiple of 8).  The
    dtype and the shape decide, never an error."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_cuda: dtype {dtype} not in (torch.float32, "
                        f"torch.bfloat16)")
    f32 = dtype == torch.float32
    if p % 8 == 0 and p <= 64 and n % 8 == 0:
        return TENSOR_CORES_F32 if f32 else TENSOR_CORES
    return RECURRENT_F32 if f32 else RECURRENT_BF16


def ssd_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None):
    """Launch the CUDA kernel of `route(x.dtype, P, N)` on PyTorch's
    current stream.

    x (B, T, H, P), b and c (B, T, N), float32 or bfloat16 alike; a
    (B, T, H) contiguous float32; h0 (B, H, P, N) contiguous float32 or
    None (zeros: the chunked kernels take none, the recurrent one is
    given a zero tensor); all on one card, with N one of `D_STATES`.  On
    the float32 tensor-core kernel x, b and c may have any strides with
    contiguous, 16-byte aligned rows (`_build.rows_aligned`); the others
    take them contiguous (and the bf16 tensor-core kernel 16-byte aligned,
    for TMA, as fresh allocations are).  Returns (y, hT), both
    contiguous.
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
    tma = kernel == TENSOR_CORES
    strided = kernel == TENSOR_CORES_F32
    dev = x.device
    args = [("x", x, x.dtype, (bsz, t, h, p)), ("a", a, torch.float32,
                                                 (bsz, t, h)),
            ("b", b, x.dtype, (bsz, t, n)), ("c", c, x.dtype, (bsz, t, n))]
    if h0 is not None:
        args.append(("h0", h0, torch.float32, (bsz, h, p, n)))
    for name, arg, dtype, shape in args:
        _build.check_arg("ssd_cuda", name, arg, dtype, shape, dev,
                         strided and name in ("x", "b", "c"), meta=True)
        if tma and dtype == x.dtype and arg.data_ptr() % 16:
            raise ValueError(f"ssd_cuda: {name} must be 16-byte aligned")
    if h0 is None and kernel in (RECURRENT_F32, RECURRENT_BF16):
        h0 = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=dev)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    cost = ("ssd", ssd_cost, (bsz, t, h, p, n), x.dtype)
    if dev.type == "meta":   # shapes only: counted, nothing launched
        hlo.record_kernel(*cost)
        return y, h_final
    st = (x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
          c.stride(0), c.stride(1))
    if max(st[1], st[4], st[6]) >= 2 ** 31:
        raise ValueError(f"ssd_cuda: a time stride of {st} is 2^31 elements "
                         f"or more")
    strides = (ctypes.c_longlong * 7)(*st)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_final.data_ptr(), strides, bsz, t, h, p, n, kernel,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    LAUNCHES["ssd"] += 1
    hlo.record_kernel(*cost)
    return y, h_final
