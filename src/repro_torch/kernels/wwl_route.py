"""Hopper kernel: batched Balanced-PANDAS routing (weighted-workload
argmin).

Port of the Pallas TPU kernel `repro/kernels/wwl_route.py` (see
``csrc/wwl_route.cu`` for the design and its bound).  For each of B
arriving tasks, find ``argmin_m W_m / est[m, tier(m, task)]`` over all M
servers, the tier coming from the task's three locals and the
``(depth, M)`` ancestor table; ties go to the lowest server index.

A call is two launches.  The first computes every server's remote-tier
score once and keeps the four best of distinct top-level groups; the
second gives each task half a warp over the union of its locals'
top-level groups and compares the best there with the first of those four
outside them.  That needs every row of the table non-decreasing with
nested groups (`slot_step.check_anc_ranges`); the first launch checks it
on the card, and where it fails the second runs the all-pairs loop, so
any table gives the plain version's answer.  `last_path` says which path
the last call took.

Semantics contract: `ref.wwl_route`.  `wwl_route_cuda` takes CUDA
tensors only and raises on anything else; `ops.wwl_route` is the
dispatching entry point.

Left out: the reference's ``wwl_route_pallas`` (its Pallas call) is
`wwl_route_cuda` here, and its ``NEG_LARGE`` sentinel lives in the CUDA
source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

MAX_DEPTH = 4  # template instantiations in csrc/wwl_route.cu
SCRATCH_INTS = 16  # csrc/wwl_route.cu `Remote`: 64 bytes

_fn = None
_last_scratch = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("wwl_route").wwl_route_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wwl_route_cuda(workload: torch.Tensor, est: torch.Tensor,
                   anc: torch.Tensor, locs: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream.

    workload (M,) float32, est (M, K) float32, anc (D, M) int32 with
    K = D + 2, locs (B, 3) int32, all contiguous on one card.  Returns
    (server (B,) int32, tier (B,) int32, score (B,) float32).
    """
    m, k = est.shape
    depth = anc.shape[0]
    b = locs.shape[0]
    if k != depth + 2 or not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"wwl_route_cuda: need K = depth + 2 with depth in "
                         f"0..{MAX_DEPTH}, got K={k}, depth={depth}")
    if m < 1 or b < 1:
        raise ValueError(f"wwl_route_cuda: need M, B >= 1, got {m}, {b}")
    dev = est.device
    for name, x, dtype, shape in (("workload", workload, torch.float32, (m,)),
                                  ("est", est, torch.float32, (m, k)),
                                  ("anc", anc, torch.int32, (depth, m)),
                                  ("locs", locs, torch.int32, (b, 3))):
        _build.check_arg("wwl_route_cuda", name, x, dtype, shape, dev)
    server = torch.empty((b,), dtype=torch.int32, device=dev)
    tier = torch.empty((b,), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    scratch = torch.empty((SCRATCH_INTS,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(workload.data_ptr(), est.data_ptr(), anc.data_ptr(),
                 locs.data_ptr(), m, depth, b, server.data_ptr(),
                 tier.data_ptr(), score.data_ptr(), scratch.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"wwl_route kernel launch failed: cudaError {err}")
    global _last_scratch
    _last_scratch = scratch
    LAUNCHES["wwl_route"] += 1
    return server, tier, score


def last_path() -> str:
    """"group" if the last call scanned each task's top-level groups (the
    table met the precondition), "all-pairs" if it tested every (task,
    server) pair.  Reads the card: keep it out of timed regions."""
    if _last_scratch is None:
        raise RuntimeError("wwl_route_cuda has not been called")
    return "group" if int(_last_scratch[0]) else "all-pairs"
