"""Hopper kernel: batched JSQ-MaxWeight claim scoring (weighted argmax).

Port of the Pallas TPU kernel `repro/kernels/maxweight.py` (see
``csrc/maxweight.cu`` for the design and its bound).  Each of B idle
servers scans all N queues for ``argmax_n est[b, pair_tier(b, n)] * Q_n``
with empty queues masked; ties go to the lowest queue index, and a row
of empty queues gives queue 0 and score -inf.

A call is two launches.  The first finds the two largest queues of
distinct top-level groups (and any queue close enough below either that
its product may round onto theirs); the second gives each idle server
half a warp over its own top-level group and compares the best there
with the first of those two outside it.  That needs every row of the
queue table non-decreasing with nested groups
(`slot_step.check_anc_ranges`) and ``idle_anc = queue_anc[:, idle]``;
the first launch checks both on the card, and where they fail the second
runs the all-pairs loop, so any input gives the plain version's answer.
`last_path` says which path the last call took.

Semantics contract: `ref.maxweight_claim`.  `maxweight_claim_cuda` takes
CUDA tensors only and raises on anything else; `ops.maxweight_claim` is
the dispatching entry point.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

MAX_DEPTH = 4  # template instantiations in csrc/maxweight.cu
SCRATCH_INTS = 256  # csrc/maxweight.cu `Remote`: at most 1 KiB

_fn = None
_last_scratch = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("maxweight").maxweight_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def maxweight_claim_cuda(queues: torch.Tensor, queue_anc: torch.Tensor,
                         idle: torch.Tensor, idle_anc: torch.Tensor,
                         est: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream.

    queues (N,) float32, queue_anc (D, N) int32, idle (B,) int32,
    idle_anc (D, B) int32, est (B, K) float32 with K = D + 2, all
    contiguous on one card.  Returns (queue (B,) int32, score (B,)
    float32).
    """
    n = queues.shape[0]
    depth = queue_anc.shape[0]
    b, k = est.shape
    if k != depth + 2 or not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"maxweight_claim_cuda: need K = depth + 2 with "
                         f"depth in 0..{MAX_DEPTH}, got K={k}, "
                         f"depth={depth}")
    if n < 1 or b < 1:
        raise ValueError(f"maxweight_claim_cuda: need N, B >= 1, got {n}, "
                         f"{b}")
    dev = queues.device
    for name, x, dtype, shape in (("queues", queues, torch.float32, (n,)),
                                  ("queue_anc", queue_anc, torch.int32,
                                   (depth, n)),
                                  ("idle", idle, torch.int32, (b,)),
                                  ("idle_anc", idle_anc, torch.int32,
                                   (depth, b)),
                                  ("est", est, torch.float32, (b, k))):
        _build.check_arg("maxweight_claim_cuda", name, x, dtype, shape, dev)
    queue = torch.empty((b,), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    scratch = torch.empty((SCRATCH_INTS,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(queues.data_ptr(), queue_anc.data_ptr(), idle.data_ptr(),
                 idle_anc.data_ptr(), est.data_ptr(), n, depth, b,
                 queue.data_ptr(), score.data_ptr(), scratch.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"maxweight kernel launch failed: cudaError {err}")
    global _last_scratch
    _last_scratch = scratch
    LAUNCHES["maxweight_claim"] += 1
    return queue, score


def last_path() -> str:
    """"group" if the last call scanned each idle server's own top-level
    group (the tables met the precondition), "all-pairs" if it tested
    every (idle server, queue) pair.  Reads the card: keep it out of timed
    regions."""
    if _last_scratch is None:
        raise RuntimeError("maxweight_claim_cuda has not been called")
    return "group" if int(_last_scratch[0]) else "all-pairs"
