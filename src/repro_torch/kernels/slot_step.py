"""Hopper kernel: fused fleet slot-step routing (workload + private argmin).

Port of the Pallas TPU kernel `repro/kernels/slot_step.py` (see
``csrc/fleet_route.cu`` for the design and its bound).  The fleet backend
(`sharding/sim.py`) splits Balanced-PANDAS routing of a B-task arrival
batch into a *private* phase (each task scores the servers at a tier
better than remote) and a shared *pool* phase (the remote tier is
water-filled outside this kernel).  The kernel fuses the private phase
with the workload it consumes:

    W_m     = sum_k q[m, k] / est[m, k]  (+ in-service residual)
    score   = W_m / est[m, tier(m, task)] - est[...] * 1e-6
    out_b   = argmin over servers with tier(m, task) < K-1

The kernel scans only each task's private set: one warp a task finds
its locals' top-level groups in the ancestor table and strides over
their union (at most 18 servers at the fleet cell), instead of testing
all B x M pairs.  That needs every row of the table non-decreasing with
nested groups (`check_anc_ranges`); `sharding.sim.make_ctx` checks its
table once on the host, and `ref.fleet_route` takes any table.

A study's cells route in one launch: with a leading cell axis on q,
serving, est and locs (the table shared), the kernel's blockIdx.y is the
cell, the counterpart of `fleet_sweep`'s vmap over `pl.pallas_call`.

Semantics contract: `ref.fleet_route`.  `fleet_route_cuda` takes CUDA
tensors only and raises on anything else; `ops.fleet_route` is the
dispatching entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES

MAX_DEPTH = 4  # template instantiations in csrc/fleet_route.cu
MAX_CELLS = 65535  # gridDim.y

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fleet_route").fleet_route_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_anc_ranges(anc) -> None:
    """Raise unless the (depth, M) ancestor table meets the kernel's
    precondition: every row non-decreasing, so each group is one
    contiguous range of server ids, and every group inside one group of
    each coarser level (no coarser row changes where a finer one does
    not)."""
    anc = np.asarray(anc)
    if anc.ndim != 2 or anc.shape[0] == 0:
        return
    step = np.diff(anc.astype(np.int64), axis=1)
    if (step < 0).any():
        lvl, pos = np.argwhere(step < 0)[0]
        raise ValueError(f"fleet_route: ancestor row {lvl} decreases at "
                         f"server {pos + 1}; the kernel needs every group "
                         f"to be one contiguous, ascending range of ids")
    changes = step != 0
    for lvl in range(1, anc.shape[0]):
        if (changes[lvl] & ~changes[lvl - 1]).any():
            raise ValueError(f"fleet_route: a level-{lvl - 1} group of the "
                             f"ancestor table straddles two level-{lvl} "
                             f"groups; the kernel needs nested groups")


def fleet_route_cuda(q: torch.Tensor, serving: torch.Tensor,
                     est: torch.Tensor, anc: torch.Tensor,
                     locs: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream.

    q (M, K) int32, serving (M,) int32, est (M, K) float32, anc (D, M)
    int32 with K = D + 2, locs (B, 3) int32, all contiguous on one card.
    Returns (server (B,) int32, tier (B,) int32, score (B,) float32).
    With a leading cell axis (q, est (N, M, K), serving (N, M), locs (N,
    B, 3); anc shared) the N cells route in one launch and the outputs
    are (N, B).

    Precondition (not checked here, on the card): `anc` passes
    `check_anc_ranges`, as every `Topology.ancestors` table does.  The
    kernel finds a task's private set from the top row alone, so a table
    that breaks it gives wrong routes, not an error.
    """
    lead = tuple(q.shape[:-2])
    m, k = q.shape[-2:]
    n = int(np.prod(lead))
    depth = anc.shape[0]
    b = locs.shape[-2]
    if len(lead) > 1 or not 1 <= n <= MAX_CELLS:
        raise ValueError(f"fleet_route_cuda: need at most one cell axis of "
                         f"1..{MAX_CELLS} cells, got q of shape "
                         f"{tuple(q.shape)}")
    if k != depth + 2 or not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"fleet_route_cuda: need K = depth + 2 with depth "
                         f"in 0..{MAX_DEPTH}, got K={k}, depth={depth}")
    if m < 1 or b < 1:
        raise ValueError(f"fleet_route_cuda: need M, B >= 1, got {m}, {b}")
    dev = q.device
    for name, x, dtype, shape in (("q", q, torch.int32, lead + (m, k)),
                                  ("serving", serving, torch.int32,
                                   lead + (m,)),
                                  ("est", est, torch.float32, lead + (m, k)),
                                  ("anc", anc, torch.int32, (depth, m)),
                                  ("locs", locs, torch.int32, lead + (b, 3))):
        _build.check_arg("fleet_route_cuda", name, x, dtype, shape, dev)
    server = torch.empty(lead + (b,), dtype=torch.int32, device=dev)
    tier = torch.empty(lead + (b,), dtype=torch.int32, device=dev)
    score = torch.empty(lead + (b,), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), serving.data_ptr(), est.data_ptr(),
                 anc.data_ptr(), locs.data_ptr(), m, depth, b, n,
                 server.data_ptr(), tier.data_ptr(), score.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"fleet_route kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["fleet_route"] += 1
    return server, tier, score
