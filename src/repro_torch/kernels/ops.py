"""Public entry points of the port's kernels (counterpart of
`repro.kernels.ops`).

A CPU tensor goes to the kernel's plain PyTorch version (`ref`); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback
from the card to the plain version.  `flash_attention` and `ssd` have a
third branch: a ``meta`` tensor goes through the card's preparation to
the kernel wrapper, which returns ``meta`` outputs of the kernel's
shapes, dtypes and strides and reports one launch, with the kernel's
cost (`utils.roofline.attention_cost`, `ssd_cost`), to an active
`utils.hlo.OpCounter`, as a card launch does; it runs nothing, plain
or kernel (the dry run's count of a prefill).  `LAUNCHES` counts kernel
launches on the card, one key per kernel.  `reference` is the
reference's alias of `ref`.  Depth 0 (K = 2) runs natively in every
scheduling kernel: no padding and no dilated ancestor table.
`flash_attention` needs no padding either: the kernel masks its ragged
tiles itself, and neither does `ssd`: its kernels stop at T (the
chunked ones read zeros past T).  The float32 tensor-core kernels of
both take the models' strided views as they are, so such a call on the
card is one launch and no copy.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref, ssd_scan
from repro_torch.kernels._build import LAUNCHES  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.maxweight import maxweight_claim_cuda
from repro_torch.kernels.slot_step import fleet_route_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda
from repro_torch.kernels.wwl_route import wwl_route_cuda
from repro_torch.telemetry import count, counting

reference = ref  # the reference's name for the plain versions


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def wwl_route(workload: torch.Tensor, est_rates: torch.Tensor,
              server_anc: torch.Tensor, task_locals: torch.Tensor):
    """Batched Balanced-PANDAS routing.  See `ref.wwl_route`.

    `server_anc` is the (depth, M) ancestor table (a legacy (M,) rack map
    is accepted).  Returns (server (B,) int32, tier (B,) int32, score (B,)
    float32).  On the card a call is two launches: each task scans its
    locals' top-level groups when the table is sorted and nested (checked
    on the card), every server otherwise; any table gives the plain
    version's answer."""
    anc = ref._as_anc(server_anc)
    if not workload.is_cuda:
        return ref.wwl_route(workload, est_rates, anc, task_locals)
    return wwl_route_cuda(_f32(workload), _f32(est_rates), _i32(anc),
                          _i32(task_locals))


def fleet_route(q: torch.Tensor, serving: torch.Tensor, est: torch.Tensor,
                server_anc: torch.Tensor, task_locals: torch.Tensor):
    """Fused fleet slot-step private routing.  See `ref.fleet_route`.

    `server_anc` is the (depth, M) ancestor table (a legacy (M,) rack map
    is accepted).  Depth 0 (K = 2) runs natively: only the three locals
    are private, which is what the reference's dilated depth-1 table
    gives after its tier collapse.  On the card q and serving must be
    int32 (the simulator state's type) and est float32.  A leading cell
    axis on q, serving, est and task_locals routes N cells in one launch.
    A call adds its launch grid, the N x B task slots it scans, to the
    counter ``fleet_route.tasks_scanned`` (`repro_torch.telemetry.count`).
    """
    anc = ref._as_anc(server_anc)
    if counting():
        count("fleet_route.tasks_scanned",
              math.prod(q.shape[:-2]) * task_locals.shape[-2])
    if not q.is_cuda:
        return ref.fleet_route(q, serving, est, anc, task_locals)
    return fleet_route_cuda(q, serving, est, _i32(anc), _i32(task_locals))


def maxweight_claim(queues: torch.Tensor, queue_anc: torch.Tensor,
                    idle_servers: torch.Tensor, idle_anc: torch.Tensor,
                    est_rates: torch.Tensor):
    """Batched JSQ-MaxWeight claims.  See `ref.maxweight_claim`.

    Ancestor tables are (depth, N) / (depth, B) (legacy rack maps
    accepted).  Returns (queue (B,) int32, score (B,) float32); a row
    whose queues are all empty gives queue 0 and score -inf.  On the card
    a call is two launches: each idle server scans its own top-level
    group when the queue table is sorted and nested and `idle_anc` is its
    columns at `idle_servers` (checked on the card), every queue
    otherwise; any input gives the plain version's answer."""
    qa, ia = ref._as_anc(queue_anc), ref._as_anc(idle_anc)
    if not queues.is_cuda:
        return ref.maxweight_claim(queues, qa, idle_servers, ia, est_rates)
    return maxweight_claim_cuda(_f32(queues), _i32(qa), _i32(idle_servers),
                                _i32(ia), _f32(est_rates))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x itself when its rows are contiguous and 16-byte aligned (a float32
    tensor-core kernel takes the other strides), else a contiguous copy."""
    return x if _build.rows_aligned(x) else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """Block-wise online-softmax attention (GQA/SWA/softcap).

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D).  See `ref.mha` for the
    semantics.  The reference's `block_q`/`block_k`/`interpret` options
    have no counterpart: the CUDA kernels' tiling is fixed.  On the card
    bf16 inputs are made contiguous (the TMA maps); float32 ones go as
    they are, and the result is a view of (B, Tq, Hq, D) storage.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not (q.is_cuda or q.is_meta):
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale)
    return _attention_card(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def _attention_card(q, k, v, **opts):
    """The card's (and ``meta``'s) half of `flash_attention`: bf16 made
    contiguous, float32 passed as it is (`_rows`)."""
    prep = torch.Tensor.contiguous if q.dtype == torch.bfloat16 else _rows
    return flash_attention_cuda(prep(q), prep(k), prep(v), **opts)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        init_state: torch.Tensor | None = None, *, block_t: int = 128):
    """Mamba-2 SSD scan.  See `ref.ssd` for the semantics.

    x: (B, T, H, P); a: (B, T, H) log-decay <= 0; b, c: (B, T, N) in x's
    dtype; init_state: (B, H, P, N) or None (zeros).  Returns (y in x's
    dtype, final state float32).  `block_t` is the reference's chunk
    length (the Pallas kernel's `L`), which neither version here takes:
    on the card the chunked form runs with its own fixed chunk of
    `ssd_scan.TC_CHUNK` = 64 steps on the tensor cores, and shapes it
    does not take run the recurrent form step by step (`ssd_scan.route`
    says which); the plain version is the sequential recurrence.  The
    results agree within tolerance whatever the split
    (tests/test_torch_ssd.py).  The float32 tensor-core kernel takes x, b
    and c as they are and a missing initial state as none, not as zeros;
    the others take them contiguous (the bf16 chunked kernel's TMA
    maps).
    """
    del block_t  # each kernel chunks by its own fixed length: see above
    if not (x.is_cuda or x.is_meta):
        return ref.ssd(x, a, b, c, init_state)
    return _ssd_card(x, a, b, c, init_state)


def _ssd_card(x, a, b, c, init_state):
    """The card's (and ``meta``'s) half of `ssd`: inputs of the float32
    tensor-core kernel passed as they are (`_rows`), the other kernels'
    made contiguous, a missing initial state as None."""
    strided = (ssd_scan.route(x.dtype, x.shape[-1], b.shape[-1])
               == ssd_scan.TENSOR_CORES_F32)
    prep = _rows if strided else torch.Tensor.contiguous
    h0 = None if init_state is None else _f32(init_state)
    return ssd_cuda(prep(x), _f32(a), prep(b), prep(c), h0)
