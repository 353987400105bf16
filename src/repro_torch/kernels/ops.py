"""Public entry points of the port's kernels (counterpart of
`repro.kernels.ops`).

A CPU tensor goes to the kernel's plain PyTorch version (`ref`); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback
from the card to the plain version.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.slot_step import LAUNCHES, fleet_route_cuda  # noqa: F401


def fleet_route(q: torch.Tensor, serving: torch.Tensor, est: torch.Tensor,
                server_anc: torch.Tensor, task_locals: torch.Tensor):
    """Fused fleet slot-step private routing.  See `ref.fleet_route`.

    `server_anc` is the (depth, M) ancestor table (a legacy (M,) rack map
    is accepted).  Depth 0 (K = 2) runs natively: only the three locals
    are private, which is what the reference's dilated depth-1 table
    gives after its tier collapse.  On the card q and serving must be
    int32 (the simulator state's type) and est float32.
    """
    anc = ref._as_anc(server_anc)
    if not q.is_cuda:
        return ref.fleet_route(q, serving, est, anc, task_locals)
    return fleet_route_cuda(q, serving, est, anc.to(torch.int32).contiguous(),
                            task_locals.to(torch.int32).contiguous())
