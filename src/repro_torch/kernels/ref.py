"""Plain PyTorch versions of the port's kernels: the semantics contracts.

Each function here computes what its hand-written kernel computes, with
the same float32 rounding, as a dense tensor program.  `ops` sends a CPU
tensor here; `chip_smoke.py` holds each kernel against its plain version
on the card.  Counterpart of `repro.kernels.ref`.
"""

from __future__ import annotations

import torch

LARGE = 3.0e38  # +inf surrogate of the masked (remote) tier


def _as_anc(x: torch.Tensor) -> torch.Tensor:
    """Normalize a legacy (M,) rack map to a (depth, M) table."""
    return x[None] if x.ndim == 1 else x


def fleet_route(q: torch.Tensor, serving: torch.Tensor,
                est_rates: torch.Tensor, server_anc: torch.Tensor,
                task_locals: torch.Tensor):
    """Fused fleet slot-step private routing (workload + masked argmin).

    q:           (M,K)  int/f32 waiting tasks per (server, tier)
    serving:     (M,)   int     class in service (0 idle, 1..K)
    est_rates:   (M,K)  f32     per-server estimated tier rates
    server_anc:  (D,M)  int     ancestor table (legacy (M,) rack map ok)
    task_locals: (B,3)  int     local servers per task

    W_m is the left-to-right f32 tier sum of q/est plus 1/est at the
    in-service class; each task then argmins W_m / rate - rate * 1e-6
    (f32, no fused multiply-add) over its *private* servers — tier < K-1;
    the remote tier is masked to 3e38 because the fleet path fills the
    remote pool by water-filling.  Ties go to the lowest server index.
    Returns (server (B,) int32, tier (B,) int32, score (B,) f32).
    """
    anc = _as_anc(server_anc).long()
    d, m = anc.shape
    est = est_rates.to(torch.float32)
    qf = q.to(torch.float32)
    k = qf.shape[1]
    w = qf[:, 0] / est[:, 0]
    for t in range(1, k):
        w = w + qf[:, t] / est[:, t]
    idx = torch.clamp(serving.long() - 1, 0, k - 1)
    resid = torch.gather(est, 1, idx[:, None])[:, 0]
    w = w + torch.where(serving > 0, 1.0 / resid, torch.zeros_like(resid))

    locs = task_locals.long()
    sid = torch.arange(m, device=q.device)
    local = (sid[None, :, None] == locs[:, None, :]).any(dim=-1)   # (B, M)
    tier = torch.full(local.shape, d + 1, dtype=torch.int32, device=q.device)
    rate = est[None, :, d + 1].expand(local.shape)
    for lvl in range(d - 1, -1, -1):
        row = anc[lvl]
        groups = row[locs]                                         # (B, 3)
        share = (row[None, :, None] == groups[:, None, :]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
        rate = torch.where(share, est[None, :, lvl + 1], rate)
    tier = torch.where(local, 0, tier)
    rate = torch.where(local, est[None, :, 0], rate)
    score = w[None, :] / rate - rate * 1e-6
    score = torch.where(tier <= d, score, torch.full_like(score, LARGE))
    server = torch.argmin(score, dim=1)                 # first minimum wins
    rows = torch.arange(locs.shape[0], device=q.device)
    return (server.to(torch.int32), tier[rows, server],
            score[rows, server])
