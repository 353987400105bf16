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
    """Normalize a legacy (M,)/(B,) rack map to a (depth, ...) table."""
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

    With a leading cell axis (q, est (N,M,K), serving (N,M), task_locals
    (N,B,3); the table shared) each cell is routed as above and the
    outputs are (N,B).

    W_m is the left-to-right f32 tier sum of q/est plus 1/est at the
    in-service class; each task then argmins W_m / rate - rate * 1e-6
    (f32, no fused multiply-add) over its *private* servers — tier < K-1;
    the remote tier is masked to 3e38 because the fleet path fills the
    remote pool by water-filling.  Ties go to the lowest server index.
    Returns (server (B,) int32, tier (B,) int32, score (B,) f32).
    """
    if q.ndim == 3:
        cells = [fleet_route(*x, server_anc, locs)
                 for x, locs in zip(zip(q, serving, est_rates), task_locals)]
        return tuple(torch.stack(out) for out in zip(*cells))
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


def _tier_table(locs: torch.Tensor, anc: torch.Tensor, m: int):
    """(B, M) tier of every server for every task (local 0 .. remote
    D + 1), deepest level first with the local override."""
    d = anc.shape[0]
    sid = torch.arange(m, device=locs.device)
    tier = torch.full((locs.shape[0], m), d + 1, dtype=torch.int32,
                      device=locs.device)
    for lvl in range(d - 1, -1, -1):
        row = anc[lvl]
        share = (row[None, :, None] == row[locs][:, None, :]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
    local = (sid[None, :, None] == locs[:, None, :]).any(dim=-1)
    return torch.where(local, 0, tier)


def wwl_route(workload: torch.Tensor, est_rates: torch.Tensor,
              server_anc: torch.Tensor, task_locals: torch.Tensor):
    """Batched Balanced-PANDAS routing against a workload snapshot.

    workload:    (M,)   f32  estimated weighted workload per server
    est_rates:   (M,K)  f32  per-server estimated tier rates (K = D + 2)
    server_anc:  (D,M)  int  ancestor table (legacy (M,) rack map ok)
    task_locals: (B,3)  int  local servers per task

    Each task argmins W_m / est[m, tier(m, task)] (one IEEE division)
    over all M servers; ties go to the lowest server index.  Returns
    (server (B,) int32, tier (B,) int32 in 0..K-1, score (B,) f32).
    """
    anc = _as_anc(server_anc).long()
    est = est_rates.to(torch.float32)
    m = est.shape[0]
    locs = task_locals.long()
    tier = _tier_table(locs, anc, m)
    rate = torch.gather(est[None].expand(locs.shape[0], m, est.shape[1]),
                        -1, tier.long()[..., None])[..., 0]
    score = workload.to(torch.float32)[None, :] / rate       # (B, M)
    server = torch.argmin(score, dim=1)                 # first minimum wins
    rows = torch.arange(locs.shape[0], device=locs.device)
    return server.to(torch.int32), tier[rows, server], score[rows, server]


def maxweight_claim(queues: torch.Tensor, queue_anc: torch.Tensor,
                    idle_servers: torch.Tensor, idle_anc: torch.Tensor,
                    est_rates: torch.Tensor):
    """Batched JSQ-MaxWeight claim scoring against a queue snapshot.

    queues:       (N,)   f32/int queue lengths
    queue_anc:    (D,N)  int     ancestor table of each queue's owner
    idle_servers: (B,)   int     ids of the idle servers
    idle_anc:     (D,B)  int     ancestor table of each idle server
    est_rates:    (B,K)  f32     estimated tier rates per idle server

    Each idle server b argmaxes est[b, pair_tier(b, n)] * Q_n over the N
    queues (one product), empty queues masked to -inf; ties go to the
    lowest queue index.  A row whose queues are all empty gives queue 0
    and score -inf.  Returns (queue (B,) int32, score (B,) f32).
    """
    q_anc, i_anc = _as_anc(queue_anc).long(), _as_anc(idle_anc).long()
    d, n = q_anc.shape
    est = est_rates.to(torch.float32)
    qf = queues.to(torch.float32)
    qid = torch.arange(n, device=qf.device)
    is_self = idle_servers.long()[:, None] == qid[None, :]
    w = est[:, d + 1:d + 2].expand(is_self.shape)
    for lvl in range(d - 1, -1, -1):
        share = i_anc[lvl][:, None] == q_anc[lvl][None, :]
        w = torch.where(share, est[:, lvl + 1:lvl + 2], w)
    w = torch.where(is_self, est[:, 0:1], w)
    score = torch.where(qf[None, :] > 0, w * qf[None, :],
                        torch.full_like(w, float("-inf")))
    queue = torch.argmax(score, dim=1)                  # first maximum wins
    rows = torch.arange(score.shape[0], device=qf.device)
    return queue.to(torch.int32), score[rows, queue]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        scale: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA, sliding window and softcap.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0; query
    head h reads kv head h // (Hq / Hkv).  Query rows are offset by
    Tk - Tq (the last query sees the last key).  window > 0 keeps keys
    with kpos > qpos - window; softcap > 0 maps logits to
    softcap * tanh(logits / softcap); logits are (q . k) * scale in
    float32, and the output is in q's dtype.

    One departure from `repro.kernels.ref.mha`: a row whose keys are all
    masked gives 0, as the Pallas kernel (and the CUDA kernel) do, where
    the JAX oracle gives NaN.  Only Tq > Tk with causal makes such a row,
    and no caller does that.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, hkv, group, tq, d).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qr,
                          k.to(torch.float32)) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(mask, p, 0.0)          # all-masked rows: NaN -> 0
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, tq, d).to(q.dtype)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        init_state: torch.Tensor | None = None):
    """Mamba-2 SSD (state-space dual) recurrence, sequential form.

    x: (B, T, H, P) inputs per head (P = head dim); a: (B, T, H) per-step
    log-decay (decay exp(a) in (0, 1]); b, c: (B, T, N) input and output
    projections (N = state dim); init_state: (B, H, P, N) or None (zeros).

    h_t = exp(a_t) h_{t-1} + x_t (outer) b_t;  y_t = h_t c_t, with the
    state in float32.  Returns (y (B, T, H, P) in x's dtype, final state
    (B, H, P, N) float32).
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.to(torch.float32))
    dec = torch.exp(a.to(torch.float32))
    xf, bf, cf = (v.to(torch.float32) for v in (x, b, c))
    ys = []
    for i in range(t):
        state = (state * dec[:, i, :, None, None]
                 + xf[:, i, :, :, None] * bf[:, i, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, i]))
    return torch.stack(ys, 1).to(x.dtype), state
