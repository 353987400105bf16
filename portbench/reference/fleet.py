"""Plain reference of the fleet robustness study: the yardstick that
decides `correct`.

Written from the model's semantics in plain PyTorch and NumPy, with no
kernel and nothing imported from the program: the cluster's ancestor
table, the hot-rack fluid capacity, the loads, the estimate grid, the
per-cell draws, and each slot's arrivals, Balanced-PANDAS or
power-of-d routing, service and idle-server scheduling, then the
Little's-law delay, throughput and final backlog of every cell.

Every operation that can round is the one the model states, in its
order, on the device the study ran on, so a sound run of the program
agrees with this one exactly (bit for bit), and `compare` counts the
cells that do not.  The private argmin scores each server at the
estimated rate of its own tier for the task, as a dense argmin over
every (task, private server) pair with ties to the lowest index would,
by groups rather than pairs.  Reductions that could round in another order
(the water level's capacity sum) only decide a comparison against at
most B tasks, which they decide the same way in any order.

``dtype`` is the float type of the scheduler's arithmetic (workloads,
scores, water levels).  float32 is the model's; bfloat16 is the control
that has to come out unequal.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# scores are W / rate - rate * TIE; the faster tier wins an exact tie
TIE = 1e-6


# ---------------------------------------------------------------------------
# Study inputs: cluster, capacity, loads, estimates
# ---------------------------------------------------------------------------


def ancestors(num_servers: int, group_sizes: Sequence[int]) -> np.ndarray:
    """(depth, M) int64 group id of each server at each level, finest
    first, for uniform group sizes."""
    rows = []
    for size in group_sizes:
        if num_servers % size:
            raise ValueError(f"group size {size} does not tile "
                             f"{num_servers} servers")
        rows.append(np.arange(num_servers) // size)
    return np.asarray(rows, np.int64).reshape(len(group_sizes), num_servers)


def hot_rack_capacity(num_servers: int, group_sizes: Sequence[int],
                      rates: Sequence[float], p_hot: float) -> float:
    """Fluid capacity (tasks a slot) when a share p_hot of tasks keep all
    three replicas in rack 0 and the rest are spread uniformly: fill the
    tier pools around rack 0 in order (rack 0 and its members at the
    local rate, then each coarser level's servers, then the remote
    ones) until the hot traffic that lands in a pool fits it."""
    r = np.asarray(rates, np.float64)
    m = num_servers
    if p_hot <= 0.0:
        return float(m * r[0])
    anc = ancestors(m, group_sizes)
    k = len(group_sizes) + 2
    tier = np.full(m, k - 1)
    # rack 0 and each coarser group holding it, deepest level first
    for lvl in range(len(group_sizes) - 1, -1, -1):
        tier[anc[lvl] == anc[lvl][0]] = lvl + 1
    pools = [(float(r[0]), int(np.sum(tier <= 1)))]
    pools += [(float(r[t]), int(np.sum(tier == t))) for t in range(2, k)
              if np.sum(tier == t) > 0]
    used_n = used_c = 0.0
    for rate, n in pools:
        lam = (m - used_n + used_c / rate) / (p_hot / rate
                                              + (1.0 - p_hot) / r[0])
        hot = p_hot * lam - used_c
        if -1e-9 <= hot <= n * rate + 1e-9:
            return float(lam)
        used_n += n
        used_c += n * rate
    raise ValueError("no consistent fluid regime")


def estimate_grid(num_servers: int, rates: Sequence[float],
                  eps_grid: Sequence[float], signs: Sequence[int]):
    """(E, M, K) float32 estimated rates: first the exact rates, then for
    each sign and eps each server's rates times iid multipliers
    1 + sign * U[0, eps), drawn from a generator seeded 0, clipped to
    [1e-3, 1]."""
    true_k = np.asarray(rates, np.float32)
    m, k = num_servers, true_k.size
    ests = [np.clip(true_k[None, :] * np.ones((m, k), np.float32), 1e-3, 1.0)]
    for sign in signs:
        for eps in eps_grid:
            u = np.random.default_rng(0).uniform(0.0, eps, size=(m, k)
                                                 ).astype(np.float32)
            ests.append(np.clip(true_k[None, :] * (1.0 + sign * u),
                                1e-3, 1.0))
    return np.stack(ests)


# ---------------------------------------------------------------------------
# Draws: one generator a seed, one block a seed a slot
# ---------------------------------------------------------------------------


class LgammaTable:
    """log k! for k < batch, computed once and shared by every cell's
    Poisson law."""

    def __init__(self, batch: int):
        self.batch = batch
        self.log_fact = np.array([math.lgamma(i + 1.0)
                                  for i in range(batch)])

    def cdf(self, lam: float) -> np.ndarray:
        """(batch,) float64 P(count <= k) of Poisson(lam), k < batch."""
        if lam <= 0.0:
            return np.ones(self.batch)
        k = np.arange(self.batch)
        logpmf = k * math.log(lam) - lam - self.log_fact
        return np.minimum(np.cumsum(np.exp(logpmf)), 1.0)


class Draws:
    """Each slot, every distinct seed's generator (seeded with the seed,
    on the device) draws one block of uniforms [count (1) | hot (B) |
    replica offsets (3B) | service (M) | candidates (dB)], which the
    cells of that seed share; a cell's count is the inverse of its
    Poisson CDF at the block's first uniform."""

    def __init__(self, cells: Sequence[Tuple[int, float]], batch: int,
                 num_servers: int, cand: int, device):
        self.dev = torch.device(device)
        seeds = sorted({s for s, _ in cells})
        self.gens = []
        for s in seeds:
            g = torch.Generator(device=self.dev)
            g.manual_seed(s)
            self.gens.append(g)
        self.index = torch.tensor([seeds.index(s) for s, _ in cells],
                                  device=self.dev)
        table = LgammaTable(batch)
        self.cdf = torch.tensor(np.stack([table.cdf(float(lam))
                                          for _, lam in cells]),
                                device=self.dev)
        self.b, self.m, self.cand = batch, num_servers, cand
        self.size = 1 + 4 * batch + num_servers + batch * cand

    def slot(self):
        b, m = self.b, self.m
        blk = torch.stack([torch.rand((self.size,), generator=g,
                                      device=self.dev)
                           for g in self.gens])[self.index]
        n = (self.cdf <= blk[:, :1].double()).sum(dim=1)
        u_hot = blk[:, 1:1 + b]
        r = blk[:, 1 + b:1 + 4 * b].reshape(-1, b, 3)
        u_serve = blk[:, 1 + 4 * b:1 + 4 * b + m]
        u_cand = (blk[:, 1 + 4 * b + m:].reshape(-1, b, self.cand)
                  if self.cand else None)
        return n, u_hot, r, u_serve, u_cand


# ---------------------------------------------------------------------------
# One slot
# ---------------------------------------------------------------------------


def arrivals(n, u_hot, r, p_hot, hot_size: int, m: int, batch: int):
    """(types (N, B, 3) int64 ascending, active (N, B)): task b is live
    when b < n; a hot task's three distinct replicas lie in rack 0, a
    cold one's anywhere, each chosen by the uniform-offset rule."""
    active = torch.arange(batch, device=n.device) < n[:, None]
    size = torch.where(u_hot < p_hot, hot_size, m).to(torch.float32)
    x0 = torch.minimum(torch.floor(r[..., 0] * size), size - 1)
    x1 = torch.minimum(torch.floor(r[..., 1] * (size - 1)), size - 2)
    x1 = x1 + (x1 >= x0)
    lo, hi = torch.minimum(x0, x1), torch.maximum(x0, x1)
    x2 = torch.minimum(torch.floor(r[..., 2] * (size - 2)), size - 3)
    x2 = x2 + (x2 >= lo)
    x2 = x2 + (x2 >= hi)
    types = torch.stack([x0, x1, x2], dim=-1).to(torch.int32)
    return torch.sort(types, dim=-1).values.long(), active


def workload(q, serving, est):
    """(N, M) W_m: the tier sum of q / est left to right, plus 1 / est at
    the class in service."""
    parts = q / est
    w = parts[..., 0]
    for t in range(1, q.shape[-1]):
        w = w + parts[..., t]
    k = est.shape[-1]
    idx = torch.clamp(serving.long() - 1, 0, k - 1)
    rate = torch.gather(est, -1, idx[..., None])[..., 0]
    return w + torch.where(serving > 0, 1.0 / rate, torch.zeros_like(rate))


def add_at(q, flat_server, tier, inc):
    """q with inc added at (flat server, tier)."""
    flat = (flat_server * q.shape[-1] + tier).reshape(-1)
    return q.reshape(-1).index_add(0, flat, inc.to(q.dtype).reshape(-1)
                                   ).reshape(q.shape)


def private_argmin(w, est, anc, sizes, locs):
    """Each task's best server at a tier better than remote: (server,
    tier, score) minimising (score, server), where a server's score is
    W / rate - rate * TIE at the estimated rate of its own tier for the
    task (0 for a local; l + 1 for a server that shares a level-l group,
    and no finer one, with a local).  Tier by tier: the locals; then at
    each level the children (servers at level 0, level l - 1 groups
    above) of the locals' level-l groups that hold no local, each child
    represented by its lowest (score, server) at the level's rate.
    `sizes` are the (uniform) group sizes of the (depth, M) table `anc`.
    """
    nc, m = w.shape
    dev = w.device
    cell = torch.arange(nc, device=dev)[:, None, None]
    flat = locs.reshape(nc, -1)
    w_l = torch.gather(w, 1, flat).reshape(locs.shape)
    e_l = torch.gather(est[..., 0], 1, flat).reshape(locs.shape)
    sc = w_l / e_l - e_l * TIE
    best_v = torch.amin(sc, dim=-1)
    best_i = torch.amin(torch.where(sc == best_v[..., None], locs, m), dim=-1)
    best_t = torch.zeros_like(best_i)
    child, held = 1, locs        # level -1: the servers, the locals
    for lvl, size in enumerate(sizes):
        rate = est[..., lvl + 1]
        score = w / rate - rate * TIE                        # (N, M)
        if child == 1:
            cmin = score
            cidx = torch.arange(m, device=dev).expand(nc, m)
        else:
            nchild = m // child
            gid = anc[lvl - 1] + cell[:, 0] * nchild        # (N, M)
            cmin = torch.full((nc * nchild,), float("inf"),
                              dtype=score.dtype, device=dev).scatter_reduce(
                0, gid.reshape(-1), score.reshape(-1), "amin")
            at_min = score == cmin[gid]
            sid = torch.arange(m, device=dev).expand(nc, m)
            cidx = torch.full((nc * nchild,), m, dtype=torch.int64,
                              device=dev).scatter_reduce(
                0, gid.reshape(-1), torch.where(at_min, sid, m).reshape(-1),
                "amin")
            cmin, cidx = cmin.reshape(nc, -1), cidx.reshape(nc, -1)
        ratio = size // child
        kids = (anc[lvl][locs][..., None] * ratio
                + torch.arange(ratio, device=dev))           # (N, B, 3, r)
        out = (kids[..., None] == held[:, :, None, None, :]).any(dim=-1)
        kids = kids.reshape(nc, -1)
        cv = torch.gather(cmin, 1, kids).reshape(out.shape)
        ci = torch.gather(cidx, 1, kids).reshape(out.shape)
        cv = torch.where(out, float("inf"), cv).flatten(-2)
        ci = ci.flatten(-2)
        v = torch.amin(cv, dim=-1)
        i = torch.amin(torch.where(cv == v[..., None], ci, m), dim=-1)
        better = (v < best_v) | ((v == best_v) & (i < best_i))
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, i, best_i)
        best_t = torch.where(better, lvl + 1, best_t)
        child, held = size, anc[lvl][locs]
    return best_i, best_t, best_v


def water_level(p, d, demand, hi0, batch: int, iters: int):
    """Per cell, by bisection, the smallest level y at which the pool's
    servers (server m takes ceil((y - p_m) / d_m) tasks, clipped to [0,
    B]) hold demand(y) tasks; returns the upper ends."""
    lo = torch.amin(p, dim=-1, keepdim=True)
    hi = (torch.maximum(torch.amax(p, dim=-1, keepdim=True), hi0)
          + batch * torch.amax(d, dim=-1, keepdim=True))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cap = torch.clamp(torch.ceil((mid - p) / d), 0.0, float(batch)
                          ).sum(dim=-1, keepdim=True)
        ok = cap >= demand(mid)
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi


def route_pandas(q, serving, est, anc, sizes, locs, active, rounds: int,
                 iters: int):
    """Balanced-PANDAS for one slot's batch: `rounds` passes in which
    each pending task takes its private argmin while its score, raised
    by 1/rate^2 for each earlier claimant of that server, stays under the
    remote pool's water level (losers retry against the updated
    workloads), then the rest fill the remote pool up to the re-raised
    level, in server order."""
    nc, m, k = q.shape
    batch = locs.shape[1]
    dev = q.device
    cell_m = torch.arange(nc, device=dev)[:, None] * m
    ar = torch.arange(nc * batch, device=dev)
    est2 = est.reshape(nc * m, k)
    pending = active
    for r in range(rounds):
        w = workload(q, serving, est)
        best_i, best_t, best_v = private_argmin(w, est, anc, sizes, locs)
        pr = est[..., k - 1]
        p = w / pr - pr * TIE
        d = 1.0 / (pr * pr)
        s_priv = torch.where(pending, best_v, -3e38)

        def demand(y, pending=pending, best_v=best_v):
            return (pending & (best_v > y)).to(torch.float32
                                               ).sum(dim=-1, keepdim=True)

        hi0 = torch.amax(s_priv, dim=-1, keepdim=True)
        y1 = water_level(p, d, demand, hi0, batch, iters)
        go = pending & (best_v <= y1)
        flat_i = best_i + cell_m
        key = torch.where(go, flat_i, nc * m).reshape(-1)
        order = torch.argsort(key, stable=True)
        sk = key[order]
        first = torch.searchsorted(sk, sk, side="left")
        rank = torch.empty_like(ar).index_put_((order,), ar - first
                                               ).reshape(nc, batch)
        e_at = est2[flat_i, best_t]
        stay = go & (best_v + rank.to(torch.int32) / (e_at * e_at) <= y1)
        if r < rounds - 1:
            q = add_at(q, flat_i, best_t, stay)
            pending = pending & ~stay
    pool = pending & ~stay
    n_pool = pool.to(torch.float32).sum(dim=-1, keepdim=True)
    y2 = water_level(p, d, lambda y: n_pool, hi0, batch, iters)
    caps = torch.clamp(torch.ceil((y2 - p) / d), 0.0, float(batch)
                       ).to(torch.int64)
    cum = torch.cumsum(caps, dim=-1)
    pool_rank = torch.cumsum(pool.to(torch.int64), dim=-1) - 1
    pool_srv = torch.clamp(torch.searchsorted(cum, pool_rank, side="right"),
                           0, m - 1)
    srv = torch.where(stay, flat_i, pool_srv + cell_m)
    tier = torch.where(stay, best_t, k - 1)
    return add_at(q, srv, tier, pending)


def route_po2(q, serving, est, anc, locs, active, u_cand):
    """Power-of-d for one slot's batch, against one workload snapshot:
    each task takes the first best of its three locals and its d
    uniform candidates floor(u * M), each at its tier for the task."""
    nc, m, k = q.shape
    w = workload(q, serving, est)
    cand = torch.clamp(torch.floor(u_cand * m), max=m - 1).long()
    cset = torch.cat([locs, cand], dim=-1)
    tier = torch.full(cset.shape, k - 1, dtype=torch.int64, device=q.device)
    for lvl in range(anc.shape[0] - 1, -1, -1):
        row = anc[lvl]
        share = (row[cset][..., None] == row[locs][..., None, :]).any(dim=-1)
        tier = torch.where(share, lvl + 1, tier)
    tier = torch.where((cset[..., None] == locs[..., None, :]).any(dim=-1),
                       0, tier)
    flat = cset + torch.arange(nc, device=q.device)[:, None, None] * m
    rate = est.reshape(nc * m, k)[flat, tier]
    score = w.reshape(-1)[flat] / rate - rate * TIE
    j = torch.argmin(score, dim=-1, keepdim=True)
    return add_at(q, torch.gather(flat, -1, j)[..., 0],
                  torch.gather(tier, -1, j)[..., 0], active)


def serve(q, serving, u_serve, true_k):
    """A server in service completes when its uniform is under the true
    rate of its class; then each idle server takes the head of its
    fastest nonempty tier queue.  Returns (q, serving, completions)."""
    k = q.shape[-1]
    idx = torch.clamp(serving.long() - 1, 0, k - 1)
    rate = torch.gather(true_k.expand(serving.shape + (k,)), -1,
                        idx[..., None])[..., 0]
    done = u_serve < torch.where(serving > 0, rate, torch.zeros_like(rate))
    serving = torch.where(done, torch.zeros_like(serving), serving)
    nonempty = q > 0
    first = torch.argmax(nonempty.to(torch.int32), dim=-1)
    take = (serving == 0) & nonempty.any(dim=-1)
    dec = take[..., None] & (torch.arange(k, device=q.device)
                             == first[..., None])
    return (q - dec.to(torch.int32),
            torch.where(take, (first + 1).to(torch.int32), serving),
            done.sum(dim=-1).to(torch.int32))


# ---------------------------------------------------------------------------
# A study
# ---------------------------------------------------------------------------


def run_cells(policy: str, d: int, num_servers: int, group_sizes, rates,
              p_hot: float, batch: int, horizon: int, warmup: int,
              rounds: int, fill_iters: int,
              cells: Sequence[Tuple[int, float]], est_cells: np.ndarray,
              device, dtype=torch.float32) -> Dict[str, np.ndarray]:
    """The cells [(seed, load)] with (N, M, K) estimates, side by side;
    (N,) mean delay, throughput and final backlog."""
    dev = torch.device(device)
    m, k = num_servers, len(rates)
    table = ancestors(m, group_sizes)
    anc = torch.as_tensor(table, device=dev)
    est = torch.as_tensor(est_cells, device=dev).to(dtype)
    true_k = torch.tensor(rates, dtype=torch.float32, device=dev)
    p_hot_t = torch.tensor(p_hot, dtype=torch.float32, device=dev)
    hot_size = group_sizes[0] if len(group_sizes) else m
    cand = d if policy == "pandas_po2" else 0
    draws = Draws(cells, batch, m, cand, dev)
    nc = len(cells)
    q = torch.zeros((nc, m, k), dtype=torch.int32, device=dev)
    serving = torch.zeros((nc, m), dtype=torch.int32, device=dev)
    mean_n = torch.zeros((nc,), dtype=torch.float32, device=dev)
    n_meas = torch.zeros((nc,), dtype=torch.float32, device=dev)
    compl = torch.zeros((nc,), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for t in range(horizon):
            n, u_hot, r, u_serve, u_cand = draws.slot()
            locs, active = arrivals(n, u_hot, r, p_hot_t, hot_size, m, batch)
            if policy == "pandas_po2":
                q = route_po2(q, serving, est, anc, locs, active, u_cand)
            elif policy == "balanced_pandas":
                q = route_pandas(q, serving, est, anc, group_sizes, locs,
                                 active, rounds, fill_iters)
            else:
                raise ValueError(f"no reference for policy {policy!r}")
            q, serving, done = serve(q, serving, u_serve, true_k)
            n_sys = (q.sum(dim=(-2, -1)) + (serving > 0).sum(dim=-1)
                     ).to(torch.float32)
            in_w = float(t >= warmup)
            n_meas = n_meas + in_w
            mean_n = mean_n + in_w * (n_sys - mean_n) / torch.clamp(
                n_meas, min=1.0)
            compl = compl + done * int(t >= warmup)
    q, serving = q.cpu().numpy(), serving.cpu().numpy()
    mean_n, n_meas = mean_n.cpu().numpy(), n_meas.cpu().numpy()
    compl = compl.cpu().numpy()
    lam = np.asarray([lam for _, lam in cells], np.float32)
    return {
        "delay": np.where(lam > 0, mean_n / lam, np.nan),
        "throughput": compl / np.maximum(n_meas, 1.0),
        "final_n": (q.sum(axis=(-2, -1))
                    + (serving > 0).sum(axis=-1)).astype(np.float32),
    }


def study_cells(cfg: dict, traffic: dict, seeds: Sequence[int]):
    """The study's grid in its flat order (load, estimate, seed):
    ([(seed, load)], (N, M, K) estimates, (L, E, S) shape)."""
    m, groups = cfg["num_servers"], cfg["group_sizes"]
    cap = hot_rack_capacity(m, groups, cfg["rates"], cfg["p_hot"])
    lam = np.asarray(traffic["loads"], np.float32) * cap
    ests = estimate_grid(m, cfg["rates"], traffic["eps_grid"],
                         traffic["signs"])
    shape = (len(lam), len(ests), len(seeds))
    cells, which = [], []
    for lv in lam:
        for e in range(len(ests)):
            for s in seeds:
                cells.append((int(s), lv))
                which.append(e)
    return cells, ests[which], shape


def study(cfg: dict, traffic: dict, seeds: Sequence[int], device,
          dtype=torch.float32) -> Dict[str, np.ndarray]:
    """The whole study: (L, E, S) delay, throughput and final backlog."""
    cells, est_cells, shape = study_cells(cfg, traffic, seeds)
    policy = traffic["policy"]
    d = int(traffic["d"]) if policy == "pandas_po2" else 0
    out = run_cells(policy, d,
                    cfg["num_servers"], cfg["group_sizes"], cfg["rates"],
                    cfg["p_hot"], cfg["max_arrivals"], traffic["horizon"],
                    traffic["warmup"], cfg["fleet"]["rounds"],
                    cfg["fleet"]["fill_iters"], cells, est_cells, device,
                    dtype)
    return {key: value.reshape(shape) for key, value in out.items()}


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Cells whose delay, throughput or final backlog differ from the
    reference's in any bit (NaN equal to NaN)."""
    off = None
    for key in ("delay", "throughput", "final_n"):
        a = np.asarray(got[key])
        b = np.asarray(want[key])
        if a.shape != b.shape:
            return int(b.size)
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        off = ~same if off is None else off | ~same
    return int(off.sum())
