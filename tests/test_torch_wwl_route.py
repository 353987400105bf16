"""The port's `wwl_route` (plain version and, on the card, the CUDA
kernel) against the JAX reference.

The reference side runs as its own tests run it on the CPU: the oracle
`repro.kernels.ref.wwl_route` and the Pallas kernel through
`repro.kernels.ops.wwl_route` in interpret mode.  Indices are exact;
scores are bitwise against the oracle (both round one f32 division) and
within rtol 1e-6 against the Pallas path, as the reference's own test
(tests/test_kernels_sched.py) holds it.

The CUDA kernel runs in two passes (csrc/wwl_route.cu): the four best
remote-tier scores of distinct top-level groups, then one warp a task
over its locals' top-level groups, or the all-pairs loop where the table
is not sorted and nested.  `_two_pass` is a plain model of that
decomposition, held here bit for bit against both oracles on tables of
every depth, ragged and permuted, ties, repeated locals, all-infinite
rows and -0.0 workloads.  The `cuda`-marked tests need only the port:
`PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_wwl_route.py` runs them on a machine with the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import locality as loc
from repro_torch.kernels import ops, ref, slot_step, wwl_route as wwl

try:  # the JAX reference, which the CPU tests compare against
    import jax.numpy as jnp

    from repro.kernels import ops as rops, ref as rref
    from _torch_port import single_torch_thread  # noqa: F401
except ModuleNotFoundError:  # the port alone: only the cuda tests run
    jnp = rops = rref = None

RATES = {2: (0.5, 0.25), 3: (0.5, 0.45, 0.25), 4: (0.5, 0.45, 0.35, 0.25)}

# (M, B, ancestor table): the reference test's legacy rack maps, then
# depth 0 (K = 2) and depth 2 (K = 4) tables
CASES = (
    (64, 8, np.arange(64) // 8),
    (300, 50, np.arange(300) // 25),
    (1024, 256, np.arange(1024) // 32),
    (4096, 512, np.arange(4096) // 64),
    (300, 50, np.zeros((0, 300), np.int32)),
    (1024, 256, np.array(loc.Topology(1024, (32, 256)).ancestors)),
)
IDS = ["64x8", "300x50", "1024x256", "4096x512", "k2", "k4"]


def _permuted(m, groups, seed=0):
    """A `Topology` table with its columns shuffled: not sorted, so the
    kernel takes its all-pairs path."""
    anc = np.array(loc.Topology(m, groups).ancestors)
    return anc[:, np.random.default_rng(seed).permutation(m)]


# (M, B, table) of the two-pass model and of the card: Topology tables at
# depths 0, 1, 2, ragged group sizes at depths 1 and 2, and permuted ones
TABLES = (
    (48, 20, np.array(loc.Topology(48).ancestors)),
    (48, 20, np.array(loc.Topology(48, 6).ancestors)),
    (72, 20, np.array(loc.Topology(72, (3, 12)).ancestors)),
    (30, 20, np.array(loc.Topology(30, ((4, 8, 6, 12),)).ancestors)),
    (30, 20, np.array(loc.Topology(30, ((4, 8, 6, 12), (12, 18))).ancestors)),
    (48, 20, _permuted(48, 6)),
    (72, 20, _permuted(72, (3, 12))),
)
TABLE_IDS = ["depth0", "depth1", "depth2", "ragged1", "ragged2",
             "permuted1", "permuted2"]
KINDS = ["uniform", "ties", "repeated_locals", "all_inf", "neg_zero"]


def _inputs(rng, m, b, anc, ties=False):
    anc = np.asarray(anc, np.int32)
    k = (anc.shape[0] if anc.ndim == 2 else 1) + 2
    wl = (rng.integers(0, 4, m) if ties else rng.uniform(0, 50, m))
    er = np.tile(RATES[k], (m, 1)) * rng.uniform(0.8, 1.2, (m, k))
    if ties:  # shared rates: equal workloads give exactly equal scores
        er = np.tile(RATES[k], (m, 1))
    tl = np.sort(np.stack([rng.choice(m, 3, replace=False)
                           for _ in range(b)]), axis=1)
    return (wl.astype(np.float32), er.astype(np.float32), anc,
            tl.astype(np.int32))


def _kind_inputs(rng, m, b, anc, kind):
    """Inputs of one kind: `ties` (integer workloads, shared rates),
    `repeated_locals` (drawn with replacement, as the bench path draws
    them), `all_inf` (every score +inf), `neg_zero` (-0.0 and +0.0
    workloads, which tie)."""
    wl, er, anc, tl = _inputs(rng, m, b, anc, ties=kind != "uniform")
    if kind == "repeated_locals":
        tl = np.sort(rng.integers(0, m, (b, 3)), axis=1).astype(np.int32)
    elif kind == "all_inf":
        wl[:] = np.inf
    elif kind == "neg_zero":
        wl = np.where(rng.random(m) < 0.5, -0.0, 0.0).astype(np.float32)
        wl[rng.random(m) < 0.2] = 1.0
    return wl, er, anc, tl


def _port(wl, er, anc, tl, device="cpu"):
    return ops.wwl_route(*(torch.as_tensor(x, device=device)
                           for x in (wl, er, anc, tl)))


def _ranges_ok(anc):
    """The kernels' device check: the table passes `check_anc_ranges`
    (every row non-decreasing, the groups nested)."""
    try:
        slot_step.check_anc_ranges(anc)
    except ValueError:
        return False
    return True


def _min_keys(score):
    """The kernel's ascending 64-bit keys of (score, index): float order
    with -0.0 folded onto +0.0, NaN after every number."""
    s = np.where(score == 0, np.float32(0), score).astype(np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    u = np.where(np.isnan(score), np.uint64(0xFFFFFFFF), u)
    return (u << np.uint64(32)) | np.arange(score.size, dtype=np.uint64)


def _lexmin(score, idx):
    """(score, index) lexicographic minimum, NaN never winning; None when
    every score is NaN."""
    ok = ~np.isnan(score)
    if not ok.any():
        return None
    s = score[ok].min()
    i = int(idx[ok & (score == s)].min())
    return score[np.flatnonzero(idx == i)[0]], i


def _two_pass(wl, er, anc, tl):
    """Plain model of the CUDA kernel.  Pass 1: every server's remote
    score W / est[:, D+1] once, the four best (score, server) keys of
    distinct top-level groups (servers at depth 0), and the device's
    sorted-and-nested check.  Pass 2, when that holds: per task, its
    locals' top-level group ranges (`searchsorted` on the sorted top row;
    the locals themselves at depth 0), repeated groups once, each server's
    tier deepest level first with the local override, the lexicographic
    (score, server) minimum from (+inf, INT_MAX, tier 0), then the first
    of pass 1's four outside the task's groups, its score recomputed from
    its index.  When the check fails: the all-pairs loop, which is the
    plain version.  Returns ((server, tier, score), path)."""
    anc = np.asarray(anc, np.int32)
    anc = anc[None] if anc.ndim == 1 else anc
    d, m = anc.shape
    if not _ranges_ok(anc):
        out = ref.wwl_route(*(torch.as_tensor(x) for x in (wl, er, anc, tl)))
        return out, "all-pairs"
    top = anc[d - 1] if d else np.arange(m, dtype=np.int32)
    remote = wl / er[:, d + 1]
    order = np.argsort(_min_keys(remote), kind="stable")
    _, first = np.unique(top[order], return_index=True)
    four = order[np.sort(first)][:4]                 # distinct groups

    servers, tiers, scores = [], [], []
    for loc3 in tl.tolist():
        groups = sorted(set(top[loc3].tolist()))
        if d == 0:
            cand = np.array(loc3)
        else:
            lo = np.searchsorted(top, groups, side="left")
            hi = np.searchsorted(top, groups, side="right")
            cand = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
        tier = np.full(cand.size, d, np.int32)
        for lvl in range(d - 2, -1, -1):
            tier[np.isin(anc[lvl][cand], anc[lvl][loc3])] = lvl + 1
        tier[np.isin(cand, loc3)] = 0
        best = (np.float32(np.inf), 2 ** 31 - 1, 0)
        got = _lexmin(wl[cand] / er[cand, tier], cand)
        if got is not None:
            best = (got[0], got[1], int(tier[np.flatnonzero(cand
                                                            == got[1])[0]]))
        outside = [int(r) for r in four if top[r] not in groups]
        if outside:
            r = outside[0]
            s = wl[r] / er[r, d + 1]
            if s < best[0] or (s == best[0] and r < best[1]):
                best = (s, r, d + 1)
        servers.append(best[1])
        tiers.append(best[2])
        scores.append(best[0])
    return ((torch.tensor(servers, dtype=torch.int32),
             torch.tensor(tiers, dtype=torch.int32),
             torch.from_numpy(np.array(scores, np.float32))), "group")


def _assert_same(got, want):
    s, t, v = (np.asarray(x) for x in got)
    rs, rt, rv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(t, rt)
    assert v.dtype == rv.dtype == np.float32
    np.testing.assert_array_equal(v.view(np.int32), rv.view(np.int32))


@pytest.mark.parametrize("m,b,anc", CASES, ids=IDS)
@pytest.mark.parametrize("ties", [False, True], ids=["uniform", "ties"])
def test_plain_wwl_route_matches_reference(m, b, anc, ties):
    rng = np.random.default_rng(m + b)
    wl, er, anc, tl = _inputs(rng, m, b, anc, ties)
    s, t, v = (x.numpy() for x in _port(wl, er, anc, tl))
    rs, rt, rv = (np.asarray(x) for x in rref.wwl_route(
        jnp.asarray(wl), jnp.asarray(er), jnp.asarray(anc), jnp.asarray(tl)))
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(t, rt)
    assert v.dtype == rv.dtype == np.float32
    np.testing.assert_array_equal(v.view(np.int32), rv.view(np.int32))
    ks, kt, kv = (np.asarray(x) for x in rops.wwl_route(wl, er, anc, tl))
    np.testing.assert_array_equal(s, ks)
    np.testing.assert_array_equal(t, kt)
    np.testing.assert_allclose(v, kv, rtol=1e-6)


@pytest.mark.parametrize("m,b,anc", TABLES + CASES, ids=TABLE_IDS + IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_two_pass_model_matches_reference(m, b, anc, kind):
    """The kernel's decomposition, in plain code, equals the plain version
    and the JAX oracle bit for bit, and takes the group-restricted path
    exactly on the sorted, nested tables."""
    rng = np.random.default_rng(m * 3 + b + KINDS.index(kind))
    wl, er, anc, tl = _kind_inputs(rng, m, b, anc, kind)
    got, path = _two_pass(wl, er, anc, tl)
    table = anc[None] if anc.ndim == 1 else anc
    # every table here is nested; the permuted ones are not sorted
    sorted_rows = bool((np.diff(table, axis=1) >= 0).all())
    assert path == ("group" if sorted_rows else "all-pairs")
    _assert_same(got, _port(wl, er, anc, tl))
    _assert_same(got, rref.wwl_route(*(jnp.asarray(x)
                                       for x in (wl, er, anc, tl))))


def test_two_pass_model_remote_winner_of_a_fifth_group():
    """Five racks; the four best remote scores lie in racks 0-3, and a
    remote rate above the private ones makes every remote score beat
    every private one: each task's winner is the best of the four outside
    its own racks, whichever of the four that is."""
    m = 40
    anc = np.array(loc.Topology(m, 8).ancestors)            # five racks
    wl = np.full(m, 9.0, np.float32)
    wl[[3, 11, 19, 27]] = [1.0, 2.0, 3.0, 4.0]              # racks 0-3
    er = np.tile(np.float32((0.5, 0.45, 5.0)), (m, 1))
    tl = np.array([[0, 8, 16], [8, 16, 24], [0, 16, 24], [32, 33, 34]],
                  np.int32)
    got, path = _two_pass(wl, er, anc, tl)
    assert path == "group"
    np.testing.assert_array_equal(np.asarray(got[0]), [27, 3, 11, 3])
    _assert_same(got, _port(wl, er, anc, tl))
    _assert_same(got, rref.wwl_route(*(jnp.asarray(x)
                                       for x in (wl, er, anc, tl))))


def test_idle_local_wins():
    """Semantics spot-check of the reference's test: an idle local server
    must win."""
    m = 256
    wl = np.full(m, 10.0, np.float32)
    wl[7] = 0.0
    er = np.tile(np.float32(RATES[3]), (m, 1))
    s, t, _ = _port(wl, er, np.arange(m) // 16,
                    np.array([[7, 20, 40]], np.int32))
    assert int(s[0]) == 7 and int(t[0]) == 0


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    wl, er, anc, tl = _inputs(rng, 64, 8, np.arange(64) // 8)
    before = dict(ops.LAUNCHES)
    out = _port(wl, er, anc, tl)
    assert ops.LAUNCHES == before  # no kernel launched for CPU tensors
    plain = ref.wwl_route(*(torch.as_tensor(x) for x in (wl, er, anc[None],
                                                         tl)))
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wwl.wwl_route_cuda(*(torch.as_tensor(x) for x in (wl, er, anc[None],
                                                          tl)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,anc", CASES + TABLES, ids=IDS + TABLE_IDS)
def test_cuda_kernel_matches_plain_version(m, b, anc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(4)
    table = np.asarray(anc)
    table = table[None] if table.ndim == 1 else table
    want_path = "group" if _ranges_ok(table) else "all-pairs"
    for kind in KINDS:
        args = [torch.as_tensor(x, device="cuda")
                for x in _kind_inputs(rng, m, b, anc, kind)]
        before = ops.LAUNCHES["wwl_route"]
        out = ops.wwl_route(*args)
        assert ops.LAUNCHES["wwl_route"] == before + 1
        assert wwl.last_path() == want_path
        plain = ref.wwl_route(*args)
        for a, p in zip(out, plain):
            assert torch.equal(a.view(torch.int32), p.view(torch.int32))
