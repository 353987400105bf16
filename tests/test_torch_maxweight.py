"""The port's `maxweight_claim` (plain version and, on the card, the
CUDA kernel) against the JAX reference.

The reference side runs as its own tests run it on the CPU: the oracle
`repro.kernels.ref.maxweight_claim` and the Pallas kernel through
`repro.kernels.ops.maxweight_claim` in interpret mode.  Indices are
exact; scores are bitwise against the oracle (one f32 product) and
within rtol 1e-6 against the Pallas path.  For a row whose queues are
all empty the port follows the oracle (queue 0, score -inf); the Pallas
kernel returns its -3e38 sentinel there, so that row is held to the
``< -1e30`` rule of tests/test_kernels_sched.py.

The CUDA kernel runs in two passes (csrc/maxweight.cu): the two largest
queues of distinct top-level groups and the queues just below them, then
one warp an idle server over its own top-level group, or the all-pairs
loop where the tables break the precondition.  `_two_pass` is a plain
model of that decomposition, held here bit for bit against both oracles,
near-ties included: two queue lengths one float apart in different
groups whose products round equal, where the lower index must win with
the smaller queue.  The `cuda`-marked tests need only the port:
`PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_maxweight.py` runs them on a machine with the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import locality as loc
from repro_torch.kernels import maxweight as mw, ops, ref, slot_step

try:  # the JAX reference, which the CPU tests compare against
    import jax.numpy as jnp

    from repro.kernels import ops as rops, ref as rref
    from _torch_port import single_torch_thread  # noqa: F401
except ModuleNotFoundError:  # the port alone: only the cuda tests run
    jnp = rops = rref = None

RATES = {2: (0.5, 0.25), 3: (0.5, 0.45, 0.25), 4: (0.5, 0.45, 0.35, 0.25)}
FLT_MAX = np.finfo(np.float32).max
NEAR_CAP = 64              # csrc/maxweight.cu kNear
TINY = np.float32(2.0 ** -100)

# (N, B, queue ancestor table): the reference test's legacy rack maps,
# then depth 0 (K = 2) and depth 2 (K = 4)
CASES = (
    (64, 8, np.arange(64) // 8),
    (300, 37, np.arange(300) // 25),
    (2048, 200, np.arange(2048) // 64),
    (300, 37, np.zeros((0, 300), np.int32)),
    (2048, 200, np.array(loc.Topology(2048, (64, 512)).ancestors)),
)
IDS = ["64x8", "300x37", "2048x200", "k2", "k4"]

RAGGED_RACKS, RAGGED_PODS = (4, 8, 6, 12) * 5, (12, 18) * 5


def _permuted(n, groups, seed=0):
    """A `Topology` table with its columns shuffled: not sorted, so the
    kernel takes its all-pairs path."""
    anc = np.array(loc.Topology(n, groups).ancestors)
    return anc[:, np.random.default_rng(seed).permutation(n)]


# (N, B, table) of the two-pass model and of the card: Topology tables at
# depths 0, 1, 2, ragged group sizes at depths 1 and 2, and permuted ones
TABLES = (
    (96, 24, np.array(loc.Topology(96).ancestors)),
    (96, 24, np.array(loc.Topology(96, 6).ancestors)),
    (144, 24, np.array(loc.Topology(144, (3, 12)).ancestors)),
    (150, 24, np.array(loc.Topology(150, (RAGGED_RACKS,)).ancestors)),
    (150, 24, np.array(loc.Topology(150, (RAGGED_RACKS,
                                          RAGGED_PODS)).ancestors)),
    (96, 24, _permuted(96, 6)),
    (144, 24, _permuted(144, (3, 12))),
)
TABLE_IDS = ["depth0", "depth1", "depth2", "ragged1", "ragged2",
             "permuted1", "permuted2"]
KINDS = ["uniform", "ties", "sparse", "empty", "near_tie", "near_overflow",
         "zero_remote_rate", "tiny_remote_rate", "foreign_idle_anc"]


def _inputs(rng, n, b, qanc, empty_frac=0.0):
    qanc = np.asarray(qanc, np.int32)
    table = qanc if qanc.ndim == 2 else qanc[None]
    k = table.shape[0] + 2
    q = rng.integers(0, 5, n).astype(np.float32)
    q[rng.random(n) < empty_frac] = 0.0
    ids = rng.choice(n, b, replace=False).astype(np.int32)
    ianc = qanc[..., ids]
    er = (np.tile(RATES[k], (b, 1))
          * rng.uniform(0.8, 1.2, (b, k))).astype(np.float32)
    return q, qanc, ids, ianc, er


def near_tie(rng):
    """(x, y, w): y = nextafter(x, 0), and a rate w with fl(w x) == fl(w y),
    searched with numpy."""
    x = np.float32(3.0)
    y = np.nextafter(x, np.float32(0))
    while True:
        w = np.float32(rng.uniform(0.2, 0.3))
        if w * x == w * y:
            return x, y, w


def _kind_inputs(rng, n, b, qanc, kind):
    """Inputs of one kind: `ties` (shared rates), `sparse` (90% empty),
    `empty` (every queue empty), `near_tie` (one queue of length x and,
    at a lower index in another group, one of nextafter(x, 0), under a
    remote rate whose products of the two round equal: the lower index
    must win), `near_overflow` (more near-ties than the kernel lists),
    `zero_remote_rate` / `tiny_remote_rate` (remote products 0 or
    below 2^-100, where the shortcut does not hold), `foreign_idle_anc`
    (the idle table is not the queue table's columns)."""
    q, qanc, ids, ianc, er = _inputs(
        rng, n, b, qanc, {"sparse": 0.9, "empty": 1.0}.get(kind, 0.0))
    d = er.shape[1] - 2
    if kind == "ties":
        er = np.tile(np.float32(RATES[d + 2]), (b, 1))
    elif kind in ("near_tie", "near_overflow"):
        x, y, w = near_tie(rng)
        q = np.minimum(q, 1).astype(np.float32)
        if kind == "near_tie":
            q[1], q[n // 2] = y, x          # lower index, smaller queue
        else:
            q[rng.random(n) < 0.6] = y
            q[n - 1] = x
        er[:, d + 1] = w
    elif kind == "zero_remote_rate":
        er[:, d + 1] = 0.0
    elif kind == "tiny_remote_rate":
        # products below the kernel's 2^-100 but normal: JAX's CPU backend
        # flushes subnormal products to 0, the port and the card do not
        er[:, d + 1] = np.float32(1e-32)
    elif kind == "foreign_idle_anc":
        ianc = np.roll(ianc, 1, axis=-1)
    return q, qanc, ids, ianc, er


def _port(*args, device="cpu"):
    return ops.maxweight_claim(*(torch.as_tensor(x, device=device)
                                 for x in args))


def _ranges_ok(anc):
    """The kernels' device check: the table passes `check_anc_ranges`
    (every row non-decreasing, the groups nested)."""
    try:
        slot_step.check_anc_ranges(anc)
    except ValueError:
        return False
    return True


def _precondition(qanc, ids, ianc):
    n = qanc.shape[1]
    return (_ranges_ok(qanc) and bool(((ids >= 0) & (ids < n)).all())
            and bool((ianc == qanc[:, np.clip(ids, 0, n - 1)]).all()))


def _lexmax(best, score, idx):
    """Merge (score, index) pairs into `best`, lexicographic on (score,
    -index), NaN never winning."""
    ok = ~np.isnan(score)
    if not ok.any():
        return best
    s = score[ok].max()
    i = int(idx[ok & (score == s)].min())
    if s > best[0] or (s == best[0] and i < best[1]):
        return s, i
    return best


def _two_pass(q, qanc, ids, ianc, er):
    """Plain model of the CUDA kernel.  Pass 1: the two best (Q, queue)
    pairs of distinct top-level groups over Q > 0 (Q descending, then the
    index), the queues with Q in [fl(Q* (1 - 2^-21)), Q*) for either Q*,
    and the device's check (sorted, nested queue table; idle ids in range
    with `idle_anc` their columns).  Pass 2, when that holds, per idle
    server: with a rate that is not positive and finite, every queue
    scored as the all-pairs loop scores it; else its own top-level range
    (`searchsorted`; its own queue at depth 0) at its tiers, then the
    first pair outside its group scored with the remote rate w beside the
    listed near queues outside its group, or every remote queue when
    Q*, w Q* is not a normal float or the list overflowed; a best of -inf
    gives queue 0.  When the check fails: the all-pairs loop, which is
    the plain version.  Returns ((queue, score), path)."""
    qanc = np.asarray(qanc, np.int32)
    qanc = qanc[None] if qanc.ndim == 1 else qanc
    ianc = np.asarray(ianc, np.int32)
    ianc = ianc[None] if ianc.ndim == 1 else ianc
    d, n = qanc.shape
    if not _precondition(qanc, ids, ianc):
        out = ref.maxweight_claim(*(torch.as_tensor(x) for x in
                                    (q, qanc, ids, ianc, er)))
        return out, "all-pairs"
    top = qanc[d - 1] if d else np.arange(n, dtype=np.int32)
    cand = np.flatnonzero(q > 0)
    order = cand[np.lexsort((cand, -q[cand]))]
    _, first = np.unique(top[order], return_index=True)
    two = order[np.sort(first)][:2]
    c = np.float32(1 - 2.0 ** -21)
    near = [int(nn) for nn in cand
            if any(q[t] * c <= q[nn] < q[t] for t in two)]
    neg_inf = np.float32(-np.inf)
    queues, scores = [], []
    for row, qid in enumerate(ids.tolist()):
        e = er[row]
        best = (neg_inf, 2 ** 31 - 1)
        if not ((e > 0) & (e <= FLT_MAX)).all():
            tier = np.full(n, d + 1)
            for lvl in range(d - 1, -1, -1):
                tier[qanc[lvl] == ianc[lvl, row]] = lvl + 1
            tier[qid] = 0
            s = np.where(q > 0, e[tier] * q, neg_inf)
            best = _lexmax(best, s, np.arange(n))
            queues.append(best[1])
            scores.append(best[0])
            continue
        own = top[qid]
        lo, hi = ((np.searchsorted(top, own, "left"),
                   np.searchsorted(top, own, "right")) if d
                  else (qid, qid + 1))
        rng_ = np.arange(lo, hi)
        tier = np.full(rng_.size, d)
        for lvl in range(d - 2, -1, -1):
            tier[qanc[lvl][rng_] == ianc[lvl, row]] = lvl + 1
        tier[rng_ == qid] = 0
        best = _lexmax(best, np.where(q[rng_] > 0, e[tier] * q[rng_],
                                      neg_inf), rng_)
        outside = [int(t) for t in two if top[t] != own]
        if outside:
            r, w = outside[0], e[d + 1]
            top_s = w * q[r]
            if (q[r] >= TINY and TINY <= top_s <= FLT_MAX
                    and len(near) <= NEAR_CAP):
                cands = np.array([r] + [nn for nn in near if top[nn] != own])
            else:
                cands = np.array([nn for nn in cand if not lo <= nn < hi])
            best = _lexmax(best, w * q[cands], cands)
        if best[0] == neg_inf:
            best = (neg_inf, 0)
        queues.append(best[1])
        scores.append(best[0])
    return ((torch.tensor(queues, dtype=torch.int32),
             torch.from_numpy(np.array(scores, np.float32))), "group")


def _assert_same(got, want):
    a, s = (np.asarray(x) for x in got)
    ra, rs = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(a, ra)
    assert s.dtype == rs.dtype == np.float32
    np.testing.assert_array_equal(s.view(np.int32), rs.view(np.int32))


@pytest.mark.parametrize("n,b,qanc", CASES, ids=IDS)
def test_plain_maxweight_matches_reference(n, b, qanc):
    rng = np.random.default_rng(n * 7 + b)
    args = _inputs(rng, n, b, qanc)
    q, s = (x.numpy() for x in _port(*args))
    rq, rs = (np.asarray(x) for x in rref.maxweight_claim(
        *(jnp.asarray(x) for x in args)))
    np.testing.assert_array_equal(q, rq)
    assert s.dtype == rs.dtype == np.float32
    np.testing.assert_array_equal(s.view(np.int32), rs.view(np.int32))
    kq, ks = (np.asarray(x) for x in rops.maxweight_claim(*args))
    np.testing.assert_array_equal(q, kq)
    np.testing.assert_allclose(s, ks, rtol=1e-6)


@pytest.mark.parametrize("n,b,qanc", CASES[:2], ids=IDS[:2])
def test_all_empty_rows_score_neginf(n, b, qanc):
    rng = np.random.default_rng(5)
    q, qanc, ids, ianc, er = _inputs(rng, n, b, qanc)
    q[:] = 0.0
    got_q, got_s = (x.numpy() for x in _port(q, qanc, ids, ianc, er))
    rq, rs = (np.asarray(x) for x in rref.maxweight_claim(
        *(jnp.asarray(x) for x in (q, qanc, ids, ianc, er))))
    np.testing.assert_array_equal(got_q, rq)
    np.testing.assert_array_equal(got_q, 0)
    np.testing.assert_array_equal(got_s, rs)
    assert np.isneginf(got_s).all()
    _, ks = rops.maxweight_claim(q, qanc, ids, ianc, er)
    assert (np.asarray(ks) < -1e30).all() and (got_s < -1e30).all()


@pytest.mark.parametrize("n,b,qanc", TABLES + CASES, ids=TABLE_IDS + IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_two_pass_model_matches_reference(n, b, qanc, kind):
    """The kernel's decomposition, in plain code, equals the plain version
    and the JAX oracle bit for bit, and takes the group-restricted path
    exactly where the tables meet the precondition."""
    rng = np.random.default_rng(n * 5 + b + KINDS.index(kind))
    args = _kind_inputs(rng, n, b, qanc, kind)
    got, path = _two_pass(*args)
    table = np.asarray(qanc)
    table = table[None] if table.ndim == 1 else table
    # every table here is nested; the permuted ones are not sorted
    sorted_rows = bool((np.diff(table, axis=1) >= 0).all())
    foreign = kind == "foreign_idle_anc" and table.shape[0] > 0
    assert path == ("group" if sorted_rows and not foreign else "all-pairs")
    _assert_same(got, _port(*args))
    _assert_same(got, rref.maxweight_claim(*(jnp.asarray(x) for x in args)))


def test_near_tie_goes_to_the_lower_index():
    """Queue 1 holds nextafter(x, 0), queue 48 (another rack) holds x, and
    the remote rate w rounds both products to one float: an idle server
    of a third rack claims queue 1, though queue 48 is the longer.  The
    argmax of Q alone would give 48; the near list gives 1."""
    rng = np.random.default_rng(11)
    n = 96
    qanc = np.array(loc.Topology(n, 6).ancestors)
    x, y, w = near_tie(rng)
    assert y < x and w * y == w * x
    q = np.zeros(n, np.float32)
    q[1], q[48] = y, x
    ids = np.array([30, 3, 50], np.int32)       # racks 5, 0 and 8
    er = np.tile(np.float32((0.5, 0.45, w)), (3, 1))
    args = (q, qanc, ids, qanc[:, ids], er)
    got, path = _two_pass(*args)
    assert path == "group"
    # rack 5: both remote, the lower index; rack 0: queue 1 in its own
    # rack at 0.45 y beats w x; rack 8: queue 48 in its own rack
    np.testing.assert_array_equal(np.asarray(got[0]), [1, 1, 48])
    assert np.asarray(got[1])[0] == w * x
    _assert_same(got, _port(*args))
    _assert_same(got, rref.maxweight_claim(*(jnp.asarray(a) for a in args)))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    args = _inputs(rng, 64, 8, np.arange(64) // 8)
    before = dict(ops.LAUNCHES)
    out = _port(*args)
    assert ops.LAUNCHES == before  # no kernel launched for CPU tensors
    q, qanc, ids, ianc, er = (torch.as_tensor(x) for x in args)
    plain = ref.maxweight_claim(q, qanc[None], ids, ianc[None], er)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mw.maxweight_claim_cuda(q, qanc[None].to(torch.int32), ids,
                                ianc[None].to(torch.int32), er)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,qanc", CASES + TABLES, ids=IDS + TABLE_IDS)
def test_cuda_kernel_matches_plain_version(n, b, qanc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(4)
    table = np.asarray(qanc)
    table = table[None] if table.ndim == 1 else table
    for kind in KINDS:
        host = _kind_inputs(rng, n, b, qanc, kind)
        args = [torch.as_tensor(x, device="cuda") for x in host]
        before = ops.LAUNCHES["maxweight_claim"]
        out = ops.maxweight_claim(*args)
        assert ops.LAUNCHES["maxweight_claim"] == before + 1
        ianc = host[3][None] if host[3].ndim == 1 else host[3]
        want = ("group" if _precondition(table, host[2], ianc)
                else "all-pairs")
        assert mw.last_path() == want
        plain = ref.maxweight_claim(*args)
        for a, p in zip(out, plain):
            assert torch.equal(a.view(torch.int32), p.view(torch.int32))
