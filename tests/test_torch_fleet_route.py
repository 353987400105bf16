"""The port's `fleet_route` (plain version and segment-min form) and the
Balanced-PANDAS pieces the fleet path runs, against the JAX reference.

The reference side runs as its own tests run it on the CPU: the oracle
`repro.kernels.ref.fleet_route` and the Pallas kernel through
`repro.kernels.ops.fleet_route` in interpret mode.  Integer outputs are
exact and scores bitwise: both sides round every f32 operation alone.
The CUDA kernel itself runs only on the card (`cuda` marker); its
group-restricted scan (each task scores only the union of its locals'
top-level groups) is held here by a plain model of that scan.  The
`cuda`-marked tests need only the port, so on a machine with the card
and no JAX they run alone: `PYTHONPATH=src python -m pytest
--noconftest -m cuda tests/test_torch_fleet_route.py`.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import balanced_pandas as bp, locality as loc
from repro_torch.core.rng import SlotDraws
from repro_torch.kernels import ops, ref, slot_step
from repro_torch.sharding import sim as fs

try:  # the JAX reference, which the CPU tests compare against
    import jax
    import jax.numpy as jnp

    from repro.core import balanced_pandas as rbp, locality as rloc
    from repro.kernels import ops as rops, ref as rref
    from repro.sharding import sim as rfs
    from _torch_port import single_torch_thread  # noqa: F401
except ModuleNotFoundError:  # the port alone: only the cuda tests run
    jax = jnp = rbp = rloc = rops = rref = rfs = None

# (num_servers, group spec, rates) at depth 0 (K=2), 1 and 2
TOPOS = (
    (24, (), (0.5, 0.25)),
    (24, 4, (0.5, 0.45, 0.25)),
    (36, (3, 6), (0.5, 0.45, 0.35, 0.25)),
)
IDS = ["depth0", "depth1", "depth2"]
# explicit (ragged) group sizes: racks of 4, 8, 6, 12, then pods of 12, 18
RAGGED = (
    (30, ((4, 8, 6, 12),), (0.5, 0.45, 0.25)),
    (30, ((4, 8, 6, 12), (12, 18)), (0.5, 0.45, 0.35, 0.25)),
)
RAGGED_IDS = ["ragged1", "ragged2"]


def _fuzz_state(rng, m, k, batch=17):
    """Tie-heavy state: half the batch piles onto servers 0..5."""
    q = rng.integers(0, 60, (m, k)).astype(np.int32)
    serving = rng.integers(0, 8, (m,)).astype(np.int32)
    hot = np.stack([np.sort(rng.choice(6, 3, replace=False))
                    for _ in range(batch // 2)])
    cold = np.stack([np.sort(rng.choice(m, 3, replace=False))
                     for _ in range(batch - batch // 2)])
    return q, serving, np.concatenate([hot, cold]).astype(np.int32)


def _est(m, rates):
    """(M, K) float32 per-server rates (the shared vector broadcast, as
    the reference's `per_server_rates` makes it)."""
    return loc.per_server_rates(loc.Rates(rates).as_array(),
                                m).contiguous().numpy()


def _assert_same(port_out, ref_out):
    s, t, v = (x.numpy() for x in port_out)
    rs, rt, rv = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(t, rt)
    assert v.dtype == rv.dtype == np.float32
    np.testing.assert_array_equal(v.view(np.int32), rv.view(np.int32))


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_plain_fleet_route_matches_reference(m, groups, rates):
    rng = np.random.default_rng(0)
    topo = rloc.Topology(m, groups)
    anc = np.array(topo.ancestors)
    est = _est(m, rates)
    for _ in range(10):
        q, serving, locs = _fuzz_state(rng, m, est.shape[1])
        port = ops.fleet_route(torch.from_numpy(q), torch.from_numpy(serving),
                               torch.from_numpy(est), torch.from_numpy(anc),
                               torch.from_numpy(locs))
        _assert_same(port, rref.fleet_route(q, serving, est, anc, locs))
        # the Pallas kernel (interpret mode), dilated at depth 0
        _assert_same(port, rops.fleet_route(q, serving, est, anc, locs))


def _group_scan(q, serving, est, anc, locs):
    """Plain model of the CUDA kernel's group-restricted scan: W as the
    plain version computes it, then per task only the union of its
    locals' top-level ranges (found by `searchsorted` on the sorted top
    row; the three locals at depth 0), each server's tier deepest level
    first with the local override, and a lexicographic (score, server)
    minimum that starts at (3e38, server 0, tier 0)."""
    q, serving, est = (torch.from_numpy(v) for v in (q, serving, est))
    d, k = anc.shape[0], est.shape[1]
    w = q[:, 0].float() / est[:, 0]
    for t in range(1, k):
        w = w + q[:, t].float() / est[:, t]
    idx = torch.clamp(serving.long() - 1, 0, k - 1)
    resid = torch.gather(est, 1, idx[:, None])[:, 0]
    w = w + torch.where(serving > 0, 1.0 / resid, torch.zeros_like(resid))
    out = []
    for loc3 in locs.tolist():
        if d == 0:
            cand = sorted(set(loc3))
        else:
            top = anc[d - 1]
            groups = sorted(set(top[loc3].tolist()))
            lo = np.searchsorted(top, groups, side="left")
            hi = np.searchsorted(top, groups, side="right")
            cand = [m for a, b in zip(lo, hi) for m in range(a, b)]
        sid = torch.tensor(cand, dtype=torch.long)
        tier = torch.full((len(cand),), d + 1, dtype=torch.int32)
        for lvl in range(d - 1, -1, -1):
            share = np.isin(anc[lvl][cand], anc[lvl][loc3])
            tier[torch.from_numpy(share)] = lvl + 1
        tier[torch.from_numpy(np.isin(cand, loc3))] = 0
        rate = est[sid, tier.long()]
        score = w[sid] / rate - rate * 1e-6
        best = (np.float32(3e38), 0, 0)
        for sc, m, t in zip(score.tolist(), cand, tier.tolist()):
            sc = np.float32(sc)
            if t <= d and (sc, m) < best[:2]:
                best = (sc, m, t)
        out.append(best)
    s, m, t = zip(*out)
    return (torch.tensor(m, dtype=torch.int32), torch.tensor(t,
            dtype=torch.int32), torch.tensor(np.array(s, np.float32)))


@pytest.mark.parametrize("m,groups,rates", TOPOS + RAGGED,
                         ids=IDS + RAGGED_IDS)
def test_group_scan_model_matches_reference(m, groups, rates):
    """The kernel's scan order, in plain PyTorch, equals the plain
    version (all-pairs masked argmin) and the JAX oracle bit for bit on
    tie-heavy states, ragged group sizes included."""
    rng = np.random.default_rng(5)
    anc = np.array(loc.Topology(m, groups).ancestors)
    np.testing.assert_array_equal(anc, rloc.Topology(m, groups).ancestors)
    est = _est(m, rates)
    for _ in range(10):
        q, serving, locs = _fuzz_state(rng, m, est.shape[1])
        model = _group_scan(q, serving, est, anc, locs)
        _assert_same(model, rref.fleet_route(q, serving, est, anc, locs))
        _assert_same(model, ref.fleet_route(
            torch.from_numpy(q), torch.from_numpy(serving),
            torch.from_numpy(est), torch.from_numpy(anc),
            torch.from_numpy(locs)))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=12),
       st.lists(st.integers(1, 4), min_size=1, max_size=12),
       st.integers(1, 6))
def test_ancestor_tables_meet_the_kernel_precondition(racks, pods, uniform):
    """`Topology.ancestors` rows are non-decreasing and nested, for
    explicit (ragged) and uniform sizes, so `check_anc_ranges` passes."""
    # pods: consecutive runs of racks, of the drawn lengths (cut to fit)
    pod_sizes, i = [], 0
    for n in pods:
        if i >= len(racks):
            break
        pod_sizes.append(sum(racks[i:i + n]))
        i += n
    if i < len(racks):
        pod_sizes.append(sum(racks[i:]))
    m = sum(racks)
    specs = [(racks,), (uniform, uniform * 2), ()]
    if len(pod_sizes) < len(racks):
        specs.append((racks, pod_sizes))
    for spec in specs:
        mm = m if spec and spec[0] is racks else uniform * 2 * len(racks)
        anc = np.array(loc.Topology(mm, spec).ancestors)
        assert (np.diff(anc, axis=1) >= 0).all()
        slot_step.check_anc_ranges(anc)


def test_make_ctx_checks_the_kernel_precondition():
    """`make_ctx` raises on a table whose groups are not contiguous
    ascending ranges (shuffled servers) or do not nest, and takes every
    `Topology`'s own."""
    topo = loc.Topology(24, (4, 12))
    fs.make_ctx(topo, "cpu")
    rng = np.random.default_rng(6)

    class Shuffled(loc.Topology):
        @property
        def ancestors(self):
            return super().ancestors[:, rng.permutation(self.num_servers)]

    with pytest.raises(ValueError, match="contiguous"):
        fs.make_ctx(Shuffled(24, (4, 12)), "cpu")
    bad = np.array([[0, 0, 1, 1], [0, 1, 1, 1]], np.int32)
    with pytest.raises(ValueError, match="nested"):
        slot_step.check_anc_ranges(bad)
    # the plain version takes any table: it equals the oracle on these
    q, serving, locs = _fuzz_state(rng, 24, 4)
    anc = Shuffled(24, (4, 12)).ancestors
    est = _est(24, (0.5, 0.45, 0.35, 0.25))
    _assert_same(ref.fleet_route(*(torch.from_numpy(np.ascontiguousarray(v))
                                   for v in (q, serving, est, anc, locs))),
                 rref.fleet_route(q, serving, est, anc, locs))


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_segmin_route_matches_reference(m, groups, rates):
    rng = np.random.default_rng(1)
    topo = loc.Topology(m, groups)
    rctx = rfs.make_ctx(rloc.Topology(m, groups))
    ctx = fs.make_ctx(topo, "cpu")
    est = _est(m, rates)
    est_t = torch.from_numpy(est)
    for _ in range(10):
        q, serving, locs = _fuzz_state(rng, m, est.shape[1])
        s = bp.PandasState(torch.from_numpy(q), torch.from_numpy(serving))
        w = bp.workload(s, est_t)
        rw = rbp.workload(rbp.PandasState(jnp.asarray(q),
                                          jnp.asarray(serving)),
                          jnp.asarray(est))
        np.testing.assert_array_equal(w.numpy().view(np.int32),
                                      np.asarray(rw).view(np.int32))
        port = fs._private_route_segmin(w, est_t, ctx, torch.from_numpy(locs))
        _assert_same(port, rfs._private_route_segmin(rw, jnp.asarray(est),
                                                     rctx, jnp.asarray(locs)))
        _assert_same(port, rref.fleet_route(q, serving, est,
                                            np.array(topo.ancestors), locs))


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_service_and_scheduling_match_reference(m, groups, rates):
    """Completions are ``u < p`` for the reference's own uniforms."""
    rng = np.random.default_rng(2)
    true_k = rloc.Rates(rates).as_array()
    for i in range(10):
        q, serving, _ = _fuzz_state(rng, m, len(rates))
        q[rng.random(q.shape) < 0.5] = 0          # idle and empty rows too
        serving = np.minimum(serving, len(rates)).astype(np.int32)
        key = jax.random.PRNGKey(i)
        u = np.array(jax.random.uniform(key, (m,)))
        rs = rbp.PandasState(jnp.asarray(q), jnp.asarray(serving))
        done_r, compl_r = rbp.service_completions(rs, key, true_k)
        s = bp.PandasState(torch.from_numpy(q), torch.from_numpy(serving))
        done, compl = bp.service_completions(s, torch.from_numpy(u),
                                             loc.Rates(rates).as_array())
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_r))
        assert int(compl) == int(compl_r)
        nxt = bp.schedule_idle(s, done)
        nxt_r = rbp.schedule_idle(rs, done_r)
        np.testing.assert_array_equal(nxt.q.numpy(), np.asarray(nxt_r.q))
        np.testing.assert_array_equal(nxt.serving.numpy(),
                                      np.asarray(nxt_r.serving))
        assert int(bp.num_in_system(nxt)) == int(rbp.num_in_system(nxt_r))


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_sample_arrivals_match_reference(m, groups, rates):
    """The O(B) distinct-3 sampler on the reference's uniforms."""
    rtopo, topo = rloc.Topology(m, groups), loc.Topology(m, groups)
    rctx, ctx = rfs.make_ctx(rtopo), fs.make_ctx(topo, "cpu")
    batch, lam, p_hot = 40, jnp.float32(9.5), 0.5
    for i in range(10):
        key = jax.random.PRNGKey(100 + i)
        types_r, active_r = rfs._sample_arrivals(key, rctx, lam, p_hot,
                                                 batch)
        k_n, k_t = jax.random.split(key)
        n = jnp.minimum(jax.random.poisson(k_n, lam), batch)
        k_hot, k_u = jax.random.split(k_t)
        draws = SlotDraws(
            torch.tensor(int(n)),
            torch.tensor(np.asarray(jax.random.uniform(k_hot, (batch,)))),
            torch.tensor(np.asarray(jax.random.uniform(k_u, (batch, 3)))),
            torch.zeros(m))
        types, active = fs._sample_arrivals(
            draws, ctx, torch.tensor(p_hot, dtype=torch.float32), batch)
        np.testing.assert_array_equal(types.numpy(), np.asarray(types_r))
        np.testing.assert_array_equal(active.numpy(), np.asarray(active_r))
        assert (np.diff(types.numpy(), axis=1) > 0).all()  # distinct, sorted


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    q, serving, locs = _fuzz_state(rng, 24, 3)
    est = torch.from_numpy(_est(24, (0.5, 0.45, 0.25)))
    anc = torch.from_numpy(np.array(loc.Topology(24, 4).ancestors))
    before = dict(ops.LAUNCHES)
    out = ops.fleet_route(torch.from_numpy(q), torch.from_numpy(serving),
                          est, anc, torch.from_numpy(locs))
    assert ops.LAUNCHES == before  # no kernel launched for CPU tensors
    plain = ref.fleet_route(torch.from_numpy(q), torch.from_numpy(serving),
                            est, anc, torch.from_numpy(locs))
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    # the kernel wrapper itself takes CUDA tensors only, and raises
    with pytest.raises(ValueError, match="CUDA tensor"):
        slot_step.fleet_route_cuda(torch.from_numpy(q),
                                   torch.from_numpy(serving), est,
                                   anc.to(torch.int32),
                                   torch.from_numpy(locs))


@pytest.mark.cuda
@pytest.mark.parametrize("m,groups,rates", TOPOS + RAGGED,
                         ids=IDS + RAGGED_IDS)
def test_cuda_kernel_matches_plain_version(m, groups, rates):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    anc = torch.as_tensor(np.array(loc.Topology(m, groups).ancestors),
                          device=dev)
    est = torch.as_tensor(_est(m, rates), device=dev)
    for _ in range(10):
        args = [torch.as_tensor(x, device=dev)
                for x in _fuzz_state(rng, m, est.shape[1])]
        before = ops.LAUNCHES["fleet_route"]
        out = ops.fleet_route(args[0], args[1], est, anc, args[2])
        assert ops.LAUNCHES["fleet_route"] == before + 1
        plain = ref.fleet_route(args[0], args[1], est, anc, args[2])
        for a, b in zip(out, plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cuda_wrapper_refuses_two_cell_axes():
    """One leading cell axis at most (the kernel's blockIdx.y)."""
    q = torch.zeros((2, 2, 24, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="one cell axis"):
        slot_step.fleet_route_cuda(q, q[..., 0], q.float(),
                                   torch.zeros((1, 24), dtype=torch.int32),
                                   torch.zeros((2, 2, 5, 3),
                                               dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,groups,rates", TOPOS + RAGGED,
                         ids=IDS + RAGGED_IDS)
def test_cuda_batched_kernel_matches_plain_and_single_cells(m, groups,
                                                            rates):
    """N cells in one launch equal the plain version and N one-cell
    launches, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    anc = torch.as_tensor(np.array(loc.Topology(m, groups).ancestors),
                          device=dev)
    for n in (1, 2, 7):
        cells = [_fuzz_state(rng, m, len(rates)) for _ in range(n)]
        q, serving, locs = (torch.as_tensor(np.stack(x), device=dev)
                            for x in zip(*cells))
        est = torch.as_tensor(np.stack([_est(m, rates)] * n), device=dev)
        before = ops.LAUNCHES["fleet_route"]
        out = ops.fleet_route(q, serving, est, anc, locs)
        assert ops.LAUNCHES["fleet_route"] == before + 1
        plain = ref.fleet_route(q, serving, est, anc, locs)
        for a, b in zip(out, plain):
            assert a.shape == (n, locs.shape[1])
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for c in range(n):
            one = ops.fleet_route(q[c], serving[c], est[c], anc, locs[c])
            for a, b in zip(one, out):
                assert torch.equal(a.view(torch.int32),
                                   b[c].view(torch.int32))
