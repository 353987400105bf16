"""The port's `fleet_route` (plain version and segment-min form) and the
Balanced-PANDAS pieces the fleet path runs, against the JAX reference.

The reference side runs as its own tests run it on the CPU: the oracle
`repro.kernels.ref.fleet_route` and the Pallas kernel through
`repro.kernels.ops.fleet_route` in interpret mode.  Integer outputs are
exact and scores bitwise: both sides round every f32 operation alone.
The CUDA kernel itself runs only on the card (`cuda` marker).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import balanced_pandas as rbp, locality as rloc
from repro.kernels import ops as rops, ref as rref
from repro.sharding import sim as rfs
from repro_torch.core import balanced_pandas as bp, locality as loc
from repro_torch.core.rng import SlotDraws
from repro_torch.kernels import ops, ref, slot_step
from repro_torch.sharding import sim as fs
from _torch_port import single_torch_thread  # noqa: F401

# (num_servers, group spec, rates) at depth 0 (K=2), 1 and 2
TOPOS = (
    (24, (), (0.5, 0.25)),
    (24, 4, (0.5, 0.45, 0.25)),
    (36, (3, 6), (0.5, 0.45, 0.35, 0.25)),
)
IDS = ["depth0", "depth1", "depth2"]


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
    return np.array(rloc.per_server_rates(rloc.Rates(rates).as_array(), m))


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
@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
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
