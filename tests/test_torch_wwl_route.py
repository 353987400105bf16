"""The port's `wwl_route` (plain version and, on the card, the CUDA
kernel) against the JAX reference.

The reference side runs as its own tests run it on the CPU: the oracle
`repro.kernels.ref.wwl_route` and the Pallas kernel through
`repro.kernels.ops.wwl_route` in interpret mode.  Indices are exact;
scores are bitwise against the oracle (both round one f32 division) and
within rtol 1e-6 against the Pallas path, as the reference's own test
(tests/test_kernels_sched.py) holds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import locality as rloc
from repro.kernels import ops as rops, ref as rref
from repro_torch.kernels import ops, ref, wwl_route as wwl
from _torch_port import single_torch_thread  # noqa: F401

RATES = {2: (0.5, 0.25), 3: (0.5, 0.45, 0.25), 4: (0.5, 0.45, 0.35, 0.25)}

# (M, B, ancestor table): the reference test's legacy rack maps, then
# depth 0 (K = 2) and depth 2 (K = 4) tables
CASES = (
    (64, 8, np.arange(64) // 8),
    (300, 50, np.arange(300) // 25),
    (1024, 256, np.arange(1024) // 32),
    (4096, 512, np.arange(4096) // 64),
    (300, 50, np.zeros((0, 300), np.int32)),
    (1024, 256, np.array(rloc.Topology(1024, (32, 256)).ancestors)),
)
IDS = ["64x8", "300x50", "1024x256", "4096x512", "k2", "k4"]


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


def _port(wl, er, anc, tl, device="cpu"):
    return ops.wwl_route(*(torch.as_tensor(x, device=device)
                           for x in (wl, er, anc, tl)))


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
@pytest.mark.parametrize("m,b,anc", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(m, b, anc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(4)
    for ties in (False, True):
        args = [torch.as_tensor(x, device="cuda")
                for x in _inputs(rng, m, b, anc, ties)]
        before = ops.LAUNCHES["wwl_route"]
        out = ops.wwl_route(*args)
        assert ops.LAUNCHES["wwl_route"] == before + 1
        plain = ref.wwl_route(*args)
        for a, p in zip(out, plain):
            assert torch.equal(a.view(torch.int32), p.view(torch.int32))
