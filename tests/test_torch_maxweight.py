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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import locality as rloc
from repro.kernels import ops as rops, ref as rref
from repro_torch.kernels import maxweight as mw, ops, ref
from _torch_port import single_torch_thread  # noqa: F401

RATES = {2: (0.5, 0.25), 3: (0.5, 0.45, 0.25), 4: (0.5, 0.45, 0.35, 0.25)}

# (N, B, queue ancestor table): the reference test's legacy rack maps,
# then depth 0 (K = 2) and depth 2 (K = 4)
CASES = (
    (64, 8, np.arange(64) // 8),
    (300, 37, np.arange(300) // 25),
    (2048, 200, np.arange(2048) // 64),
    (300, 37, np.zeros((0, 300), np.int32)),
    (2048, 200, np.array(rloc.Topology(2048, (64, 512)).ancestors)),
)
IDS = ["64x8", "300x37", "2048x200", "k2", "k4"]


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


def _port(*args, device="cpu"):
    return ops.maxweight_claim(*(torch.as_tensor(x, device=device)
                                 for x in args))


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
@pytest.mark.parametrize("n,b,qanc", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(n, b, qanc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(4)
    for empty_frac in (0.0, 0.9, 1.0):
        args = [torch.as_tensor(x, device="cuda")
                for x in _inputs(rng, n, b, qanc, empty_frac)]
        before = ops.LAUNCHES["maxweight_claim"]
        out = ops.maxweight_claim(*args)
        assert ops.LAUNCHES["maxweight_claim"] == before + 1
        plain = ref.maxweight_claim(*args)
        for a, p in zip(out, plain):
            assert torch.equal(a.view(torch.int32), p.view(torch.int32))
