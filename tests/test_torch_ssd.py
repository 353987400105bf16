"""The port's SSD scan (`kernels.ops.ssd`: its plain version `ref.ssd` on
the CPU and, on the card, the CUDA kernel) and the plain chunked form
`models.ssm_ops.ssd_chunked`, against the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel through `repro.kernels.ops.ssd` in interpret mode, the oracle
`repro.kernels.ref.ssd` and `repro.models.ssm_ops.ssd_chunked_jnp`.
Inputs are made with numpy from a seed and handed to both.  Tolerances
are those of tests/test_kernels_ssd.py: 3e-4 in float32 (the same
float32 recurrence summed in another order), 3e-2 in bfloat16 (one bf16
rounding of outputs of order 1, 2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops, ref as rref
from repro.models import ssm_ops as rssm
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssm_ops
from _torch_port import single_torch_thread  # noqa: F401

CASES = [
    # b, t, h, p, n  (tests/test_kernels_ssd.py::CASES)
    (1, 128, 2, 32, 16),
    (2, 200, 3, 16, 32),    # t not a chunk multiple
    (1, 64, 1, 8, 8),       # single small chunk
    (1, 512, 4, 64, 64),    # multi-chunk, square state
]
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _inputs(case, seed=0):
    """x, a, b, c as float32 numpy arrays (a: log-decay in [-0.2, -0.01])."""
    b, t, h, p, n = case
    rng = np.random.default_rng(seed + sum(case))
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            -rng.uniform(0.01, 0.2, size=(b, t, h)).astype(np.float32),
            (rng.normal(size=(b, t, n)) * 0.3).astype(np.float32),
            (rng.normal(size=(b, t, n)) * 0.3).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    """x, b, c in `dtype` (a stays float32), from the same numpy values."""
    x, a, b, c = (torch.tensor(v, device=device) for v in arrays)
    return x.to(dtype), a, b.to(dtype), c.to(dtype)


def _jax(arrays, dtype):
    x, a, b, c = arrays
    return (jnp.asarray(x, dtype), jnp.asarray(a), jnp.asarray(b, dtype),
            jnp.asarray(c, dtype))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_ssd_matches_reference(case, dtype):
    """`ops.ssd` on CPU tensors and `ssm_ops.ssd_chunked` against the JAX
    oracle, the Pallas kernel (interpret mode) and `ssd_chunked_jnp`."""
    arrays = _inputs(case)
    tx = _torch(arrays, getattr(torch, dtype))
    jx = _jax(arrays, getattr(jnp, dtype))
    want = {"ref.ssd": rref.ssd(*jx), "ops.ssd (Pallas)": rops.ssd(*jx),
            "ssd_chunked_jnp": rssm.ssd_chunked_jnp(*jx)}
    got = {"ops.ssd": ops.ssd(*tx), "ssd_chunked": ssm_ops.ssd_chunked(*tx)}
    tol = TOL[dtype]
    for gname, (y, h) in got.items():
        assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
        assert y.shape == case[:4] and h.shape == case[:1] + case[2:]
        for wname, (wy, wh) in want.items():
            _close(y, wy, tol, f"y: {gname} vs {wname}")
            _close(h, wh, tol, f"state: {gname} vs {wname}")


@pytest.mark.parametrize("fn", ["ops.ssd", "ssd_chunked"])
def test_ssd_initial_state_threading(fn):
    """Splitting a sequence in two and carrying the state equals one
    pass (the decode-from-cache invariant of SSM serving), and the
    split's final state equals the JAX kernel's."""
    scan = ops.ssd if fn == "ops.ssd" else ssm_ops.ssd_chunked
    arrays = _inputs((1, 256, 2, 16, 16), seed=1)
    x, a, b, c = _torch(arrays, torch.float32)
    y_full, h_full = scan(x, a, b, c)
    y1, h1 = scan(x[:, :128], a[:, :128], b[:, :128], c[:, :128])
    y2, h2 = scan(x[:, 128:], a[:, 128:], b[:, 128:], c[:, 128:],
                  init_state=h1)
    tol = TOL["float32"]
    torch.testing.assert_close(y_full[:, :128], y1, atol=tol, rtol=tol)
    torch.testing.assert_close(y_full[:, 128:], y2, atol=tol, rtol=tol)
    torch.testing.assert_close(h_full, h2, atol=tol, rtol=tol)
    jx = _jax(arrays, jnp.float32)
    _, wh1 = rops.ssd(*(v[:, :128] for v in jx))
    _, wh2 = rops.ssd(*(v[:, 128:] for v in jx), init_state=wh1)
    _close(h2, wh2, tol, "threaded state vs the Pallas kernel")


def test_ssd_chunk_size_independence():
    x, a, b, c = _torch(_inputs((1, 256, 2, 16, 16), seed=2), torch.float32)
    tol = TOL["float32"]
    outs = [ssm_ops.ssd_chunked(x, a, b, c, chunk=k) for k in (32, 64, 256)]
    outs += [ops.ssd(x, a, b, c, block_t=k) for k in (64, 256)]
    for y, h in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=tol, rtol=tol)
        torch.testing.assert_close(h, outs[0][1], atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", ["ops.ssd", "ssd_chunked"])
def test_ssd_zero_decay_accumulates(fn):
    """a_log = 0 (decay 1): the state is a running sum of x_s b_s^T."""
    b, t, h, p, n = 1, 32, 1, 4, 4
    x = torch.ones((b, t, h, p))
    a = torch.zeros((b, t, h))
    bm = torch.ones((b, t, n))
    c = torch.ones((b, t, n))
    if fn == "ops.ssd":
        y, hT = ops.ssd(x, a, bm, c, block_t=16)
    else:
        y, hT = ssm_ops.ssd_chunked(x, a, bm, c, chunk=16)
    torch.testing.assert_close(hT, torch.full((b, h, p, n), float(t)),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(y[0, -1, 0], torch.full((p,), float(t * n)),
                               rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_version():
    x, a, b, c = _torch(_inputs(CASES[0]), torch.float32)
    before = dict(ops.LAUNCHES)
    y, h = ops.ssd(x, a, b, c)
    assert ops.LAUNCHES == before  # no kernel launched for CPU tensors
    wy, wh = ref.ssd(x, a, b, c)
    assert torch.equal(y, wy) and torch.equal(h, wh)


def test_cuda_wrapper_raises_on_cpu_tensors_and_bad_shapes():
    x, a, b, c = _torch(_inputs(CASES[0]), torch.float32)
    h0 = torch.zeros((1, 2, 32, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan.ssd_cuda(x, a, b, c, h0)
    for n in (12, 256):
        bad = torch.zeros(b.shape[:2] + (n,))
        with pytest.raises(ValueError, match="state dim"):
            ssd_scan.ssd_cuda(x, a, bad, bad, torch.zeros((1, 2, 32, n)))
    with pytest.raises(ValueError, match="4-d"):
        ssd_scan.ssd_cuda(x[0], a, b, c, h0)
    with pytest.raises(ValueError, match="empty"):
        ssd_scan.ssd_cuda(x[:, :0], a[:, :0], b[:, :0], c[:, :0], h0)


# ------------------------------------------------------------- the card --

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(1, 128, 64, 64, 128),
                                          (1, 8, 4, 8, 16), (1, 77, 2, 4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(case, dtype):
    """The kernel against `ref.ssd` at the test cases, mamba2-1.3b's
    serving width (P 64, N 128), the smoke config's (8, 16), and a
    ragged T with the smallest state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    x, a, b, c = _torch(_inputs(case, seed=3), getattr(torch, dtype),
                        device="cuda")
    h0 = torch.randn(case[:1] + case[2:], device="cuda") * 0.1
    before = ops.LAUNCHES["ssd"]
    y, h = ops.ssd(x, a, b, c, init_state=h0)
    assert ops.LAUNCHES["ssd"] == before + 1
    wy, wh = ref.ssd(x, a, b, c, init_state=h0)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=tol, rtol=tol)
