"""The port's SSD scan (`kernels.ops.ssd`: its plain version `ref.ssd` on
the CPU and, on the card, the CUDA kernel) and the plain chunked form
`models.ssm_ops.ssd_chunked`, against the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel through `repro.kernels.ops.ssd` in interpret mode, the oracle
`repro.kernels.ref.ssd` and `repro.models.ssm_ops.ssd_chunked_jnp`.
Inputs are made with numpy from a seed and handed to both.  Tolerances
are those of tests/test_kernels_ssd.py: 3e-4 in float32 (the same
float32 recurrence summed in another order), 3e-2 in bfloat16 (one bf16
rounding of outputs of order 1, 2^-8 relative).  On the card bf16 runs
the chunked form on the tensor cores, which rounds three more things to
bf16; a plain model of those rounding points is held here to the same
limits, and each bf16 row to 1% of its largest value (`BF16_ROW_REL`
of chip_smoke.py).  float32 runs the same chunked form as split TF32
(every product three TF32 products of hi + lo splits, float32 sums): a
plain model of it is held to the float32 limit against the JAX oracle
and the Pallas kernel, and a model with one TF32 product is shown to
miss it.  The `cuda`-marked tests need only the port: on a
machine with the card and no JAX, `PYTHONPATH=src python -m pytest
--noconftest -m cuda tests/test_torch_ssd.py`.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssm_ops

try:  # the JAX reference, which the CPU tests compare against
    import jax.numpy as jnp

    from repro.kernels import ops as rops, ref as rref
    from repro.models import ssm_ops as rssm
    from _torch_port import single_torch_thread  # noqa: F401
    from _torch_port import tf32_round as _tf32
except ModuleNotFoundError:  # the port alone: only the cuda tests run
    jnp = rops = rref = rssm = None

CASES = [
    # b, t, h, p, n  (tests/test_kernels_ssd.py::CASES)
    (1, 128, 2, 32, 16),
    (2, 200, 3, 16, 32),    # t not a chunk multiple
    (1, 64, 1, 8, 8),       # single small chunk
    (1, 512, 4, 64, 64),    # multi-chunk, square state
]
TOL = {"float32": 3e-4, "bfloat16": 3e-2}
BF16_ROW_REL = 1e-2
# mamba2-1.3b's head widths (P 64, N 128), a chunk and a ragged T
MAMBA_CASES = [(1, 128, 2, 64, 128), (1, 300, 2, 64, 128)]


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


def _row_rel(got, want):
    """Worst row's max |got - want| over the row's max |want| (rows: P)."""
    diff = (got.float() - want.float()).abs()
    return float((diff.amax(-1) / want.float().abs().amax(-1)
                  .clamp_min(1e-30)).max())


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _hi_lo(v):
    """v as the kernel feeds it to the tensor cores: bf16(v) + bf16(v -
    bf16(v)), in float32."""
    hi = _bf16(v)
    return hi + _bf16(v - hi)


def _chunked_bf16_model(x, a, b, c, h0, chunk=ssd_scan.TC_CHUNK):
    """The tensor-core kernel's arithmetic in plain PyTorch: per chunk of
    `chunk` steps, with lcum the prefix sum of a and total its last,
    S' = C B^T exp(lcum_t - lcum_s) for s <= t, y = exp(lcum_t) C h^T +
    S' X and h = exp(total) h + X^T (w o B), w_s = exp(total - lcum_s),
    where S', h (in C h^T) and w o B each enter as a pair of bf16 hi +
    lo (`_hi_lo`); float32 sums, every exponent clamped at 0."""
    xf, bf, cf = (v.float() for v in (x, b, c))
    h = h0.float().clone()
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        xs, bs, cs = (v[:, t0:t0 + chunk] for v in (xf, bf, cf))
        lcum = torch.cumsum(a[:, t0:t0 + chunk].float(), 1)    # (B, l, H)
        total = lcum[:, -1]
        tri = torch.tril(torch.ones(xs.shape[1], xs.shape[1],
                                    dtype=torch.bool))[None, :, :, None]
        decay = torch.exp(torch.clamp(lcum[:, :, None] - lcum[:, None],
                                      max=0))                    # (B,t,s,H)
        scores = torch.einsum("btn,bsn->bts", cs, bs)[..., None]
        sp = _hi_lo(torch.where(tri, scores * decay, torch.zeros(())))
        y = (torch.exp(lcum)[..., None]
             * torch.einsum("btn,bhpn->bthp", cs, _hi_lo(h))
             + torch.einsum("btsh,bshp->bthp", sp, xs))
        w = torch.exp(torch.clamp(total[:, None] - lcum, max=0))  # (B,s,H)
        wb = _hi_lo(w[..., None] * bs[:, :, None, :])             # (B,s,H,N)
        h = (torch.exp(total)[..., None, None] * h
             + torch.einsum("bshp,bshn->bhpn", xs, wb))
        ys.append(y)
    return torch.cat(ys, 1).to(x.dtype), h


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, products):
    """a @ b as three TF32 products of the hi + lo splits (`products` 3)
    or one product of the operands rounded once (1); float32 sums."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _chunked_tf32_model(x, a, b, c, h0, chunk=ssd_scan.TC_CHUNK,
                        products=3):
    """The float32 tensor-core kernel's arithmetic in plain PyTorch: per
    chunk, with lcum the prefix sum of a and total its last, S = C B^T,
    Z = C h^T (h from its copy), S' = S exp(lcum_t - lcum_u) for u <= t,
    y = exp(lcum_t) Z + S' X, and h^T <- exp(total) h^T + (w o B)^T X
    with w_u = exp(total - lcum_u) and B taken back from its split tile
    (hi + lo) before w o B is split again; every product through `_mm`,
    every exponent clamped at 0."""
    h = h0.float().clone()                                   # (B, H, P, N)
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        xs = x[:, t0:t0 + chunk].float().permute(0, 2, 1, 3)  # (B, H, l, P)
        bs, cs = (v[:, t0:t0 + chunk].float() for v in (b, c))  # (B, l, N)
        lcum = torch.cumsum(a[:, t0:t0 + chunk].float(), 1).transpose(1, 2)
        total = lcum[..., -1:]                                  # (B, H, 1)
        l = xs.shape[2]
        s = _mm(cs, bs.transpose(1, 2), products)[:, None]     # (B, 1, l, l)
        decay = torch.exp(torch.clamp(lcum[..., :, None] - lcum[..., None, :],
                                      max=0))                   # (B, H, l, l)
        sp = torch.where(torch.tril(torch.ones(l, l, dtype=torch.bool)),
                         s * decay, torch.zeros(()))
        z = _mm(cs[:, None], h.transpose(-1, -2), products)    # (B, H, l, P)
        ys.append(torch.exp(lcum)[..., None] * z + _mm(sp, xs, products))
        w = torch.exp(torch.clamp(total - lcum, max=0))        # (B, H, l)
        wb = w[..., None] * sum(_split(bs))[:, None]           # (B, H, l, N)
        h = (torch.exp(total)[..., None] * h
             + _mm(wb.transpose(-1, -2), xs, products).transpose(-1, -2))
    return torch.cat(ys, 2).permute(0, 2, 1, 3), h


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


@pytest.mark.parametrize("case", CASES + MAMBA_CASES)
def test_chunked_bf16_model_matches_reference(case):
    """The tensor-core kernel's rounding points (S', w o B and the state
    copy as bf16 hi + lo pairs, float32 sums) keep y within 3e-2 of
    `ref.ssd` and of the JAX oracle, every row within 1% of its largest
    value, and the float32 final state within float32's 3e-4 (the limit
    chip_smoke.py holds it to), from a nonzero initial state."""
    arrays = _inputs(case, seed=4)
    x, a, b, c = _torch(arrays, torch.bfloat16)
    h0 = torch.from_numpy(np.random.default_rng(7).normal(
        size=case[:1] + case[2:]).astype(np.float32)) * 0.1
    y, h = _chunked_bf16_model(x, a, b, c, h0)
    assert y.dtype == torch.bfloat16 and y.shape == case[:4]
    wy, wh = ref.ssd(x, a, b, c, init_state=h0)
    tol, h_tol = TOL["bfloat16"], TOL["float32"]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=h_tol, rtol=h_tol)
    assert _row_rel(y, wy) <= BF16_ROW_REL
    jy, jh = rref.ssd(*_jax(arrays, jnp.bfloat16),
                      init_state=jnp.asarray(h0.numpy()))
    _close(y, jy, tol, "y: chunked bf16 model vs the JAX oracle")
    _close(h, jh, h_tol, "state: chunked bf16 model vs the JAX oracle")


def test_route_sends_bf16_to_the_tensor_cores():
    """bf16 and float32 at every Mamba-2 width the port serves take the
    chunked kernel on the tensor cores (`TENSOR_CORES`,
    `TENSOR_CORES_F32`); N = 4, P over 64 or not a multiple of 8 take the
    recurrent one (bf16 rows of 4 elements are not a multiple of 16
    bytes, which TMA needs; float32's products step over N by 8)."""
    from repro_torch.configs import registry

    for get in (registry.get_config, registry.get_smoke_config):
        cfg = get("mamba2_13b")
        p, n = cfg.ssm.head_dim, cfg.ssm.d_state
        assert ssd_scan.route(torch.bfloat16, p, n) == ssd_scan.TENSOR_CORES
        assert (ssd_scan.route(torch.float32, p, n)
                == ssd_scan.TENSOR_CORES_F32)
    for p, n in ((8, 8), (16, 32), (32, 16), (64, 64), (64, 128)):
        assert ssd_scan.route(torch.bfloat16, p, n) == ssd_scan.TENSOR_CORES
        assert (ssd_scan.route(torch.float32, p, n)
                == ssd_scan.TENSOR_CORES_F32)
    for p, n in ((4, 4), (8, 4), (4, 8), (128, 128), (12, 16)):
        assert (ssd_scan.route(torch.bfloat16, p, n)
                == ssd_scan.RECURRENT_BF16)
        assert ssd_scan.route(torch.float32, p, n) == ssd_scan.RECURRENT_F32
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan.route(torch.float16, 64, 128)


@pytest.mark.parametrize("case", CASES + MAMBA_CASES)
def test_chunked_tf32_model_matches_reference(case):
    """The float32 tensor-core kernel's split-TF32 arithmetic keeps y and
    the final state within float32's 3e-4 of `ref.ssd`, of the JAX
    oracle and of the Pallas kernel in interpret mode, from a nonzero
    initial state."""
    arrays = _inputs(case, seed=6)
    x, a, b, c = _torch(arrays, torch.float32)
    h0 = torch.from_numpy(np.random.default_rng(8).normal(
        size=case[:1] + case[2:]).astype(np.float32)) * 0.1
    y, h = _chunked_tf32_model(x, a, b, c, h0)
    tol = TOL["float32"]
    jx, jh0 = _jax(arrays, jnp.float32), jnp.asarray(h0.numpy())
    want = {"ref.ssd": ref.ssd(x, a, b, c, init_state=h0),
            "JAX oracle": rref.ssd(*jx, init_state=jh0),
            "Pallas": rops.ssd(*jx, init_state=jh0)}
    for name, (wy, wh) in want.items():
        _close(y, wy, tol, f"y: chunked TF32 model vs {name}")
        _close(h, wh, tol, f"state: chunked TF32 model vs {name}")


def test_one_tf32_product_model_misses_the_limit():
    """With one TF32 product a chunk (operands rounded once) the same
    arithmetic misses 3e-4 by far at mamba2-1.3b's widths, so the split
    is needed."""
    x, a, b, c = _torch(_inputs(MAMBA_CASES[0], seed=6), torch.float32)
    h0 = torch.zeros((1, 2, 64, 128))
    y, h = _chunked_tf32_model(x, a, b, c, h0, products=1)
    wy, wh = ref.ssd(x, a, b, c, init_state=h0)
    assert float((y - wy).abs().max()) > 10 * TOL["float32"]


def test_float32_views_and_no_state_reach_the_kernel_uncopied():
    """The card's half of `ops.ssd` hands `mamba_block`'s views of b and
    c (slices of the convolution's output) to the float32 kernel as they
    are, a missing initial state as None (no zeros launched), and bf16
    ones as contiguous copies (its TMA maps)."""
    seen = []

    def record(x, a, b, c, h0):
        seen.append((x, a, b, c, h0))
        return x, h0

    x = torch.zeros((1, 16, 4, 8))
    a = torch.zeros((1, 16, 4))
    conv = torch.zeros((1, 16, 32 + 2 * 16))
    b, c = torch.split(conv, [32, 16, 16], dim=-1)[1:]
    with mock.patch.object(ops, "ssd_cuda", record):
        ops._ssd_card(x, a, b, c, None)
        gx, ga, gb, gc, gh = seen[-1]
        assert gx is x and ga is a and gb is b and gc is c and gh is None
        assert not gb.is_contiguous()
        h0 = torch.zeros((1, 4, 8, 16))
        ops._ssd_card(x, a, b, c, h0)
        assert seen[-1][4] is h0
        bf = [v.to(torch.bfloat16) for v in (x, b, c)]
        ops._ssd_card(bf[0], a, bf[1], bf[2], None)
        assert all(v.is_contiguous() for v in seen[-1][:4])


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


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 129, 300])
def test_cuda_bf16_tensor_core_kernel_at_ragged_lengths(t):
    """The tensor-core kernel at mamba2-1.3b's head widths for lengths
    below, across and past a chunk, from a nonzero state: y within 3e-2
    of `ref.ssd`, every row within 1%, the float32 final state within
    3e-4, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    case = (2, t, 4, 64, 128)
    assert (ssd_scan.route(torch.bfloat16, 64, 128)
            == ssd_scan.TENSOR_CORES)
    x, a, b, c = _torch(_inputs(case, seed=5), torch.bfloat16,
                        device="cuda")
    h0 = torch.randn(case[:1] + case[2:], device="cuda") * 0.1
    before = ops.LAUNCHES["ssd"]
    y, h = ops.ssd(x, a, b, c, init_state=h0)
    assert ops.LAUNCHES["ssd"] == before + 1
    wy, wh = ref.ssd(x, a, b, c, init_state=h0)
    tol, h_tol = TOL["bfloat16"], TOL["float32"]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=h_tol, rtol=h_tol)
    assert _row_rel(y.cpu(), wy.cpu()) <= BF16_ROW_REL


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 16, 64, 8, 16), (1, 128, 64, 64, 128),
                                  (2, 300, 4, 64, 128), (1, 1, 2, 64, 128)])
@pytest.mark.parametrize("init", [True, False])
def test_cuda_float32_tensor_core_kernel_on_split_views(case, init):
    """float32 on the tensor cores with b and c as views into one buffer
    (as `mamba_block` passes them) and with or without an initial state,
    at the launcher's shape, mamba2-1.3b's full width, a ragged T and
    T = 1: y and the final state within 3e-4 of `ref.ssd`, one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    bsz, t, h, p, n = case
    assert ssd_scan.route(torch.float32, p, n) == ssd_scan.TENSOR_CORES_F32
    x, a, b, c = _torch(_inputs(case, seed=9), torch.float32, device="cuda")
    conv = torch.cat([torch.zeros_like(b[..., :8]), b, c], -1)
    b, c = conv[..., 8:8 + n], conv[..., 8 + n:]
    h0 = (torch.randn(case[:1] + case[2:], device="cuda") * 0.1 if init
          else None)
    before = ops.LAUNCHES["ssd"]
    y, hT = ops.ssd(x, a, b, c, init_state=h0)
    assert ops.LAUNCHES["ssd"] == before + 1
    wy, wh = ref.ssd(x, a, b, c, init_state=h0)
    tol = TOL["float32"]
    torch.testing.assert_close(y, wy, atol=tol, rtol=tol)
    torch.testing.assert_close(hT, wh, atol=tol, rtol=tol)
