"""The port's `flash_attention` (plain version and, on the card, the CUDA
kernel) against the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel through `repro.kernels.ops.flash_attention` in interpret mode,
and the oracle `repro.kernels.ref.mha`.  Inputs are made with numpy from
a seed and handed to both.  Tolerances are those of
tests/test_kernels_attention.py: 2e-5 in float32 (the same float32
arithmetic in another order), 2e-2 in bfloat16 (one bf16 rounding of the
output, 2^-8 relative, on values of order 1).

The `cuda`-marked tests need only the port, so on a machine with the
card and no JAX they run alone:
`PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py`.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ops, ref

try:  # the JAX reference, which the CPU tests compare against
    import jax.numpy as jnp

    from repro.kernels import ops as rops, ref as rref
    from _torch_port import single_torch_thread  # noqa: F401
except ModuleNotFoundError:  # the port alone: only the cuda tests run
    jnp = rops = rref = None

CASES = [
    # b, hq, hkv, tq, tk, d, causal, window, softcap
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 1, 200, 200, 64, True, 0, 0.0),     # GQA kv=1, padding
    (1, 4, 4, 64, 192, 64, True, 0, 0.0),      # chunked prefill (tq < tk)
    (1, 4, 2, 1, 256, 64, True, 0, 0.0),       # pure decode (tq = 1)
    (2, 4, 2, 256, 256, 64, True, 128, 0.0),   # sliding window
    (1, 2, 2, 128, 128, 64, True, 0, 50.0),    # gemma2-style softcap
    (1, 2, 2, 96, 96, 32, False, 0, 0.0),      # non-causal (encoder)
    (1, 2, 1, 256, 256, 128, True, 64, 30.0),  # window + softcap + GQA
]
# head dim 8 (the tiny model configs) and 256 (gemma at full width)
EXTRA = [(1, 4, 2, 40, 40, 8, True, 0, 0.0),
         (1, 2, 1, 48, 48, 256, True, 16, 30.0)]


def _inputs(case, seed):
    b, hq, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, tq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32))


def _opts(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


@pytest.mark.parametrize("case", CASES + EXTRA)
def test_plain_matches_reference_f32(case):
    q, k, v = _inputs(case, sum(case[:6]))
    out = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **_opts(case))
    assert out.dtype == torch.float32
    pallas = np.asarray(rops.flash_attention(q, k, v, **_opts(case)))
    oracle = np.asarray(rref.mha(q, k, v, **_opts(case)))
    np.testing.assert_allclose(out.numpy(), pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[7]])
def test_plain_matches_reference_bf16(case):
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(case, 42))
    tq, tk, tv = (torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **_opts(case))
    assert out.dtype == torch.bfloat16
    pallas = np.asarray(rops.flash_attention(q, k, v, **_opts(case)),
                        np.float32)
    oracle = np.asarray(rref.mha(q, k, v, **_opts(case)), np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(out.float().numpy(), oracle, atol=2e-2,
                               rtol=2e-2)


def test_fully_masked_rows_give_zero():
    """Tq > Tk with causal: the first Tq - Tk rows keep no key.  The
    plain version gives 0 there, as the Pallas kernel does (the JAX
    oracle gives NaN); the other rows match the Pallas kernel."""
    case = (1, 2, 1, 48, 32, 32, True, 0, 0.0)
    q, k, v = _inputs(case, 5)
    out = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **_opts(case)).numpy()
    pallas = np.asarray(rops.flash_attention(q, k, v, **_opts(case)))
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out[:, :, :16], 0.0)
    np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=2e-5)


def test_gqa_maps_head_to_kv_head_by_division():
    """Query head h reads kv head h // (Hq / Hkv) (`repeat_interleave`,
    not `repeat`): equal to per-head attention against that kv head."""
    case = (1, 6, 2, 24, 24, 8, True, 0, 0.0)
    q, k, v = (torch.tensor(x) for x in _inputs(case, 6))
    out = ops.flash_attention(q, k, v)
    for h in range(6):
        one = ref.mha(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                      v[:, h // 3:h // 3 + 1])
        torch.testing.assert_close(out[:, h:h + 1], one, atol=1e-6,
                                   rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.tensor(x) for x in _inputs(CASES[0], 3))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before  # no kernel launched for CPU tensors
    assert torch.equal(out, ref.mha(q, k, v, scale=64 ** -0.5))


def test_cuda_wrapper_raises_on_cpu_tensors_and_bad_head_dims():
    q, k, v = (torch.tensor(x) for x in _inputs(CASES[0], 3))
    opts = dict(causal=True, window=0, softcap=0.0, scale=0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v, **opts)
    for d in (16, 96, 512):
        bad = [torch.zeros(x.shape[:3] + (d,)) for x in (q, k, v)]
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_cuda(*bad, **opts)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q[:, :3], k, v, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + EXTRA)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain_version(case, dtype, tol):
    """Each launch, bf16 (tensor-core kernel) or float32 (CUDA-core
    kernel), adds exactly 1 to the count and matches the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    q, k, v = (torch.tensor(x, device="cuda").to(dtype)
               for x in _inputs(case, 7))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, **_opts(case))
    assert ops.LAUNCHES["flash_attention"] == before + 1
    plain = ref.mha(q, k, v, **_opts(case))
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)


# chatglm3-6b's prefill shape (B 1, Hq 32, Hkv 2, D 128, causal, bf16) at
# the serving buckets and a ragged length, held as chip_smoke.py holds it:
# 2e-2 absolute/relative and every row within 1% of its largest value
# (one bf16 ulp is 2^-7 of a value; 2e-2 alone cannot see a fault in a
# late row).
@pytest.mark.cuda
@pytest.mark.parametrize("t", [32, 64, 128, 200])
def test_cuda_bf16_kernel_at_the_serving_shape(t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    q, k, v = (torch.tensor(x, device="cuda").to(torch.bfloat16)
               for x in _inputs((1, 32, 2, t, t, 128), t))
    out = ops.flash_attention(q, k, v).float()
    plain = ref.mha(q, k, v).float()
    torch.testing.assert_close(out, plain, atol=2e-2, rtol=2e-2)
    row_rel = ((out - plain).abs().amax(-1)
               / plain.abs().amax(-1).clamp_min(1e-30))
    assert float(row_rel.max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_fully_masked_rows_give_zero(dtype, tol):
    """Tq > Tk with causal on the card: the first Tq - Tk rows keep no
    key and must be exactly 0; the others match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    case = (1, 2, 1, 48, 32, 32, True, 0, 0.0)
    q, k, v = (torch.tensor(x, device="cuda").to(dtype)
               for x in _inputs(case, 5))
    out = ops.flash_attention(q, k, v, **_opts(case))
    assert torch.equal(out[:, :, :16], torch.zeros_like(out[:, :, :16]))
    torch.testing.assert_close(out.float(),
                               ref.mha(q, k, v, **_opts(case)).float(),
                               atol=tol, rtol=tol)

