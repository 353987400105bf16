"""The port's `flash_attention` (plain version and, on the card, the CUDA
kernel) against the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel through `repro.kernels.ops.flash_attention` in interpret mode,
and the oracle `repro.kernels.ref.mha`.  Inputs are made with numpy from
a seed and handed to both.  Tolerances are those of
tests/test_kernels_attention.py: 2e-5 in float32 (the same float32
arithmetic in another order), 2e-2 in bfloat16 (one bf16 rounding of the
output, 2^-8 relative, on values of order 1).

On the card float32 runs as split TF32 on the tensor cores: each
operand enters as TF32 hi + lo (`cvt.rna`) and each product as three.
A plain model of that arithmetic (`_split_tf32_model`: the kernel's
tiles, its online softmax and its roundings, float32 sums) is held here
to the float32 limit against the JAX oracle and the Pallas kernel, and
a model with one TF32 product is shown to miss it.

The `cuda`-marked tests need only the port, so on a machine with the
card and no JAX they run alone:
`PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py`.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ops, ref

try:  # the JAX reference, which the CPU tests compare against
    import jax.numpy as jnp

    from repro.kernels import ops as rops, ref as rref
    from _torch_port import single_torch_thread  # noqa: F401
    from _torch_port import tf32_round as _tf32
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
# head dim 8 (the tiny model configs, mixtral-8x22b's smoke config), 256
# (gemma at full width) and 16 (granite-moe-1b's smoke config: 4 heads on
# 4 KV heads)
EXTRA = [(1, 4, 2, 40, 40, 8, True, 0, 0.0),
         (1, 2, 1, 48, 48, 256, True, 16, 30.0),
         (1, 4, 4, 64, 64, 16, True, 0, 0.0)]
# the 8 cases at head dim 16, on every kernel that takes it
D16_CASES = [c[:5] + (16,) + c[6:] for c in CASES]


def _inputs(case, seed):
    b, hq, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, tq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32))


def _opts(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


# -------------------------------------------- the split-TF32 kernel's model --

LOG2E = 1.4426950408889634
NEG_INF = -2.0e38   # the kernels' running-max start


def _mm(a, b, products):
    """a @ b as the kernel's tensor cores take it: three TF32 products of
    the hi + lo splits (`products` 3), or one product of the operands
    rounded to TF32 once (`products` 1); float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _split_tf32_model(q, k, v, *, causal, window, softcap, scale,
                      products=3):
    """The float32 tensor-core kernel's arithmetic in plain PyTorch: key
    tiles of its BK (32 at D = 128, else 64) in order; S = Q K^T and
    O += P V through `_mm`; the online softmax in log2 units as the
    kernel keeps it (the max over the raw logits, p = 2^(x u - max u),
    u = scale log2 e; under softcap the capped logit times log2 e and
    u = 1); a row that keeps no key gives 0."""
    b, hq, tq, d = q.shape
    g = hq // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    tk = k.shape[2]
    bk = 32 if d == 128 else 64
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    u = 1.0 if softcap > 0 else scale * LOG2E
    m = torch.full((b, hq, tq, 1), NEG_INF)
    l = torch.zeros((b, hq, tq, 1))
    o = torch.zeros((b, hq, tq, d))
    for k0 in range(0, tk, bk):
        s = _mm(q, k[:, :, k0:k0 + bk].transpose(-1, -2), products)
        if softcap > 0:
            s = softcap * torch.tanh(s * scale / softcap) * LOG2E
        kpos = torch.arange(k0, min(k0 + bk, tk))[None, :]
        keep = torch.ones_like(qpos - kpos, dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window > 0:
            keep &= kpos > qpos - window
        s = torch.where(keep, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s * u - mx * u)
        alpha = torch.where(m > NEG_INF, torch.exp2((m - mx) * u), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm(p, v[:, :, k0:k0 + bk], products)
        m = mx
    return o / torch.where(l == 0, 1.0, l)


# the cases the float32 kernel takes (D != 256), then a mid length at
# chatglm3-6b's head width
TF32_CASES = [c for c in CASES + EXTRA if c[5] in fa.TF32_HEAD_DIMS] + [
    (1, 4, 2, 320, 320, 128, True, 0, 0.0)]


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
    for d in (24, 96, 512):
        bad = [torch.zeros(x.shape[:3] + (d,)) for x in (q, k, v)]
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_cuda(*bad, **opts)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q[:, :3], k, v, **opts)


@pytest.mark.parametrize("case", TF32_CASES)
def test_split_tf32_model_matches_reference(case):
    """The float32 kernel's split-TF32 arithmetic keeps every output
    within the float32 limit (2e-5) of `ref.mha`, of the JAX oracle and
    of the Pallas kernel in interpret mode."""
    q, k, v = _inputs(case, sum(case[:6]) + 11)
    opts = _opts(case)
    got = _split_tf32_model(*(torch.tensor(x) for x in (q, k, v)),
                            scale=case[5] ** -0.5, **opts)
    want = {"ref.mha": ref.mha(*(torch.tensor(x) for x in (q, k, v)),
                               **opts).numpy(),
            "JAX oracle": np.asarray(rref.mha(q, k, v, **opts)),
            "Pallas": np.asarray(rops.flash_attention(q, k, v, **opts))}
    for name, w in want.items():
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", [TF32_CASES[0], TF32_CASES[-1]])
def test_one_tf32_product_model_misses_the_limit(case):
    """With one TF32 product (each operand rounded to TF32 once, the
    kinder of rounding and truncation) the same arithmetic misses 2e-5
    by far, so the split is needed."""
    q, k, v = (torch.tensor(x) for x in _inputs(case, sum(case[:6]) + 11))
    opts = dict(_opts(case), scale=case[5] ** -0.5)
    one = _split_tf32_model(q, k, v, products=1, **opts)
    err = float((one - ref.mha(q, k, v, **opts)).abs().max())
    assert err > 10 * 2e-5


def test_route_sends_float32_by_head_dim():
    """bf16 always to the tensor cores; float32 to the split-TF32 kernel
    at every head dim but 256 (the gemma configs at full width), which
    takes the CUDA-core kernel; chatglm3-6b and codeqwen1.5-7b at full
    width and every smoke config land on the tensor cores in float32."""
    from repro_torch.configs import registry

    for d in fa.HEAD_DIMS:
        assert fa.route(torch.bfloat16, d) == fa.BF16_TENSOR_CORES
        want = (fa.F32_CUDA_CORES if d == 256 else fa.F32_TENSOR_CORES)
        assert fa.route(torch.float32, d) == want
    for arch in ("chatglm3_6b", "codeqwen15_7b", "gemma2_2b", "gemma3_1b"):
        for get in (registry.get_config, registry.get_smoke_config):
            d = get(arch).head_dim
            want = (fa.F32_CUDA_CORES if arch.startswith("gemma")
                    and get is registry.get_config else fa.F32_TENSOR_CORES)
            assert fa.route(torch.float32, d) == want, (arch, d)
    with pytest.raises(TypeError, match="dtype"):
        fa.route(torch.float16, 64)


def test_route_takes_head_dim_16():
    """D = 16 (granite-moe-1b's smoke config) is an instantiation of every
    kernel: bf16 on the tensor cores, float32 as split TF32, and the
    smoke configs of both MoE archs take the tensor-core route in
    float32."""
    assert 16 in fa.HEAD_DIMS and 16 in fa.TF32_HEAD_DIMS
    assert fa.route(torch.bfloat16, 16) == fa.BF16_TENSOR_CORES
    assert fa.route(torch.float32, 16) == fa.F32_TENSOR_CORES
    from repro_torch.configs import registry
    for arch, d in (("granite_moe_1b", 16), ("mixtral_8x22b", 8)):
        assert registry.get_smoke_config(arch).head_dim == d
        assert fa.route(torch.float32, d) == fa.F32_TENSOR_CORES


def test_float32_views_reach_the_kernel_uncopied():
    """The card's half of `ops.flash_attention` hands the attention
    layer's (B, H, T, D) views of (B, T, H, D) storage to the float32
    kernel as they are (the same tensors), and bf16 ones as contiguous
    copies (its TMA maps); a tensor whose last axis is strided is
    copied."""
    seen = []

    def record(q, k, v, **opts):
        seen.append((q, k, v))
        return q

    base = torch.zeros((1, 16, 4, 8))
    view = base.transpose(1, 2)
    with mock.patch.object(ops, "flash_attention_cuda", record):
        ops._attention_card(view, view, view, causal=True, window=0,
                            softcap=0.0, scale=0.5)
        assert all(x is view for x in seen[-1])
        bf = view.to(torch.bfloat16)
        ops._attention_card(bf, bf, bf, causal=True, window=0, softcap=0.0,
                            scale=0.5)
        assert all(x.is_contiguous() for x in seen[-1])
        odd = torch.zeros((1, 4, 16, 16))[..., ::2]
        ops._attention_card(odd, odd, odd, causal=True, window=0,
                            softcap=0.0, scale=0.5)
        assert all(x.stride(-1) == 1 for x in seen[-1])


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



# float32 on the tensor cores at the attention layer's layout: q, k, v as
# (B, H, T, D) views of (B, T, H, D) storage, at the launcher's shape and
# chatglm3-6b's full-width prefill (B 1, Hq 32, Hkv 2, D 128), and a
# ragged length; one launch a call, the output a view of (B, T, H, D)
# storage, within 2e-5 of the plain version.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 2, 16, 8), (1, 32, 2, 128, 128),
                                   (1, 32, 2, 200, 128), (2, 4, 2, 77, 64)])
def test_cuda_float32_kernel_on_strided_views(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    b, hq, hkv, t, d = shape
    assert fa.route(torch.float32, d) == fa.F32_TENSOR_CORES
    gen = torch.Generator("cuda").manual_seed(t)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
               .transpose(1, 2) for h in (hq, hkv, hkv))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, ref.mha(q, k, v), atol=2e-5, rtol=2e-5)


# head dim 16 on each kernel: bf16 on the tensor cores (2e-2 and every
# row within 1% of its largest value, as chip_smoke.py holds bf16), float32
# as split TF32 and on the CUDA cores (2e-5); one launch a call
@pytest.mark.cuda
@pytest.mark.parametrize("case", D16_CASES)
@pytest.mark.parametrize("kernel", ["bf16", "f32_tensor_cores",
                                    "f32_cuda_cores"])
def test_cuda_kernels_at_head_dim_16(case, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    dtype, code, tol = {
        "bf16": (torch.bfloat16, fa.BF16_TENSOR_CORES, 2e-2),
        "f32_tensor_cores": (torch.float32, fa.F32_TENSOR_CORES, 2e-5),
        "f32_cuda_cores": (torch.float32, fa.F32_CUDA_CORES, 2e-5)}[kernel]
    q, k, v = (torch.tensor(x, device="cuda").to(dtype)
               for x in _inputs(case, 16))
    opts = dict(_opts(case), scale=0.25)
    before = ops.LAUNCHES["flash_attention"]
    out = fa._launch(q, k, v, code, **opts).float()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    plain = ref.mha(q, k, v, **opts).float()
    torch.testing.assert_close(out, plain, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        row_rel = ((out - plain).abs().amax(-1)
                   / plain.abs().amax(-1).clamp_min(1e-30))
        assert float(row_rel.max()) <= 1e-2
