"""The port's AdamW (`repro_torch.optim.adamw`) against the JAX
reference's (`repro.optim.adamw`, jitted, as its train step runs it) on
the CPU, on the same trees.

Tolerances:
  * `lr_schedule`: 1e-7 relative.  Warmup is the reference's compiled
    product with the folded float32 constant (exact); past warmup the
    cosine's scale is fused into its sum as XLA compiles it, and the
    cosine itself may differ by an ulp.
  * `update`, float32 (moments and update): the moments equal the
    reference's bit for bit, the reference's compiled form fusing the
    first product of ``b1 * m + (1 - b1) * g`` into a multiply-add (the
    two-rounding form misses at thousands of elements, also shown
    below); each new parameter within 2e-6 of the size of the sum that
    forms it, |p| + lr |step| (XLA's rsqrt is not correctly rounded: one
    ulp in the step, which a near-cancelling sum amplifies relative to
    the result).
  * bf16 moments and a bf16 update: within one bf16 ulp.  The port rounds
    each step as the source says; the reference's compiled bf16 gives the
    same moments on these trees and parameters within half a bf16 ulp
    (float32 intermediates would put the moments up to 23 ulps apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.models import params as P
from repro_torch.optim import adamw as TA

STEPS = (0, 1, 99, 100, 101, 5000, 10_000, 10_001, 25_000)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 129), "b": {"c": (300,), "d": (3, 40, 33)},
              "e": (7,)}
    mk = lambda s, scale=1.0, pos=False: jax.tree.map(
        lambda sh: (np.abs(rng.normal(size=sh)) if pos else
                    rng.normal(size=sh)).astype(np.float32) * scale,
        s, is_leaf=lambda x: isinstance(x, tuple))
    return mk(shapes), mk(shapes), mk(shapes, 0.1), mk(shapes, 1.0, True)


def _torch_tree(tree, dtype=torch.float32):
    return P.tree_map(
        lambda x: torch.tensor(np.asarray(x, np.float32)).to(dtype), tree)


def _np_leaves(tree):
    """float32 numpy leaves of a port or reference tree, in one order."""
    return [x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in P.tree_leaves(tree)]


def _run(cfg, count=4, seed=0):
    p, g, m, v = _trees(seed)
    mdt = cfg["moment_dtype"]
    rc, tc = RA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    rst = RA.AdamWState(jnp.int32(count),
                        jax.tree.map(lambda x: jnp.asarray(x, mdt), m),
                        jax.tree.map(lambda x: jnp.asarray(x, mdt), v))
    rp, rs, rm = jax.jit(lambda g, s, p: RA.update(rc, g, s, p))(g, rst, p)
    tdt = torch.bfloat16 if mdt == "bfloat16" else torch.float32
    tst = TA.AdamWState(torch.tensor(count, dtype=torch.int32),
                        _torch_tree(m, tdt), _torch_tree(v, tdt))
    tp_in = _torch_tree(p)
    tp, ts, tm = TA.update(tc, _torch_tree(g), tst, tp_in)
    assert tp is tp_in  # the parameters are updated in place
    return p, (rp, rs, rm), (tp, ts, tm)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-38)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=7,
                                              decay_steps=1000,
                                              peak_lr=1e-3),
                                 dict(warmup_steps=0, decay_steps=50)])
def test_lr_schedule(cfg):
    steps = sorted(set(STEPS) | {cfg.get("warmup_steps", 100),
                                 cfg.get("warmup_steps", 100) + 1,
                                 cfg.get("decay_steps", 10_000),
                                 cfg.get("decay_steps", 10_000) + 1})
    s = np.asarray(steps, np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: RA.lr_schedule(RA.AdamWConfig(**cfg), x)))(s))
    got = TA.lr_schedule(TA.AdamWConfig(**cfg), torch.tensor(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_lr_schedule_warmup_is_the_folded_product():
    """Warmup bit for bit over 0..warmup: ``step * float32(peak /
    warmup)``; the source's ``peak * step / warmup`` misses."""
    cfg = RA.AdamWConfig()
    s = np.arange(0, 100, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda x: RA.lr_schedule(cfg, x)))(s))
    got = TA.lr_schedule(TA.AdamWConfig(), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    sf = s.astype(np.float32)
    assert (np.float32(3e-4) * sf / np.float32(100) != want).sum() > 0


def test_init_abstract_state_and_global_norm():
    p, g, _, _ = _trees()
    for mdt in ("float32", "bfloat16"):
        rst = RA.init(RA.AdamWConfig(moment_dtype=mdt), p)
        tst = TA.init(TA.AdamWConfig(moment_dtype=mdt), _torch_tree(p))
        ast = TA.abstract_state(TA.AdamWConfig(moment_dtype=mdt),
                                _torch_tree(p))
        assert int(tst.count) == int(rst.count) == 0
        assert tst.count.dtype == ast.count.dtype == torch.int32
        for r, t, a in zip(jax.tree.leaves(rst.mu),
                           P.tree_leaves(tst.mu), P.tree_leaves(ast.mu)):
            assert tuple(t.shape) == tuple(a.shape) == r.shape
            assert str(t.dtype) == str(a.dtype) == f"torch.{r.dtype}"
            assert a.device.type == "meta" and not t.any()
        assert P.tree_leaves(tst.nu)[0] is not P.tree_leaves(tst.mu)[0]
    want = float(RA.global_norm(g))
    got = TA.global_norm(_torch_tree(g))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


@pytest.mark.parametrize("clip", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_update_float32(clip):
    p, (rp, rs, rm), (tp, ts, tm) = _run(dict(grad_clip=clip,
                                             moment_dtype="float32",
                                             warmup_steps=3))
    assert int(ts.count) == int(rs.count) == 5
    assert float(tm["lr"]) == float(rm["lr"])
    gn = float(rm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= 1e-6 * gn
    assert (gn > clip) == (clip == 1.0)
    for name in ("mu", "nu"):
        for r, t in zip(_np_leaves(getattr(rs, name)),
                        _np_leaves(getattr(ts, name))):
            np.testing.assert_array_equal(t, r)
    for old, r, t in zip(_np_leaves(p), _np_leaves(rp), _np_leaves(tp)):
        size = np.abs(old) + np.abs(old - r)   # |p| + lr |step|
        assert np.all(np.abs(t - r) <= 2e-6 * size)


@pytest.mark.parametrize("udt", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_update_bf16_moments(udt, clip):
    p, (rp, rs, rm), (tp, ts, tm) = _run(dict(grad_clip=clip,
                                             moment_dtype="bfloat16",
                                             update_dtype=udt,
                                             warmup_steps=3))
    for name in ("mu", "nu"):
        for t in P.tree_leaves(getattr(ts, name)):
            assert t.dtype == torch.bfloat16
        for r, t in zip(_np_leaves(getattr(rs, name)),
                        _np_leaves(getattr(ts, name))):
            assert np.all(np.abs(t - r) <= _bf16_ulp(r))
    for old, r, t in zip(_np_leaves(p), _np_leaves(rp), _np_leaves(tp)):
        if udt == "bfloat16":
            assert np.all(np.abs(t - r) <= _bf16_ulp(r))
        else:
            size = np.abs(old) + np.abs(old - r)
            assert np.all(np.abs(t - r) <= 2e-6 * size)


def test_no_decay_on_1d_parameters():
    """Zero gradients and moments: only weight decay moves a parameter,
    and it moves every stored tensor of two or more dimensions and no
    1-d one, in both packages."""
    p, _, _, _ = _trees()
    zeros = jax.tree.map(np.zeros_like, p)
    cfg = dict(weight_decay=0.1, warmup_steps=0)
    rp, _, _ = RA.update(RA.AdamWConfig(**cfg), zeros,
                         RA.init(RA.AdamWConfig(**cfg), p), p)
    tp = _torch_tree(p)
    TA.update(TA.AdamWConfig(**cfg), _torch_tree(zeros),
              TA.init(TA.AdamWConfig(**cfg), tp), tp)
    for old, r, t in zip(jax.tree.leaves(p), _np_leaves(rp), _np_leaves(tp)):
        moved = not np.array_equal(t, old)
        assert moved == (old.ndim >= 2) == (not np.array_equal(r, old))
        np.testing.assert_allclose(t, r, rtol=1e-6)


def test_moments_follow_the_compiled_multiply_add():
    """The reference's compiled ``b1 * m + (1 - b1) * g`` is one rounding
    of ``b1 * m`` exact plus the rounded ``(1 - b1) * g``; the source's
    two-rounding form differs from it at thousands of elements, the
    port's `_fma` at none."""
    rng = np.random.default_rng(1)
    m, g = (rng.normal(size=100_000).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(lambda m, g: 0.9 * m + (1 - 0.9) * g)(m, g))
    two = np.float32(0.9) * m + np.float32(0.1) * g
    got = TA._fma(torch.tensor(np.float32(0.9)), torch.tensor(m),
                  torch.tensor(0.1, dtype=torch.float32) * torch.tensor(g))
    assert (two != want).sum() > 1000
    np.testing.assert_array_equal(got.numpy(), want)
