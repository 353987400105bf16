"""The port's Mamba-2 layer and model (`models.mamba`, `models.ssm_ops`,
the Mamba branches of `models.transformer` and `models.params`) against
the JAX reference on the CPU, in float32, on the mamba2-1.3b smoke
config (4 layers, d_model 256, 64 SSD heads of head dim 8, state 16,
chunk 32).

Weights are the reference's, handed over with `params.from_reference`,
so both compute the same function.  Block outputs and states are held
to 1e-4 and logits to 1e-4 (the same float32 arithmetic in another
order; the SSD scans differ in summation order only), as the dense
model's tests are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import mamba as RM, params as RP, ssm_ops as rssm
from repro.models import transformer as RT
from repro_torch.configs import registry
from repro_torch.models import mamba as M, params as P, ssm_ops
from repro_torch.models import transformer as T
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "mamba2_13b"
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(3))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def _layer(tree):
    """Layer 0 of stage 0's stacked sub-layer parameters."""
    return jax.tree.map(lambda a: a[0], tree["stages"]["stage0"]["sub0"])


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def test_smoke_config_is_the_reference():
    cfg, rcfg = registry.get_smoke_config(ARCH), \
        rregistry.get_smoke_config(ARCH)
    assert repr(cfg) == repr(rcfg).replace("repro.", "repro_torch.")
    full = registry.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.ssm.num_heads(2048),
            full.ssm.head_dim, full.ssm.d_state, full.padded_vocab) == \
        (48, 2048, 64, 64, 128, 50432)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_prefill_and_decode_match_reference(model, use_kernel):
    """A prefill of 40 steps (two chunks, the second ragged) with a
    cache, then two decode steps: the output and both cache entries
    equal the JAX block's."""
    rcfg, rprm, cfg, prm = model
    rp, p = _layer(rprm), _layer(prm)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    rcache = RM.init_mamba_cache(rcfg, 2, jnp.float32)
    cache = M.init_mamba_cache(cfg, 2, "float32", "cpu")
    want, rcache = RM.mamba_block(rp, rcfg, jnp.asarray(x), cache=rcache,
                                  use_kernel=use_kernel)
    got, cache = M.mamba_block(p, cfg, torch.tensor(x), cache=cache,
                               use_kernel=use_kernel)
    _close(got, want, "prefill output")
    for name in ("ssm", "conv"):
        assert cache[name].shape == rcache[name].shape
        _close(cache[name], rcache[name], f"prefill {name} state")
    for step in range(2):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, rcache = RM.mamba_block(rp, rcfg, jnp.asarray(xt),
                                      cache=rcache)
        got, cache = M.mamba_block(p, cfg, torch.tensor(xt), cache=cache)
        _close(got, want, f"decode output {step}")
        for name in ("ssm", "conv"):
            _close(cache[name], rcache[name], f"decode {name} {step}")
    # without a cache: no states come back, and the output is the same
    got, none = M.mamba_block(p, cfg, torch.tensor(x), use_kernel=use_kernel)
    want, _ = RM.mamba_block(rp, rcfg, jnp.asarray(x), use_kernel=use_kernel)
    assert none is None
    _close(got, want, "prefill output without a cache")


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    want = rssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = ssm_ops.causal_conv(*(torch.tensor(v) for v in (x, w, bias)))
    _close(got, want, "causal_conv", tol=1e-5)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    wy, ws = rssm.causal_conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                   jnp.asarray(w), jnp.asarray(bias))
    gy, gs = ssm_ops.causal_conv_step(
        *(torch.tensor(v) for v in (x[:, 0], state, w, bias)))
    _close(gy, wy, "causal_conv_step", tol=1e-5)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # a step from the last K-1 inputs is the full conv's next row
    full = ssm_ops.causal_conv(*(torch.tensor(v) for v in (x, w, bias)))
    step, _ = ssm_ops.causal_conv_step(torch.tensor(x[:, 8]),
                                       torch.tensor(x[:, 5:8]),
                                       torch.tensor(w), torch.tensor(bias))
    torch.testing.assert_close(step, full[:, 8], atol=1e-5, rtol=1e-5)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, size=(2, 3)).astype(np.float32)
    b, c = (rng.normal(size=(2, 5)).astype(np.float32) for _ in range(2))
    state = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    wy, ws = rssm.ssd_decode_step(*(jnp.asarray(v) for v in
                                    (x, a, b, c, state)))
    gy, gs = ssm_ops.ssd_decode_step(*(torch.tensor(v) for v in
                                       (x, a, b, c, state)))
    _close(gy, wy, "y", tol=1e-6)
    _close(gs, ws, "state", tol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas_ssd"])
def test_forward_and_decode_match_reference(model, impl):
    """The whole model: a prefill of 40 tokens with caches, under either
    impl on both sides (the Pallas kernel runs in interpret mode), then
    three decode steps: logits and every layer's states."""
    rcfg, rprm, cfg, prm = model
    tok = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 43)).astype(np.int32)
    full, _, _ = RT.forward(rprm, rcfg, jnp.asarray(tok), impl=impl,
                            remat=False)
    got, none, aux = T.forward(prm, cfg, torch.tensor(tok), impl=impl)
    assert none is None and aux == 0.0
    _close(got, full, "forward logits")
    caches = T.init_caches(cfg, 2, 64, device="cpu")
    rcaches = RT.init_caches(rcfg, 2, 64)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    lg, caches, _ = T.forward(prm, cfg, torch.tensor(tok[:, :40]),
                              positions=torch.tensor(pos), caches=caches,
                              impl=impl)
    rlg, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(tok[:, :40]),
                                 positions=jnp.asarray(pos), caches=rcaches,
                                 impl=impl, remat=False)
    _close(lg, rlg, "prefill logits")
    for t in range(40, 43):
        lengths = np.full((2,), t, np.int32)
        lg, caches = T.decode_step(prm, cfg, torch.tensor(tok[:, t:t + 1]),
                                   torch.tensor(lengths), caches)
        rlg, rcaches = RT.decode_step(rprm, rcfg, jnp.asarray(tok[:, t:t + 1]),
                                      jnp.asarray(lengths), rcaches)
        _close(lg, rlg, f"decode logits at {t}")
        _close(lg[:, 0], full[:, t], f"decode vs full forward at {t}",
               tol=5e-3)
    sub, rsub = (c["stage0"]["sub0"]["ssm_cache"] for c in (caches, rcaches))
    for name in ("ssm", "conv"):
        assert tuple(sub[name].shape) == rsub[name].shape
        _close(sub[name], rsub[name], f"{name} states after decode")


def test_right_padded_prefill_then_decode_gives_reference_logits(model):
    """The engine's prefill: 10 real tokens right-padded to a bucket of
    16 with negative pad positions.  The port's kernel route
    (impl="pallas_ssd") against the reference's engine route (its XLA
    path): the real rows, both cache entries (which have run through
    the 6 pads, as the reference's do) and three decode steps."""
    rcfg, rprm, cfg, prm = model
    t, bucket = 10, 16
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, :t] = np.random.default_rng(9).integers(0, cfg.vocab_size, t)
    pos = np.where(np.arange(bucket) < t, np.arange(bucket),
                   -(np.arange(bucket) - t + 1)).astype(np.int32)[None]
    caches = T.init_caches(cfg, 1, 64, device="cpu")
    rcaches = RT.init_caches(rcfg, 1, 64)
    lg, caches, _ = T.forward(prm, cfg, torch.tensor(prompt),
                              positions=torch.tensor(pos), caches=caches,
                              impl="pallas_ssd")
    rlg, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(prompt),
                                 positions=jnp.asarray(pos), caches=rcaches,
                                 remat=False)
    _close(lg[0, :t], rlg[0, :t], "real rows")
    sub, rsub = (c["stage0"]["sub0"]["ssm_cache"] for c in (caches, rcaches))
    for name in ("ssm", "conv"):
        _close(sub[name], rsub[name], f"{name} state after the pads")
    # the conv state is the bucket's last 3 inputs: pads, not prompt
    clean = T.init_caches(cfg, 1, 64, device="cpu")
    T.forward(prm, cfg, torch.tensor(prompt[:, :t]),
              positions=torch.tensor(pos[:, :t]), caches=clean)
    assert not torch.allclose(
        clean["stage0"]["sub0"]["ssm_cache"]["ssm"], sub["ssm"])
    nxt = int(torch.argmax(lg[0, t - 1]))
    assert nxt == int(jnp.argmax(rlg[0, t - 1]))
    for i in range(3):
        lengths = np.array([t + i], np.int32)
        d, caches = T.decode_step(prm, cfg, torch.tensor([[nxt]]),
                                  torch.tensor(lengths), caches)
        rd, rcaches = RT.decode_step(rprm, rcfg, jnp.asarray([[nxt]]),
                                     jnp.asarray(lengths), rcaches)
        _close(d, rd, f"decode step {i}")
        nxt = int(torch.argmax(d[0, 0]))


def test_params_have_the_reference_keys_and_shapes():
    """Smoke and full width: the port's tree (drawn at the smoke size,
    declared at full width) has the reference's keys and shapes; the
    full-width count is the reference tree's, 520,192 above the analytic
    `param_count` (conv_b and the embedding's vocab padding)."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    cfg = registry.get_smoke_config(ARCH)
    prm = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), RP.abstract_params(
        rregistry.get_smoke_config(ARCH)))
    assert shapes(prm) == want
    full, rfull = registry.get_config(ARCH), rregistry.get_config(ARCH)
    want = jax.tree.map(lambda a: tuple(a.shape), RP.abstract_params(rfull))
    assert shapes(P.model_defs(full)) == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == 1_344_052_224
    from repro_torch.models import config
    assert config.param_count(full) == 1_343_532_032
    assert n - config.param_count(full) == 48 * 4352 + 152 * 2048


def test_a_log_and_dt_bias_draws_fall_in_their_ranges():
    cfg = registry.get_smoke_config(ARCH)
    prm = P.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    mp = prm["stages"]["stage0"]["sub0"]["mamba"]
    a = torch.exp(mp["a_log"])                          # A in [1, 16)
    assert float(a.min()) >= 1.0 and float(a.max()) < 16.0 + 1e-4
    dt = torch.nn.functional.softplus(mp["dt_bias"])    # dt in [1e-3, 1e-1)
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) < 0.1 + 1e-6
    assert float(a.std()) > 1.0 and float(dt.std()) > 0.01  # drawn, spread
    assert torch.equal(mp["d_skip"], torch.ones_like(mp["d_skip"]))
    assert torch.equal(mp["conv_b"], torch.zeros_like(mp["conv_b"]))
    std = float(mp["conv_w"].std())                     # fan-in K = 4
    assert abs(std - 0.5) < 0.05
