"""The port's model stack (`repro_torch.models`) against the JAX reference
on the CPU, in float32, at the smoke sizes.

Weights are the reference's, handed over with `params.from_reference`,
so both compute the same function.  Forward logits are held to 1e-4
(the same float32 arithmetic through 2-4 layers in another order; the
measured gap is under 1e-5 on logits of order 1-4); prefill + decode
against the full forward keeps the reference's own tolerances
(tests/test_models_decode.py: 2e-3 prefill, 5e-3 decode, 1e-4 for the
ring-buffer cases).  Every architecture id runs here: whisper-medium
with its encoder's output (``enc_out``) and internvl2-2b with its
frontend rows, both from `_torch_port.modality_inputs`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import config as rconfig, layers as RL, params as RP
from repro.models import transformer as RT
from repro_torch.configs import registry
from repro_torch.models import config, layers as L, params as P
from repro_torch.models import transformer as T
from _torch_port import modality_inputs, uncounted_params
from _torch_port import single_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(1)
ARCHS = registry.PORTED_IDS


def _tiny(mod, **kw):
    opts = dict(name="tiny", family="dense", d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                dtype="float32")
    window = kw.pop("window", 0)
    opts.update(kw)
    return mod.ModelConfig(stages=mod.uniform_stages(
        2, mod.LayerSpec(kind="attn", window=window)), **opts)


def _cfgs(arch):
    """(reference config, port config) of a smoke arch or a tiny one."""
    if arch == "tiny_gqa":   # 4 q heads on 2 kv heads, head dim 8
        return _tiny(rconfig), _tiny(config)
    if arch == "tiny_swa":   # tests/test_models_decode.py::_tiny_window_cfg
        kw = dict(num_heads=2, num_kv_heads=1, head_dim=16, window=8)
        return _tiny(rconfig, **kw), _tiny(config, **kw)
    return rregistry.get_smoke_config(arch), registry.get_smoke_config(arch)


def _params(rcfg):
    prm = RP.init_params(rcfg, KEY)
    return prm, P.from_reference(jax.tree.map(np.asarray, prm), device="cpu")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _extras(rcfg, rprm, cfg, prm, b, seed=0):
    """The modality inputs of both models' `forward` as keyword
    arguments: ``frontend`` as given, ``enc_out`` from each package's own
    `encode` of the same frames."""
    x = modality_inputs(cfg, b, seed)
    want, got = {}, {}
    if "frontend" in x:
        want["frontend"] = jnp.asarray(x["frontend"])
        got["frontend"] = torch.tensor(x["frontend"])
    if "frames" in x:
        want["enc_out"] = RT.encode(rprm, rcfg, jnp.asarray(x["frames"]))
        got["enc_out"] = T.encode(prm, cfg, torch.tensor(x["frames"]))
    return want, got


@pytest.mark.parametrize("arch", ARCHS + ("tiny_gqa",))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_reference(arch, impl):
    rcfg, cfg = _cfgs(arch)
    rprm, prm = _params(rcfg)
    tok = _tokens(cfg, 2, 12)
    rx, x = _extras(rcfg, rprm, cfg, prm, 2)
    want, _, want_aux = RT.forward(rprm, rcfg, jnp.asarray(tok), impl=impl,
                                   remat=False, **rx)
    got, caches, aux = T.forward(prm, cfg, torch.tensor(tok), impl=impl,
                                 **x)
    # the MoE aux (0 without an MoE layer) within 1e-6 relative: float32
    # router products summed in another order
    assert caches is None and aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * max(
        1.0, abs(float(want_aux)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS + ("tiny_gqa",))
def test_prefill_decode_matches_full(arch):
    """tests/test_models_decode.py::test_prefill_decode_matches_full on
    the port, plus each decode step against the reference's."""
    rcfg, cfg = _cfgs(arch)
    rprm, prm = _params(rcfg)
    b, t0, tpre = 2, 12, 8
    tok = _tokens(cfg, b, t0, seed=1)
    # the reference's test: an encoder-decoder's enc_out, no frontend
    rx, x = _extras(rcfg, rprm, cfg, prm, b)
    rx.pop("frontend", None)
    x.pop("frontend", None)
    full, _, _ = T.forward(prm, cfg, torch.tensor(tok), **x)
    caches = T.init_caches(cfg, b, max_len=32, device="cpu")
    rcaches = RT.init_caches(rcfg, b, max_len=32)
    pos = np.broadcast_to(np.arange(tpre, dtype=np.int32), (b, tpre))
    pre, caches, _ = T.forward(prm, cfg, torch.tensor(tok[:, :tpre]),
                               positions=torch.tensor(pos), caches=caches,
                               **x)
    _, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(tok[:, :tpre]),
                               positions=jnp.asarray(pos), caches=rcaches,
                               remat=False, **rx)
    np.testing.assert_allclose(pre.numpy(), full[:, :tpre].numpy(),
                               atol=2e-3, rtol=2e-3)
    rstep = jax.jit(lambda t, n, c: RT.decode_step(rprm, rcfg, t, n, c))
    for t in range(tpre, t0):
        lengths = np.full((b,), t, np.int32)
        lg, caches = T.decode_step(prm, cfg, torch.tensor(tok[:, t:t + 1]),
                                   torch.tensor(lengths), caches)
        rlg, rcaches = rstep(jnp.asarray(tok[:, t:t + 1]),
                             jnp.asarray(lengths), rcaches)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("t0,tpre", [(24, 4), (28, 24)],
                         ids=["decode_past_window", "prefill_past_window"])
def test_ring_buffer_window_cache_matches_full(t0, tpre):
    """The reference's ring-buffer tests on the port: decode far past the
    window, and prefill 3x the window through the ring, then decode."""
    rcfg, cfg = _cfgs("tiny_swa")
    _, prm = _params(rcfg)
    tok = torch.tensor(_tokens(cfg, 1, t0, seed=2))
    full, _, _ = T.forward(prm, cfg, tok)
    caches = T.init_caches(cfg, 1, max_len=t0, device="cpu")
    assert caches["stage0"]["sub0"]["kv"]["k"].shape[3] == 8  # the window
    pos = torch.arange(tpre, dtype=torch.int32)[None]
    _, caches, _ = T.forward(prm, cfg, tok[:, :tpre], positions=pos,
                             caches=caches)
    for t in range(tpre, t0):
        lg, caches = T.decode_step(prm, cfg, tok[:, t:t + 1],
                                   torch.full((1,), t, dtype=torch.int32),
                                   caches)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)])
def test_mha_chunked_matches_reference(causal, window):
    """The query-chunked plain attention (the path above 8192 queries),
    at a small block so that it takes several blocks, a ragged last one
    and window-limited K/V slices: equal to the reference's chunked
    path and to one unchunked product."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 4, 40, 8)).astype(np.float32)
    k = rng.normal(size=(1, 2, 40, 8)).astype(np.float32)
    v = rng.normal(size=(1, 2, 40, 8)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None]
    opts = dict(causal=causal, window=window, softcap=0.0, scale=0.3)
    got = L.mha_chunked(*(torch.tensor(x) for x in (q, k, v, pos, pos)),
                        block_q=16, **opts)
    want = RL.mha_chunked(*(jnp.asarray(x) for x in (q, k, v, pos, pos)),
                          block_q=16, **opts)
    whole = L.mha_xla(*(torch.tensor(x) for x in (q, k, v, pos, pos)),
                      **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("stacked", [True, False])
def test_commit_kv_matches_reference(stacked):
    """Negative (padding) positions, a ring wrap and T > S: the port's
    cache equals the reference's entry for entry."""
    rng = np.random.default_rng(3)
    lead = (2,) if stacked else ()
    s = 8
    cache = {"k": rng.normal(size=lead + (2, 1, s, 4)).astype(np.float32),
             "v": rng.normal(size=lead + (2, 1, s, 4)).astype(np.float32),
             "pos": rng.integers(-1, 5, lead + (2, s)).astype(np.int32)}
    for positions in (np.array([[0, 1, 2, -1, -2, -3], [5, 6, 7, 8, 9, 10]]),
                      np.array([np.arange(-3, 7), np.arange(10, 20)])):
        positions = positions.astype(np.int32)
        t = positions.shape[1]
        kn = rng.normal(size=lead + (2, 1, t, 4)).astype(np.float32)
        vn = rng.normal(size=lead + (2, 1, t, 4)).astype(np.float32)
        want = RL.commit_kv({k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(positions))
        got = L.commit_kv({k: torch.tensor(v) for k, v in cache.items()},
                          torch.tensor(kn), torch.tensor(vn),
                          torch.tensor(positions))
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_right_padded_prefill_kernel_route_equals_plain(arch):
    """The engine's prefill: a right-padded prompt with negative pad
    positions.  The real rows of the kernel route (impl="pallas": the
    kernel's index mask; impl="pallas_ssd" for Mamba layers: the SSD
    kernel's plain version) equal those of impl="xla" (the position
    mask; the chunked SSD), and so does the decode after each, though
    the pad rows differ.  As in the engine, no frames or frontend: an
    encoder-decoder attends over the all-zero cross cache."""
    _, cfg = _cfgs(arch)
    _, prm = _params(_cfgs(arch)[0])
    t, bucket = 10, 16
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, :t] = _tokens(cfg, 1, t, seed=4)[0]
    pos = np.where(np.arange(bucket) < t, np.arange(bucket),
                   -(np.arange(bucket) - t + 1)).astype(np.int32)[None]
    kernel = "pallas_ssd" if cfg.ssm is not None else "pallas"
    out = {}
    for impl in ("xla", kernel):
        caches = T.init_caches(cfg, 1, 32, device="cpu")
        lg, caches, _ = T.forward(prm, cfg, torch.tensor(prompt),
                                  positions=torch.tensor(pos), caches=caches,
                                  impl=impl)
        steps = []
        nxt = int(torch.argmax(lg[0, t - 1]))
        for i in range(3):
            d, caches = T.decode_step(prm, cfg, torch.tensor([[nxt]]),
                                      torch.tensor([t + i]), caches)
            steps.append(d[0, 0])
            nxt = int(torch.argmax(d[0, 0]))
        out[impl] = (lg[0, :t], torch.stack(steps))
    for a, b in zip(out["xla"], out[kernel]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_params_mirror_reference_layout():
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch)
        ref_tree = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                RP.abstract_params(rcfg))
        prm = P.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                           prm)
        assert got == ref_tree, arch
        assert P.count_params(prm) == config.param_count(cfg) \
            + uncounted_params(cfg), arch
    # the full-width configs: the same analytic counts (chatglm3-6b 6.24 B)
    for arch in ARCHS:
        assert config.param_count(registry.get_config(arch)) == \
            rconfig.param_count(rregistry.get_config(arch))
    assert round(config.param_count(registry.get_config("chatglm3_6b"))
                 / 1e9, 2) == 6.24


def test_init_params_rules_and_seed():
    _, cfg = _cfgs("chatglm3_6b")
    a = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = P.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    sub = a["stages"]["stage0"]["sub0"]
    assert torch.equal(sub["ln1_scale"], torch.ones_like(sub["ln1_scale"]))
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    wq = sub["attn"]["wq"]                       # fan-in d_model
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    bf = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype="bfloat16")
    assert bf["embed"].dtype == torch.bfloat16


def test_unported_archs_raise_naming_the_roadmap():
    """No id is left unported: every id and alias resolves, exact and
    smoke, to the reference's config field for field (the name kept from
    when three ids raised); `all_configs` has all ten; an unknown id
    raises `KeyError`."""
    assert registry.PORTED_IDS == registry.ARCH_IDS == rregistry.ARCH_IDS
    assert registry.ALIASES == rregistry.ALIASES
    for arch in registry.ARCH_IDS + tuple(registry.ALIASES):
        for get in ("get_config", "get_smoke_config"):
            got = getattr(registry, get)(arch)
            want = getattr(rregistry, get)(arch)
            assert repr(got) == repr(want), (arch, get)
            P.check_supported(got)
    assert list(registry.all_configs()) == list(rregistry.all_configs())
    assert len(registry.all_configs()) == 10
    assert registry.get_config("chatglm3-6b").name == "chatglm3-6b"
    with pytest.raises(KeyError):
        registry.get_config("gpt2")
    with pytest.raises(KeyError):
        registry.get_smoke_config("gpt2")
