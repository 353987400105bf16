"""whisper-medium's encoder-decoder in the port against the JAX reference
on the CPU, float32, at its smoke config (2 + 2 layers, d_model 128,
LayerNorm, plain GELU, learned positions, 16 stub frames), the weights
handed over with `params.from_reference`:

  * `encode`, `encode_cross_kv` and `cross_attention` within 1e-5;
  * `forward` with ``enc_out`` under every ``impl`` within 1e-4 (the
    encoder and cross-attention take the plain path under each, the
    decoder's causal self-attention the kernel's plain version under
    ``"pallas"``);
  * `init_caches` with ``enc_len``: the reference's shapes, and cross
    ``k`` and ``v`` as two tensors (the port writes caches in place: one
    shared tensor would hold only the last write);
  * a prefill given ``enc_out`` then decode steps reading the cached
    cross K/V, against the full forward (the reference's 2e-3 / 5e-3)
    and the reference's decode (1e-4);
  * learned positions: negative pad positions wrap as in the reference.

`lm_loss` with ``frames`` and its gradients, and three train steps, are
held in tests/test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import layers as RL, params as RP, transformer as RT
from repro_torch.configs import registry
from repro_torch.models import layers as L, params as P, transformer as T
from _torch_port import modality_inputs
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "whisper_medium"


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = rregistry.get_smoke_config(ARCH), \
        registry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(2))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    frames = modality_inputs(cfg, 2, seed=3)["frames"]
    return rcfg, rprm, cfg, prm, frames


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_smoke_config_is_the_encoder_decoder(model):
    _, _, cfg, prm, frames = model
    assert cfg.is_encdec and cfg.norm == "layernorm" and cfg.act == "gelu"
    assert cfg.learned_pos == 4096 and cfg.num_audio_frames == 16
    assert frames.shape == (2, 16, cfg.d_model)
    sub = prm["stages"]["stage0"]["sub0"]
    assert sorted(k for k in sub["attn"] if k.startswith("x")) == \
        ["xk", "xo", "xq", "xv"]
    assert "ln_cross_scale" in sub and "ln_cross_bias" in sub
    assert prm["pos_embed"].shape == (4096, cfg.d_model)
    assert prm["enc_pos_embed"].shape == (16, cfg.d_model)
    assert "enc_final_bias" in prm and "stage0" in prm["enc_stages"]


def test_encode_matches_reference(model):
    rcfg, rprm, cfg, prm, frames = model
    want = RT.encode(rprm, rcfg, jnp.asarray(frames))
    got = T.encode(prm, cfg, torch.tensor(frames))
    assert got.shape == (2, 16, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, 1e-5)
    # remat changes no value; without autograd it is not taken at all
    with torch.no_grad():
        _close(T.encode(prm, cfg, torch.tensor(frames)), want, 1e-5)


def test_cross_attention_matches_reference(model):
    rcfg, rprm, cfg, prm, frames = model
    enc = RT.encode(rprm, rcfg, jnp.asarray(frames))
    tenc = torch.tensor(np.asarray(enc))
    rlp = jax.tree.map(lambda a: a[0], rprm["stages"]["stage0"]["sub0"])
    lp = {"attn": {k: v[0] for k, v in
                   prm["stages"]["stage0"]["sub0"]["attn"].items()}}
    rk, rv = RL.encode_cross_kv(rlp, rcfg, enc)
    k, v = L.encode_cross_kv(lp, cfg, tenc)
    assert k.shape == (2, cfg.num_kv_heads, 16, cfg.head_dim)
    _close(k, rk, 1e-5)
    _close(v, rv, 1e-5)
    x = np.random.default_rng(4).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    want = RL.cross_attention(rlp, rcfg, jnp.asarray(x), (rk, rv))
    got = L.cross_attention(lp, cfg, torch.tensor(x), (k, v))
    _close(got, want, 1e-5)
    # the scale is head_dim ** -0.5 whatever cfg.attn_scale says
    other = dataclasses.replace(cfg, attn_scale=1.0)
    _close(L.cross_attention(lp, other, torch.tensor(x), (k, v)), want, 1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_ssd"])
def test_forward_matches_reference(model, impl):
    rcfg, rprm, cfg, prm, frames = model
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    renc = RT.encode(rprm, rcfg, jnp.asarray(frames))
    want, _, _ = RT.forward(rprm, rcfg, jnp.asarray(tok), enc_out=renc,
                            impl=impl, remat=False)
    got, caches, aux = T.forward(prm, cfg, torch.tensor(tok),
                                 enc_out=T.encode(prm, cfg,
                                                  torch.tensor(frames)),
                                 impl=impl)
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 12, cfg.padded_vocab)
    _close(got, want, 1e-4)


def test_forward_needs_enc_out_or_a_cache(model):
    _, _, cfg, prm, _ = model
    with pytest.raises(ValueError, match="enc_out"):
        T.forward(prm, cfg, torch.zeros((1, 4), dtype=torch.int32))


def test_init_caches_shapes_with_enc_len(model):
    rcfg, _, cfg, _, _ = model
    for enc_len in (0, 24):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            RT.init_caches(rcfg, 3, 32, enc_len=enc_len))
        got = T.init_caches(cfg, 3, 32, device="cpu", enc_len=enc_len)
        assert jax.tree.map(lambda a: (tuple(a.shape),
                                       str(a.dtype)[6:]), got) == want
        meta = T.abstract_caches(cfg, 3, 32, enc_len=enc_len)
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                            meta) == want
        assert {a.device.type for a in jax.tree.leaves(meta)} == {"meta"}
        cross = got["stage0"]["sub0"]["cross"]
        assert cross["k"].shape[3] == (enc_len or cfg.num_audio_frames)
        assert cross["k"].data_ptr() != cross["v"].data_ptr()
        assert not cross["k"].any() and not cross["v"].any()


def test_prefill_writes_distinct_cross_k_and_v(model):
    """After a prefill the cache holds each layer's cross K and V as
    `encode_cross_kv` makes them.  Were the two one tensor (the
    reference's single zeros array, written in place), both would read
    V."""
    _, _, cfg, prm, frames = model
    enc = T.encode(prm, cfg, torch.tensor(frames))
    caches = T.init_caches(cfg, 2, 32, device="cpu")
    tok = torch.zeros((2, 4), dtype=torch.int32)
    T.forward(prm, cfg, tok, enc_out=enc, caches=caches)
    st = prm["stages"]["stage0"]
    cross = caches["stage0"]["sub0"]["cross"]
    for r in range(cfg.stages[0].repeats):
        lp = {"attn": {k: v[r] for k, v in st["sub0"]["attn"].items()}}
        k, v = L.encode_cross_kv(lp, cfg, enc)
        assert torch.equal(cross["k"][r], k) and torch.equal(cross["v"][r], v)
        assert not torch.equal(k, v)


def test_prefill_decode_matches_full_and_reference(model):
    rcfg, rprm, cfg, prm, frames = model
    b, t0, tpre = 2, 12, 8
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                            (b, t0)).astype(np.int32)
    renc = RT.encode(rprm, rcfg, jnp.asarray(frames))
    enc = T.encode(prm, cfg, torch.tensor(frames))
    full, _, _ = T.forward(prm, cfg, torch.tensor(tok), enc_out=enc)
    caches = T.init_caches(cfg, b, 32, device="cpu")
    rcaches = RT.init_caches(rcfg, b, 32)
    pos = np.broadcast_to(np.arange(tpre, dtype=np.int32), (b, tpre))
    pre, caches, _ = T.forward(prm, cfg, torch.tensor(tok[:, :tpre]),
                               positions=torch.tensor(pos), caches=caches,
                               enc_out=enc, impl="pallas")
    rpre, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(tok[:, :tpre]),
                                  positions=jnp.asarray(pos), caches=rcaches,
                                  enc_out=renc, remat=False)
    _close(pre, full[:, :tpre], 2e-3)
    _close(pre, rpre, 1e-4)
    _close(caches["stage0"]["sub0"]["cross"]["k"],
           rcaches["stage0"]["sub0"]["cross"]["k"], 1e-5)
    rstep = jax.jit(lambda t, n, c: RT.decode_step(rprm, rcfg, t, n, c))
    for t in range(tpre, t0):
        lengths = np.full((b,), t, np.int32)
        lg, caches = T.decode_step(prm, cfg, torch.tensor(tok[:, t:t + 1]),
                                   torch.tensor(lengths), caches)
        rlg, rcaches = rstep(jnp.asarray(tok[:, t:t + 1]),
                             jnp.asarray(lengths), rcaches)
        _close(lg[:, 0], full[:, t], 5e-3)
        _close(lg, rlg, 1e-4)


def test_learned_positions_wrap_negative_pads(model):
    """The engine's right padding gives pad rows negative positions:
    ``pos_embed[-k]`` reads row S - k in both packages."""
    rcfg, rprm, cfg, prm, _ = model
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4, -1, -2, -3]], np.int32)
    caches = T.init_caches(cfg, 1, 16, device="cpu")
    rcaches = RT.init_caches(rcfg, 1, 16)
    got, _, _ = T.forward(prm, cfg, torch.tensor(tok),
                          positions=torch.tensor(pos), caches=caches)
    want, _, _ = RT.forward(rprm, rcfg, jnp.asarray(tok),
                            positions=jnp.asarray(pos), caches=rcaches,
                            remat=False)
    _close(got, want, 1e-4)
