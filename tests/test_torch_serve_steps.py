"""The port's `launch.steps.build_prefill_step` and `build_serve_step`
against the reference's on a one-device CPU mesh, float32, at the smoke
configs of whisper-medium (frames encoded first), internvl2-2b (frontend
rows before the text), jamba-1.5-large (the hybrid), chatglm3-6b and
mamba2-1.3b, the weights handed over with `params.from_reference`:

  * the abstract parameters, caches and batch: the reference's shapes
    and dtypes;
  * a prefill of B 2 into caches of ``plan.max_len`` slots, then four
    serve steps: the last row's logits within the reference's 2e-3 and
    each step's logits within 5e-3 (tests/test_models_decode.py; measured
    under 1e-5), the next tokens equal and each the argmax of its
    step's logits; the prefill equal to the `forward` it wraps (after
    `encode`), bit for bit;
  * the prefill goes through the model's kernel route (``"pallas_ssd"``
    with a Mamba layer, else ``"pallas"``), as the engine's does;
  * a serve step past the learned-position table is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry, runtime as rruntime
from repro.launch import mesh as rmesh, steps as rsteps
from repro.models import params as RP
from repro_torch.configs import registry, runtime
from repro_torch.launch import steps as S
from repro_torch.models import params as P, transformer as T
from _torch_port import modality_inputs
from _torch_port import single_torch_thread  # noqa: F401

ARCHS = ("whisper_medium", "internvl2_2b", "jamba15_large", "chatglm3_6b",
         "mamba2_13b")
B, SEQ, MAX_LEN, STEPS = 2, 16, 40, 4


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                   .replace("torch.", "")), tree)


def _batch(cfg, seed):
    """A prefill batch of `SEQ` stream rows (text after the frontend
    rows), as the reference's `input_specs` shapes it."""
    x = modality_inputs(cfg, B, seed)
    n_text = SEQ - (cfg.num_frontend_tokens if "frontend" in x else 0)
    x["tokens"] = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n_text)).astype(np.int32)
    return x


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    rcfg, cfg = rregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    mesh = rmesh.make_test_mesh((1, 1), ("data", "model"))
    rplan = dataclasses.replace(rruntime.plan_for(
        rcfg, "prefill_32k", "prefill", dp_axes=("data",)), max_len=MAX_LEN)
    plan = dataclasses.replace(runtime.plan_for(cfg, "prefill_32k",
                                                "prefill"), max_len=MAX_LEN)
    rpre, rabs, _ = rsteps.build_prefill_step(rcfg, mesh, rplan, B, SEQ)
    rserve, rsabs, _ = rsteps.build_serve_step(rcfg, mesh, rplan, B, MAX_LEN)
    pre, pabs = S.build_prefill_step(cfg, plan, B, SEQ, device="cpu")
    serve, sabs = S.build_serve_step(cfg, plan, B, MAX_LEN, device="cpu")
    for got, want in ((pabs, rabs), (sabs, rsabs)):
        assert _shapes(got[0]) == _shapes(want[0])
        assert _shapes(got[1]) == _shapes(want[1])
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got[2].items()} == _shapes(want[2])

    with mesh:
        rprm = RP.init_params(rcfg, jax.random.PRNGKey(7))
        rcaches = jax.tree.map(jnp.zeros_like, rabs[1])
        rcaches = jax.tree.map(
            lambda a: a - 1 if a.dtype == jnp.int32 else a, rcaches)
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    caches = T.init_caches(cfg, B, MAX_LEN, device="cpu")
    batch = _batch(cfg, seed=8)
    with mesh:
        want, rcaches = rpre(rprm, rcaches,
                             jax.tree.map(jnp.asarray, batch))
    got, caches = pre(prm, caches, batch)
    assert got.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)

    # the prefill is `forward` through the kernel route, the encoder first
    impl = "pallas_ssd" if cfg.ssm is not None else "pallas"
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    enc = T.encode(prm, cfg, tb["frames"], impl=impl) if cfg.is_encdec \
        else None
    full, _, _ = T.forward(prm, cfg, tb["tokens"],
                           frontend=tb.get("frontend"), enc_out=enc,
                           caches=T.init_caches(cfg, B, MAX_LEN,
                                                device="cpu"),
                           impl=impl)
    assert torch.equal(full[:, -1], got)

    nxt = torch.argmax(got, -1).to(torch.int32)
    for i in range(STEPS):
        lengths = np.full((B,), SEQ + i, np.int32)
        step = {"tokens": nxt[:, None].numpy(), "lengths": lengths}
        with mesh:
            rtok, rlg, rcaches = rserve(rprm, rcaches,
                                        jax.tree.map(jnp.asarray, step))
        tok, lg, caches = serve(prm, caches, step)
        assert tok.dtype == torch.int32 and lg.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), atol=5e-3,
                                   rtol=5e-3)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        assert torch.equal(tok, torch.argmax(lg, -1).to(torch.int32))
        nxt = tok


def test_serve_step_refuses_a_cache_past_the_learned_positions():
    cfg = registry.get_config("whisper_medium")
    plan = runtime.plan_for(cfg, "decode_32k", "decode")
    _, (_, acaches, abatch) = S.build_serve_step(cfg, plan, 4, 32_768,
                                                 device="cpu")
    kv = acaches["stage0"]["sub0"]
    assert kv["kv"]["k"].shape == (24, 4, 16, 32_768, 64)
    assert kv["cross"]["k"].shape == (24, 4, 16, 1500, 64)
    assert abatch["tokens"].shape == (4, 1)
    with pytest.raises(ValueError, match="learned-position table"):
        S.build_serve_step(cfg, plan, 4, cfg.learned_pos + 1, device="cpu")


def test_prefill_caches_follow_the_plan_max_len():
    """`plan.max_len` sizes the prefill's caches; 0 (the plans'
    default, as in the reference) leaves them at the sequence length."""
    cfg = registry.get_smoke_config("internvl2_2b")
    plan = runtime.plan_for(cfg, "prefill_32k", "prefill")
    assert plan.max_len == 0 and plan.remat
    for max_len, want in ((0, SEQ), (MAX_LEN, MAX_LEN)):
        _, (_, acaches, abatch) = S.build_prefill_step(
            cfg, dataclasses.replace(plan, max_len=max_len), B, SEQ,
            device="cpu")
        assert acaches["stage0"]["sub0"]["kv"]["k"].shape[3] == want
        assert abatch["tokens"].shape == (B, SEQ - cfg.num_frontend_tokens)
        assert abatch["frontend"].shape == (B, cfg.num_frontend_tokens,
                                            cfg.d_model)
