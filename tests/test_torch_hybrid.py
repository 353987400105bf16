"""jamba-1.5-large's hybrid stack in the port against the JAX reference on
the CPU, float32, at its smoke config (one block of eight sub-layers:
Mamba-2 at 0-3 and 5-7, attention at 4, a 16-expert top-2 MoE MLP at
every odd position; d_model 128, head dim 8, SSD state 8 and head dim
8, chunk 32), the weights handed over with `params.from_reference`:

  * `forward` under every ``impl`` within 1e-4, its MoE aux within 1e-6
    relative; the two model kernels stay exclusive, as in the reference:
    ``"pallas"`` runs flash attention (its plain version here) with the
    plain chunked SSD, ``"pallas_ssd"`` the SSD kernel with plain
    attention, ``"xla"`` neither;
  * `init_caches`: each sub-layer's kind of cache in one stage, the
    reference's shapes;
  * a prefill then decode steps against the full forward (the
    reference's 2e-3 / 5e-3) and the reference's decode (1e-4);
  * `lm_loss` (ce, the MoE aux, the total) within 1e-5 relative and
    every gradient within 1e-4 of its largest magnitude;
  * the serving engine (prefill through the SSD kernel's plain version)
    against the reference's engine (its XLA prefill), token for token.

Three train steps are held in tests/test_torch_hybrid_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import params as RP, transformer as RT
from repro.serve import engine as rengine
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import params as P, transformer as T
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "jamba15_large"


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = rregistry.get_smoke_config(ARCH), \
        registry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(6))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, cfg, prm


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def test_smoke_config_is_the_hybrid_block(model):
    _, _, cfg, prm = model
    (stage,) = cfg.stages
    assert stage.repeats == 1 and len(stage.block) == 8
    assert [s.kind for s in stage.block] == ["mamba"] * 4 + ["attn"] \
        + ["mamba"] * 3
    assert [s.moe for s in stage.block] == [i % 2 == 1 for i in range(8)]
    sub = prm["stages"]["stage0"]
    assert "mamba" in sub["sub0"] and "attn" in sub["sub4"]
    assert "moe" in sub["sub1"] and "mlp" in sub["sub0"]


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_ssd"])
def test_forward_matches_reference_with_exclusive_kernels(model, impl,
                                                          monkeypatch):
    rcfg, rprm, cfg, prm = model
    calls = {"flash_attention": 0, "ssd": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    tok = _tokens(cfg, 2, 40, seed=9)    # two SSD chunks of 32, one ragged
    want, _, want_aux = RT.forward(rprm, rcfg, jnp.asarray(tok), impl=impl,
                                   remat=False)
    got, caches, aux = T.forward(prm, cfg, torch.tensor(tok), impl=impl)
    assert caches is None
    _close(got, want, 1e-4)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert calls == {"xla": {"flash_attention": 0, "ssd": 0},
                     "pallas": {"flash_attention": 1, "ssd": 0},
                     "pallas_ssd": {"flash_attention": 0, "ssd": 7}}[impl]


def test_init_caches_hold_both_kinds(model):
    rcfg, _, cfg, _ = model
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        RT.init_caches(rcfg, 2, 24))
    got = T.init_caches(cfg, 2, 24, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        got) == want
    stage = got["stage0"]
    assert sorted(stage["sub4"]) == ["kv"]
    assert all(sorted(stage[f"sub{i}"]) == ["ssm_cache"]
               for i in (0, 1, 2, 3, 5, 6, 7))


@pytest.mark.parametrize("impl", ["pallas", "pallas_ssd"])
def test_prefill_decode_matches_full_and_reference(model, impl):
    rcfg, rprm, cfg, prm = model
    b, t0, tpre = 2, 12, 8
    tok = _tokens(cfg, b, t0, seed=10)
    full, _, _ = T.forward(prm, cfg, torch.tensor(tok))
    caches = T.init_caches(cfg, b, 32, device="cpu")
    rcaches = RT.init_caches(rcfg, b, 32)
    pos = np.broadcast_to(np.arange(tpre, dtype=np.int32), (b, tpre))
    pre, caches, _ = T.forward(prm, cfg, torch.tensor(tok[:, :tpre]),
                               positions=torch.tensor(pos), caches=caches,
                               impl=impl)
    _, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(tok[:, :tpre]),
                               positions=jnp.asarray(pos), caches=rcaches,
                               remat=False)
    _close(pre, full[:, :tpre], 2e-3)
    rstep = jax.jit(lambda t, n, c: RT.decode_step(rprm, rcfg, t, n, c))
    for t in range(tpre, t0):
        lengths = np.full((b,), t, np.int32)
        lg, caches = T.decode_step(prm, cfg, torch.tensor(tok[:, t:t + 1]),
                                   torch.tensor(lengths), caches)
        rlg, rcaches = rstep(jnp.asarray(tok[:, t:t + 1]),
                             jnp.asarray(lengths), rcaches)
        _close(lg[:, 0], full[:, t], 5e-3)
        _close(lg, rlg, 1e-4)


def test_lm_loss_and_grads_match_reference(model):
    rcfg, rprm, cfg, prm = model
    rng = np.random.default_rng(11)
    tok = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][1, -4:] = -1
    (want, wmet), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, b, remat=True), has_aux=True))(
        rprm, batch)
    prm = P.tree_map(lambda x: x.clone().requires_grad_(True), prm)
    leaves = P.tree_leaves(prm)
    loss, met = T.lm_loss(prm, cfg, {k: torch.tensor(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for got, w in ((loss.detach(), want), (met["ce"].detach(), wmet["ce"]),
                   (met["moe_aux"].detach(), wmet["moe_aux"])):
        assert abs(float(got) - float(w)) <= 1e-5 * abs(float(w))
    assert float(met["moe_aux"].detach()) > 0
    assert int(met["ntokens"]) == int(wmet["ntokens"]) == 2 * 16 - 4
    for g, w in zip(grads, jax.tree.leaves(wgrad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_engine_generates_the_reference_tokens(model):
    rcfg, rprm, cfg, prm = model
    ecfg = dict(num_replicas=2, replicas_per_pod=1, slots_per_replica=2,
                max_len=64, prefill_buckets=(16, 32))
    lengths = (9, 27, 14, 20)

    def requests(cls):
        rng = np.random.default_rng(12)
        return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               n).astype(np.int32),
                    max_new_tokens=4, prefix_id=i)
                for i, n in enumerate(lengths)]

    ref = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(**ecfg))
    want = ref.run_until_drained(requests(rengine.Request), max_steps=100)
    eng = ServingEngine(cfg, prm, EngineConfig(**ecfg), device="cpu")
    assert all(rep.prefill_impl == "pallas_ssd" for rep in eng.replicas)
    got = eng.run_until_drained(requests(Request), max_steps=100)
    for r, w in zip(got, want):
        assert len(r.generated) == 5
        assert r.generated == w.generated, f"request {r.rid}"
