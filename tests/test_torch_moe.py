"""The port's MoE (`layers.moe_mlp`, `layers.moe_route`, the MoE
parameters, the aux loss through `forward` and `lm_loss`, the trainer and
the serving launcher at an MoE config) against the JAX reference on the
CPU, at the smoke configs of granite-moe-1b (32 experts, top 8, d 256)
and mixtral-8x22b (8 experts, top 2, d 128).

Inputs are made with numpy from a seed; weights are the reference's,
carried over with `params.from_reference`.  Tolerances:

  * `moe_mlp`'s output: 1e-5 in float32 (the expert products summed in
    another order: the measured gap is under 2e-6), 2e-2 in bf16 (the
    expert outputs and the combine round to bf16 at each step: measured
    0.0117 and 0.0156);
  * the top-k choices and the kept mask bit for bit, on the drop-free
    and the capacity branch; the aux within 1e-6 (float32 router
    products in another order);
  * gradients to x, the router and the three expert weights within 1e-4
    of each one's largest magnitude (float32, `jax.grad` of the same
    scalar), as tests/test_torch_train.py holds the model's.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry, runtime as rruntime
from repro.data.pipeline import DataPipeline as RDataPipeline
from repro.data.pipeline import PipelineConfig as RPipelineConfig
from repro.launch import mesh as rmesh
from repro.models import config as rconfig, layers as RL, params as RP
from repro.models import transformer as RT
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch.configs import registry, runtime
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import serve
from repro_torch.models import config, layers as L, params as P
from repro_torch.models import transformer as T
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_port import single_torch_thread  # noqa: F401

MOE_ARCHS = ("granite_moe_1b", "mixtral_8x22b")
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _capacity(cfg):
    """tests/test_models_decode.py::test_moe_capacity_drops_tokens's
    config: every call on the capacity branch, half the capacity."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, no_drop_threshold=0, capacity_factor=0.5))


@functools.lru_cache(maxsize=None)
def _reference_moe(arch):
    """The reference's MoE parameters of layer 0 at the smoke config
    (float32 numpy)."""
    prm = RP.init_params(rregistry.get_smoke_config(arch),
                         jax.random.PRNGKey(5))
    return jax.tree.map(lambda a: np.asarray(a[0]),
                        prm["stages"]["stage0"]["sub0"]["moe"])


def _layer(arch, branch):
    """(reference cfg, port cfg, reference MoE params of layer 0 (float32),
    the same as port tensors)."""
    rcfg, cfg = rregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    if branch == "capacity":
        rcfg, cfg = _capacity(rcfg), _capacity(cfg)
    moe = _reference_moe(arch)
    return rcfg, cfg, moe, {k: torch.tensor(v) for k, v in moe.items()}


def _reference_route(moe, rcfg, x):
    """The reference's routing of x (n, d), as `repro.models.layers.moe_mlp`
    computes it with one group: top_e by ``jax.lax.top_k`` on the float32
    router logits, the one-hot cumsum ranks, the kept mask."""
    e, k = rcfg.moe.num_experts, rcfg.moe.top_k
    n = x.shape[0]
    logits = jnp.asarray(x).astype(jnp.float32) @ jnp.asarray(
        moe["router"]).astype(jnp.float32)
    _, top_e = jax.lax.top_k(logits, k)
    if n <= rcfg.moe.no_drop_threshold:
        cap = n
    else:
        cap = min(max(8, int(math.ceil(rcfg.moe.capacity_factor * n * k
                                       / e))), n)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    rank = jnp.take_along_axis(ranks, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(top_e), np.asarray(rank < cap), cap


@pytest.mark.parametrize("branch", ["drop_free", "capacity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_reference(arch, dtype, branch):
    rcfg, cfg, moe, tmoe = _layer(arch, branch)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = np.random.default_rng(2).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    want, want_aux = jax.jit(RL.moe_mlp, static_argnums=1)(moe, rcfg, xj)
    xt = torch.tensor(x).to(dtype)
    got, aux = L.moe_mlp(tmoe, cfg, xt)
    assert got.dtype == dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    # the routing: choices in top-k order and the kept mask, bit for bit
    xs = np.asarray(xj.astype(jnp.float32)).reshape(128, -1)
    top_e, keep, cap = _reference_route(moe, rcfg, xs)
    r = L.moe_route(torch.tensor(xs) @ tmoe["router"], cfg.moe)
    assert r["cap"] == cap == (128 if branch == "drop_free" else
                               max(8, math.ceil(0.5 * 128
                                                * cfg.moe.top_k
                                                / cfg.moe.num_experts)))
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert keep.all() == (branch == "drop_free")


def _dense_oracle(p, cfg, x):
    """tests/test_models_decode.py::_dense_moe_oracle on the port: every
    expert on every token, no capacity, the top k combined by their
    renormalised weights."""
    logits = x.float() @ p["router"].float()
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_e = top.indices[:, :cfg.moe.top_k]
    top_w = torch.softmax(top.values[:, :cfg.moe.top_k], dim=-1)
    h = torch.nn.functional.silu(torch.einsum("nd,edf->nef", x,
                                              p["w_gate"]))
    h = h * torch.einsum("nd,edf->nef", x, p["w_up"])
    ye = torch.einsum("nef,efd->ned", h, p["w_down"])
    y = torch.zeros_like(x)
    for j in range(cfg.moe.top_k):
        y = y + top_w[:, j:j + 1] * ye[torch.arange(len(x)), top_e[:, j]]
    return y


def _port_layer(cfg, seed=1):
    prm = P.init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    return {k: v[0] for k, v in prm["stages"]["stage0"]["sub0"]["moe"]
            .items()}


def test_moe_dispatch_matches_dense_oracle():
    """tests/test_models_decode.py::test_moe_dispatch_matches_dense_oracle
    on the port, with the port's own weights."""
    cfg = registry.get_smoke_config("granite_moe_1b")
    p = _port_layer(cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    y, aux = L.moe_mlp(p, cfg, x)
    want = _dense_oracle(p, cfg, x.reshape(32, -1)).reshape(x.shape)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    assert float(aux) > 0


def test_moe_capacity_drops_tokens():
    """tests/test_models_decode.py::test_moe_capacity_drops_tokens on the
    port: at half the capacity some pairs are dropped, so the output is
    not the drop-free oracle's, but finite; and each token's output is
    the oracle's restricted to its kept pairs."""
    cfg = _capacity(registry.get_smoke_config("granite_moe_1b"))
    p = _port_layer(cfg)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    y, _ = L.moe_mlp(p, cfg, x)
    xf = x.reshape(128, -1)
    want = _dense_oracle(p, cfg, xf).reshape(x.shape)
    assert not torch.allclose(y, want, atol=1e-4)
    assert bool(torch.isfinite(y).all())
    r = L.moe_route(xf @ p["router"], cfg.moe)
    keep = r["keep"].reshape(128, -1)
    assert 0 < int(keep.sum()) < keep.numel()
    full = keep.all(1)      # tokens that kept every choice
    torch.testing.assert_close(y.reshape(128, -1)[full],
                               want.reshape(128, -1)[full], atol=1e-4,
                               rtol=1e-4)
    gone = ~keep.any(1)     # tokens that kept none add nothing
    assert torch.equal(y.reshape(128, -1)[gone],
                       torch.zeros_like(y.reshape(128, -1)[gone]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_go_to_the_lowest_experts(arch):
    """A zero router gives every token equal logits: ``jax.lax.top_k``
    takes experts 0..k-1 in that order, and so does the port (a stable
    descending sort; `torch.topk` would not), on both devices' rule; the
    capacity ranks then fill each of those experts in token order."""
    cfg = _capacity(registry.get_smoke_config(arch))
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    n = 48
    r = L.moe_route(torch.zeros((n, e)), cfg.moe)
    assert torch.equal(r["top_e"], torch.arange(k).expand(n, k))
    cap = r["cap"]
    want_keep = (torch.arange(n) < cap)[:, None].expand(n, k).reshape(-1)
    assert torch.equal(r["keep"], want_keep)
    rcfg = _capacity(rregistry.get_smoke_config(arch))
    moe = {"router": np.zeros((cfg.d_model, e), np.float32)}
    top_e, keep, _ = _reference_route(
        moe, rcfg, np.ones((n, cfg.d_model), np.float32))
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)


@pytest.mark.parametrize("branch", ["drop_free", "capacity"])
def test_moe_gradients_match_reference(branch):
    """d/d(x, router, w_gate, w_up, w_down) of sum(y c) + aux, c a fixed
    random cotangent, against ``jax.grad``: each within 1e-4 of its
    largest magnitude (measured under 1e-6)."""
    rcfg, cfg, moe, tmoe = _layer("granite_moe_1b", branch)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def ref_scalar(p, xx):
        y, aux = RL.moe_mlp(p, rcfg, xx)
        return jnp.sum(y * c) + aux

    gp, gx = jax.jit(jax.grad(ref_scalar, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, moe), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tmoe.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = L.moe_mlp(leaves, cfg, xt)
    names = sorted(leaves)
    grads = torch.autograd.grad((y * torch.tensor(c)).sum() + aux,
                                [leaves[k] for k in names] + [xt])
    want = [np.asarray(gp[k]) for k in names] + [np.asarray(gx)]
    for name, g, w in zip(names + ["x"], grads, want):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_and_counts_match_reference(arch):
    """`model_defs` key for key, shape for shape (fan-in dims and init
    rules too) at the full and the smoke config; `param_count` and
    `active_param_count` equal the reference's (granite-moe-1b:
    1,334,628,352 and 428,658,688)."""
    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    for get in ("get_config", "get_smoke_config"):
        rcfg, cfg = getattr(rregistry, get)(arch), getattr(registry, get)(arch)
        want, got = flat(RP.model_defs(rcfg)), flat(P.model_defs(cfg))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            g = got[key]
            assert (g.shape, g.init, tuple(g.fan_in_dims)) == \
                (tuple(w.shape), w.init, tuple(w.fan_in_dims)), key
        assert config.param_count(cfg) == rconfig.param_count(rcfg)
        assert config.active_param_count(cfg) == \
            rconfig.active_param_count(rcfg)
    full = registry.get_config("granite_moe_1b")
    assert (config.param_count(full), config.active_param_count(full)) == \
        (1_334_628_352, 428_658_688)
    dense = registry.get_smoke_config("chatglm3_6b")
    assert config.active_param_count(dense) == config.param_count(dense)


def test_lm_loss_and_grads_match_reference_moe():
    """`lm_loss` at granite-moe-1b's smoke config with some labels -1:
    ce, moe_aux and the total (ce + 0.01 aux) against the reference's
    (jitted ``value_and_grad``, remat), within 1e-5 relative; every
    gradient within 1e-4 of its largest magnitude."""
    rcfg = rregistry.get_smoke_config("granite_moe_1b")
    cfg = registry.get_smoke_config("granite_moe_1b")
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    (want, wmet), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, b, remat=True), has_aux=True))(
        rprm, batch)
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    leaves = P.tree_leaves(prm)
    for x in leaves:
        x.requires_grad_(True)
    loss, met = T.lm_loss(prm, cfg, {k: torch.tensor(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for got, w in ((loss.detach(), want), (met["ce"].detach(), wmet["ce"]),
                   (met["moe_aux"].detach(), wmet["moe_aux"])):
        assert abs(float(got) - float(w)) <= 1e-5 * abs(float(w))
    loss, ce, aux = (float(x.detach()) for x in (loss, met["ce"],
                                                 met["moe_aux"]))
    assert aux > 0 and abs(loss - ce - 0.01 * aux) <= 1e-6 * loss
    assert int(met["ntokens"]) == int(wmet["ntokens"]) == 2 * 16 - 3
    for g, w in zip(grads, jax.tree.leaves(wgrad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_trainer_history_matches_reference_moe():
    """The quickstart's training layer (examples/quickstart.py, layer 3)
    cut to 3 steps: granite-moe-1b's smoke config, seq 64, batch 4, the
    5-step warmup, the locality-aware pipeline; the port's `Trainer` from
    the reference's initial state gives the reference `Trainer`'s
    history (loss, which carries the aux term, and grad_norm within 1e-5
    relative; lr and locality exactly)."""
    rcfg = rregistry.get_smoke_config("granite_moe_1b")
    cfg = registry.get_smoke_config("granite_moe_1b")
    mesh = rmesh.make_test_mesh((1, 1), ("data", "model"))

    def quick(plan):
        return dataclasses.replace(plan, opt=dataclasses.replace(
            plan.opt, warmup_steps=5, decay_steps=200))

    rplan = quick(rruntime.plan_for(rcfg, "train_4k", "train",
                                    dp_axes=("data",)))
    tkw = dict(seq_len=64, global_batch=4, steps=3, log_every=1)
    pkw = dict(seq_len=64, global_batch=4, seed=0, token_skew=1.2)
    ref = RTrainer(rcfg, RTrainerConfig(**tkw), mesh, rplan,
                   pipeline=RDataPipeline(RPipelineConfig(
                       vocab_size=rcfg.vocab_size, **pkw)))
    ref.init_state()
    port = Trainer(cfg, TrainerConfig(**tkw),
                   quick(runtime.plan_for(cfg, "train_4k", "train")),
                   pipeline=DataPipeline(PipelineConfig(
                       vocab_size=cfg.vocab_size, **pkw)), device="cpu")
    port.from_reference_state(jax.tree.map(np.asarray, ref.state))
    want, got = ref.run(), port.run()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for w, g in zip(want, got):
        assert g["data_locality"] == w["data_locality"]
        assert g["lr"] == w["lr"]
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_drains_moe(arch, capsys):
    """tests/test_launchers.py::test_serve_cli on the port (on the CPU
    here): ``--arch granite_moe_1b --requests 4`` drains 4 requests, and
    so does mixtral-8x22b's smoke config."""
    serve.main(["--arch", arch, "--requests", "4"], device="cpu")
    assert "drained 4 requests" in capsys.readouterr().out
