"""The port's training math against the JAX reference on the CPU, in
float32, at the smoke configs, with the reference's weights carried over
by `params.from_reference`:

  * `transformer.lm_loss` and its gradients against
    ``jax.value_and_grad`` of the reference's ``lm_loss(..., remat=True)``
    (jitted) for chatglm3-6b, gemma2-2b (softcap, sliding window),
    gemma3-1b, codeqwen1.5-7b, mamba2-1.3b, whisper-medium (its frames
    encoded first) and internvl2-2b (its frontend rows dropped from the
    loss), with some labels -1: the
    loss within 1e-5 relative, every gradient within 1e-4 of its largest
    magnitude (measured: under 6e-6), and the port's remat on and off
    equal bit for bit;
  * `launch.steps.build_train_step` against the reference's on a 1x1 test
    mesh, global batch 8 under ``plan_for(..., "train")`` (4
    microbatches of every batch key, frames and frontend included), 3
    steps from the reference's initial `TrainState`:
    each step's loss and grad norm within 1e-5 relative, the parameters
    after 3 steps within 1e-5 relative in at least 99.9% of elements
    and none farther than 2 x the sum of the steps' learning rates (the
    bound on Adam's per-element step);
  * `configs.runtime.plan_for` and `configs.shapes` against the
    reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry, runtime as rruntime
from repro.configs import shapes as rshapes
from repro.launch import mesh as rmesh, steps as rsteps
from repro.models import params as RP, transformer as RT
from repro.optim import adamw as RA
from repro_torch.configs import registry, runtime, shapes
from repro_torch.launch import steps as S
from repro_torch.models import params as P, transformer as T
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_port import modality_inputs
from _torch_port import single_torch_thread  # noqa: F401

LOSS_ARCHS = ("chatglm3_6b", "gemma2_2b", "gemma3_1b", "codeqwen15_7b",
              "mamba2_13b", "whisper_medium", "internvl2_2b")
STEP_ARCHS = ("chatglm3_6b", "mamba2_13b", "whisper_medium", "internvl2_2b")


def _batch(cfg, b, t, seed, ignore=True):
    """tokens and labels (b, t), some labels -1, and the model's frames or
    frontend rows (`modality_inputs`) beside them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    if ignore:
        out["labels"][0, :3] = -1
        out["labels"][-1, -2:] = -1
    out.update(modality_inputs(cfg, b, seed))
    return out


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    rcfg, cfg = rregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(3))
    batch = _batch(cfg, 2, 16, seed=1)
    (want, wmet), wgrad = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, b, remat=True), has_aux=True))(
        rprm, batch)
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    leaves = P.tree_leaves(prm)
    for x in leaves:
        x.requires_grad_(True)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    runs = []
    for remat in (True, False):
        loss, met = T.lm_loss(prm, cfg, tbatch, remat=remat)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves), met))
    (loss, grads, met), (loss_off, grads_off, _) = runs
    assert torch.equal(loss, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_off))
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    assert int(met["ntokens"]) == int(wmet["ntokens"]) == 2 * 16 - 5
    assert float(met["moe_aux"]) == float(wmet["moe_aux"]) == 0.0
    ce = float(met["ce"].detach())
    assert abs(ce - float(wmet["ce"])) <= 1e-5 * float(want)
    for g, w in zip(grads, jax.tree.leaves(wgrad)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_lm_loss_all_labels_ignored():
    """ntok = max(sum(valid), 1): an all-ignored batch has loss 0."""
    cfg = registry.get_smoke_config("chatglm3_6b")
    prm = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    loss, met = T.lm_loss(prm, cfg, {"tokens": tok, "labels": tok - 1})
    assert float(loss) == 0.0 and int(met["ntokens"]) == 1


def _reference_step(arch, global_batch=8, seq_len=32):
    rcfg = rregistry.get_smoke_config(arch)
    mesh = rmesh.make_test_mesh((1, 1), ("data", "model"))
    rplan = rruntime.plan_for(rcfg, "train_4k", "train",
                              dp_axes=rmesh.dp_axes(mesh))
    fn, _, _, _ = rsteps.build_train_step(rcfg, mesh, rplan, global_batch,
                                          seq_len)
    with mesh:
        prm = RP.init_params(rcfg, jax.random.PRNGKey(0))
        state = rsteps.TrainState(prm, RA.init(rplan.opt, prm), jnp.int32(0))
    return mesh, fn, state


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    cfg = registry.get_smoke_config(arch)
    plan = runtime.plan_for(cfg, "train_4k", "train")
    assert S.num_microbatches(plan, 8) == 4
    mesh, fn, rstate = _reference_step(arch)
    tr = Trainer(cfg, TrainerConfig(seq_len=32, global_batch=8), plan,
                 device="cpu")
    tr.from_reference_state(jax.tree.map(np.asarray, rstate))
    lrs = []
    for i in range(3):
        batch = _batch(cfg, 8, 32, seed=10 + i, ignore=False)
        with mesh:
            rstate, want = fn(rstate, jax.tree.map(jnp.asarray, batch))
        tr.state, got = tr.step_fn(tr.state, batch)
        for k in ("loss", "grad_norm"):
            w = float(want[k])
            assert abs(float(got[k]) - w) <= 1e-5 * abs(w), (i, k)
        assert float(got["lr"]) == float(want["lr"])
        lrs.append(float(want["lr"]))
    assert int(tr.state.step) == int(rstate.step) == 3
    assert int(tr.state.opt.count) == int(rstate.opt.count) == 3
    want = [np.asarray(x) for x in jax.tree.leaves(rstate.params)]
    got = [x.detach().numpy() for x in P.tree_leaves(tr.state.params)]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    size = np.concatenate([np.abs(w).ravel() for w in want])
    assert np.mean(diff <= 1e-5 * size) >= 0.999
    assert diff.max() <= 2 * sum(lrs)


def test_microbatches_follow_the_reference_split():
    """Microbatch j holds rows j, j + n_mb, ... as the reference's
    ``reshape(mb, n_mb, ...).swapaxes(0, 1)``; n_mb steps down until it
    divides the batch."""
    x = np.arange(8 * 3).reshape(8, 3)
    want = x.reshape((2, 4, 3)).swapaxes(0, 1)
    for j in range(4):
        np.testing.assert_array_equal(
            S.microbatch(torch.tensor(x), 4, j).numpy(), want[j])
    for gb, micro, n in ((8, 4, 4), (6, 4, 3), (3, 4, 3), (5, 4, 1),
                         (16, 8, 8)):
        assert S.num_microbatches(S.RuntimePlan(microbatches=micro), gb) == n


def test_single_microbatch_step():
    """n_mb = 1 takes the gradients as they come (the reference's other
    branch) and gives the same metrics keys."""
    cfg = registry.get_smoke_config("chatglm3_6b")
    plan = S.RuntimePlan(microbatches=1)
    fn, astate, abatch = S.build_train_step(cfg, plan, 2, 8, device="cpu")
    assert abatch["tokens"] == shapes.TensorSpec((2, 8), torch.int32)
    tr = Trainer(cfg, TrainerConfig(seq_len=8, global_batch=2), plan,
                 device="cpu")
    tr.init_state()
    for a, t in zip(P.tree_leaves(astate.params), P.tree_leaves(tr.state.params)):
        assert a.shape == t.shape and a.dtype == t.dtype
    state, met = fn(tr.state, _batch(cfg, 2, 8, seed=0))
    assert sorted(met) == ["grad_norm", "loss", "lr"]
    assert int(state.step) == 1 and np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_plan_for_matches_reference(full):
    for arch in registry.PORTED_IDS:
        get = "get_config" if full else "get_smoke_config"
        rcfg, cfg = getattr(rregistry, get)(arch), getattr(registry, get)(arch)
        for shape in rshapes.SHAPES:
            kind = rshapes.SHAPES[shape].kind
            want = rruntime.plan_for(rcfg, shape, kind)
            got = runtime.plan_for(cfg, shape, kind)
            assert got.microbatches == want.microbatches
            assert got.accum_dtype == want.accum_dtype
            assert got.remat == want.remat
            for f in ("peak_lr", "b1", "b2", "eps", "weight_decay",
                      "grad_clip", "moment_dtype", "update_dtype",
                      "warmup_steps", "decay_steps", "min_lr_frac"):
                assert getattr(got.opt, f) == getattr(want.opt, f)
    # the >= 100B names keep bf16 moments and deeper microbatching
    big = registry.get_smoke_config("chatglm3_6b")
    for name, acc in (("mixtral-8x22b", "float32"),
                      ("jamba-1.5-large-398b", "bfloat16")):
        plan = runtime.plan_for(dataclasses.replace(big, name=name),
                                "train_4k", "train")
        assert plan.microbatches == 8 and plan.accum_dtype == acc
        assert plan.opt.moment_dtype == plan.opt.update_dtype == "bfloat16"


def test_shapes_match_reference():
    assert sorted(shapes.SHAPES) == sorted(rshapes.SHAPES)
    for name, rs in rshapes.SHAPES.items():
        assert shapes.SHAPES[name] == shapes.RunShape(
            rs.name, rs.kind, rs.seq_len, rs.global_batch)
    for arch in registry.PORTED_IDS:
        rcfg, cfg = rregistry.get_config(arch), registry.get_config(arch)
        for name, rs in rshapes.SHAPES.items():
            assert shapes.applicable(cfg, shapes.SHAPES[name]) == \
                rshapes.applicable(rcfg, rs)
            want = rshapes.input_specs(rcfg, rs)
            got = shapes.input_specs(cfg, shapes.SHAPES[name])
            assert sorted(got) == sorted(want)
            for k, spec in want.items():
                assert got[k].shape == spec.shape
                assert str(got[k].dtype) == f"torch.{spec.dtype}"
