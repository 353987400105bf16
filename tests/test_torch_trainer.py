"""The port's trainer, checkpointer, training launcher and the training
half of `launch.elastic`, against the JAX reference's on the CPU.

  * `Trainer.run` fed by the ported pipeline gives the reference
    `Trainer`'s history (``step``, ``data_locality`` exactly; ``loss``,
    ``grad_norm`` within 1e-5 relative; ``lr`` exactly; ``wall_s`` is a
    host time and left out), both from the reference's initial state;
  * `Checkpointer`: round trip and retention (``keep_last``), the
    reference's `KeyError`/`ValueError`, bf16 bit for bit, a directory the
    reference wrote read as `from_reference` of the reference's own
    `restore`, and the reverse for float32; a trainer stopped at step 2
    and restored runs steps 3-4 bit for bit as the uninterrupted one;
  * `HeartbeatMonitor`, `plan_elastic_mesh`, `rebalance_batch` and
    `ElasticSupervisor.replan` equal the reference's over a grid, errors
    included, and a simulated failure resumes from the last checkpoint;
  * `launch.train.main(..., device="cpu")` prints the reference's line.
"""

import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.configs import registry as rregistry, runtime as rruntime
from repro.data.pipeline import DataPipeline as RDataPipeline
from repro.data.pipeline import PipelineConfig as RPipelineConfig
from repro.launch import elastic as relastic, mesh as rmesh
from repro.launch import steps as rsteps
from repro.models import params as RP
from repro.optim import adamw as RA
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry, runtime
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import elastic, steps as S, train as launch_train
from repro_torch.models import params as P
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "chatglm3_6b"
PIPE = dict(seq_len=16, global_batch=8, num_chunks=64, tokens_per_chunk=256,
            token_skew=1.2, seed=0)
LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3}) "
                  r"(\d+)ms locality \((.*)\)$")


def _port_trainer(tmp=None, arch=ARCH, **kw):
    cfg = registry.get_smoke_config(arch)
    tcfg = TrainerConfig(**dict(dict(seq_len=16, global_batch=8, steps=4,
                                     log_every=1, ckpt_every=2,
                                     ckpt_dir=tmp), **kw))
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size, **PIPE),
                        slow_hosts={0: 0.1})
    return Trainer(cfg, tcfg, runtime.plan_for(cfg, "train_4k", "train"),
                   pipeline=pipe, device="cpu")


def _snapshot(tr):
    st = tr.state
    return [t.detach().clone() for t in
            P.tree_leaves(st.params) + P.tree_leaves(st.opt.mu)
            + P.tree_leaves(st.opt.nu) + [st.opt.count, st.step]]


@pytest.mark.parametrize("arch", ["chatglm3_6b", "mamba2_13b"])
def test_trainer_history_matches_reference(arch):
    rcfg, cfg = rregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    mesh = rmesh.make_test_mesh((1, 1), ("data", "model"))
    rplan = rruntime.plan_for(rcfg, "train_4k", "train",
                              dp_axes=rmesh.dp_axes(mesh))
    tkw = dict(seq_len=16, global_batch=8, steps=4, log_every=2)
    ref = RTrainer(rcfg, RTrainerConfig(**tkw), mesh, rplan,
                   pipeline=RDataPipeline(RPipelineConfig(
                       vocab_size=rcfg.vocab_size, **PIPE),
                       slow_hosts={0: 0.1}))
    ref.init_state()
    port = _port_trainer(arch=arch, steps=4, log_every=2, ckpt_every=100)
    port.from_reference_state(jax.tree.map(np.asarray, ref.state))
    want, got = ref.run(), port.run()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 4]
    for w, g in zip(want, got):
        assert g["data_locality"] == w["data_locality"]
        assert g["lr"] == w["lr"]
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), k
    assert port.pipeline.metrics["reads"] == ref.pipeline.metrics["reads"]


def test_checkpoint_roundtrip_and_retention(tmp_path):
    """tests/test_substrates.py's checkpoint tests on the port."""
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(3, dtype=torch.int32)}}
    for step in (1, 2, 3):
        ck.save(step, {"a": tree["a"] * step, "b": tree["b"]},
                metadata={"note": step})
    assert ck.latest_step() == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]
    out = ck.restore(tree, device="cpu")
    assert torch.equal(out["a"], tree["a"] * 3)
    assert out["b"]["c"].dtype == torch.int32 and int(out["b"]["c"]) == 3
    assert ck.manifest()["metadata"] == {"note": 3}
    assert ck.manifest()["keys"]["a"] == {"shape": [2, 3],
                                          "dtype": "float32"}
    bg = Checkpointer(str(tmp_path / "bg"), background=True)
    bg.save(7, tree)
    bg.wait()
    assert bg.latest_step() == 7
    assert torch.equal(bg.restore(tree, device="cpu")["a"], tree["a"])
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.zeros(3, 2), "b": tree["b"]}, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"a": tree["a"], "z": tree["a"]}, device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree, device="cpu")


def test_checkpoint_bf16_bit_for_bit(tmp_path):
    """Every bf16 bit pattern (NaNs, infinities, subnormals, -0.0) comes
    back unchanged, and the file holds the reference's layout for bf16:
    two raw bytes a value, ``bfloat16`` in the manifest."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16)
    tree = {"w": bits.view(torch.bfloat16).reshape(256, 256)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    out = ck.restore({"w": torch.empty((256, 256), dtype=torch.bfloat16,
                                       device="meta")}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), tree["w"].view(
        torch.int16))
    assert ck.manifest()["keys"]["w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    # the reference's own bf16 write reads back through the port
    r = jnp.asarray(np.random.default_rng(0).normal(size=(5, 3)),
                    jnp.bfloat16)
    RCheckpointer(str(tmp_path / "ref")).save(1, {"w": r})
    got = Checkpointer(str(tmp_path / "ref")).restore(
        {"w": torch.empty((5, 3), dtype=torch.bfloat16)}, device="cpu")
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(r, np.float32))


def test_checkpoint_crosses_packages(tmp_path):
    """A smoke `TrainState` the reference wrote reads through the port's
    `restore` as `from_reference` of the reference's own `restore` (keys
    ``.params/...``, ``.opt/.mu/...``, ``.step``), and the port's write
    reads back through the reference's."""
    rcfg, cfg = rregistry.get_smoke_config(ARCH), \
        registry.get_smoke_config(ARCH)
    prm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    opt = RA.init(RA.AdamWConfig(), prm)
    opt = opt._replace(count=jnp.int32(5),
                       mu=jax.tree.map(lambda x: x * 0.5, prm))
    rstate = rsteps.TrainState(prm, opt, jnp.int32(5))
    rck = RCheckpointer(str(tmp_path / "ref"))
    rck.save(5, rstate, metadata={"pipeline": {"cursor": 3}})
    template = S.abstract_state(cfg, runtime.plan_for(cfg, "train_4k",
                                                      "train"))
    got = Checkpointer(str(tmp_path / "ref")).restore(template, device="cpu")
    want = rck.restore(jax.tree.map(np.asarray, rstate))
    assert int(got.step) == 5 and int(got.opt.count) == 5
    for g, w in ((got.params, want.params), (got.opt.mu, want.opt.mu),
                 (got.opt.nu, want.opt.nu)):
        w = P.from_reference(w, device="cpu")
        for a, b in zip(P.tree_leaves(g), P.tree_leaves(w)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(5, got)
    assert sorted(ck.manifest()["keys"]) == sorted(
        rck.manifest()["keys"])
    back = RCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(np.asarray, rstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_is_bit_for_bit(tmp_path):
    """Stopped at step 2 and restored (train state from the checkpoint,
    pipeline from its metadata), a trainer runs steps 3-4 exactly as the
    uninterrupted one: parameters, moments, counts, pipeline state and
    losses, and the pipeline's place in the data (cursor, buffer, reads,
    placement).  As in the reference, the pipeline's state holds neither
    its locality counters nor its service-time generator, so a resumed
    ``data_locality`` and virtual clock restart; the batches do not."""
    whole = _port_trainer(str(tmp_path / "whole"))
    whole.init_state()
    hist = whole.run(4)
    first = _port_trainer(str(tmp_path / "cut"))
    first.init_state()
    first.run(2)
    resumed = _port_trainer(str(tmp_path / "cut"))
    assert resumed.restore_or_init() == 2
    resumed.pipeline.load_state_dict(
        resumed.ckpt.manifest()["metadata"]["pipeline"])
    rest = resumed.run(2)
    assert [r["step"] for r in rest] == [3, 4]
    for a, b in zip(rest, hist[2:]):
        assert (a["loss"], a["grad_norm"], a["lr"]) == \
            (b["loss"], b["grad_norm"], b["lr"])
    for a, b in zip(_snapshot(resumed), _snapshot(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for p in P.tree_leaves(resumed.state.params):
        assert p.requires_grad and p.is_leaf
    from test_torch_pipeline import assert_same
    a, b = resumed.pipeline.state_dict(), whole.pipeline.state_dict()
    for k in ("cursor", "buffer", "reads", "placement"):
        assert_same(a[k], b[k], k)


HEARTBEATS = [(4, 10.0, {0: 0.0, 1: 5.0, 2: 9.0}, 12.0),
              (3, 1.0, {}, 0.5), (5, 60.0, {4: 100.0}, 130.0)]


def test_elastic_helpers_match_reference():
    for n, timeout, beats, now in HEARTBEATS:
        mons = [mod.HeartbeatMonitor(n, timeout_s=timeout)
                for mod in (relastic, elastic)]
        for m in mons:
            for w in range(n):
                m.beat(w, 0.0)
            for w, t in beats.items():
                m.beat(w, t)
        assert mons[1].failed(now) == mons[0].failed(now)
        assert mons[1].alive(now) == mons[0].alive(now)
    for chips in (1, 3, 4, 16, 255, 256, 512, 768, 1024):
        for model in (1, 4, 16, 600):
            for kw in (dict(), dict(pod_size=64)):
                outs = []
                for mod in (relastic, elastic):
                    try:
                        outs.append(mod.plan_elastic_mesh(chips, model, **kw))
                    except RuntimeError as e:
                        outs.append(("error", str(e)))
                assert outs[1] == outs[0]
    for gb, old, new, mb in ((256, 16, 12, 4), (8, 2, 1, 4), (24, 4, 3, 1),
                             (7, 2, 2, 1), (5, 1, 7, 2)):
        outs = []
        for mod in (relastic, elastic):
            try:
                outs.append(mod.rebalance_batch(gb, old, new, mb))
            except RuntimeError as e:
                outs.append(("error", str(e)))
        assert outs[1] == outs[0]
    for chips, model, gb, mb in ((512, 16, 256, 4), (240, 16, 256, 4),
                                 (1, 1, 8, 4), (8, 4, 6, 1), (2, 4, 8, 1)):
        outs = []
        for mod in (relastic, elastic):
            sup = mod.ElasticSupervisor(build=None, checkpointer=None,
                                        model_axis=model, global_batch=gb,
                                        microbatches=mb)
            try:
                outs.append(sup.replan(chips))
            except RuntimeError as e:
                outs.append(("error", str(e)))
        assert outs[1] == outs[0]


def test_simulated_failure_resumes_from_last_checkpoint(tmp_path):
    """Step 3 is lost with its worker: the heartbeat flags it, the
    supervisor replans (one card: a 1x1 mesh, the plan's 4 microbatches),
    builds the step, restores step 2 and reruns steps 3-4; the end state
    equals an uninterrupted run's bit for bit."""
    whole = _port_trainer(str(tmp_path / "whole"))
    whole.init_state()
    whole.run(4)
    tr = _port_trainer(str(tmp_path / "run"))
    tr.init_state()
    tr.run(3)                       # checkpoint at 2, then step 3 is lost
    mon = elastic.HeartbeatMonitor(2, timeout_s=5.0)
    mon.beat(0, 100.0)
    mon.beat(1, 90.0)
    assert mon.failed(now=101.0) == [1]
    cfg = tr.cfg

    def build(shape, names, n_mb):
        plan = dataclasses.replace(tr.plan, microbatches=n_mb)
        return S.build_train_step(cfg, plan, 8, 16, device="cpu")

    sup = elastic.ElasticSupervisor(build=build, checkpointer=tr.ckpt,
                                    model_axis=1, global_batch=8,
                                    microbatches=tr.plan.microbatches)
    shape, names, n_mb = sup.replan(len(mon.alive(now=101.0)))
    assert (shape, names, n_mb) == ((1, 1), ("data", "model"), 4)
    step_fn, template, _ = sup.build(shape, names, n_mb)
    state = sup.checkpointer.restore(template, device="cpu")
    assert int(state.step) == 2
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size, **PIPE),
                        slow_hosts={0: 0.1})
    pipe.load_state_dict(sup.checkpointer.manifest()["metadata"]["pipeline"])
    for _ in range(2):
        state, _ = step_fn(state, next(pipe))
    whole_leaves = _snapshot(whole)
    tr.state = state
    for a, b in zip(_snapshot(tr), whole_leaves):
        assert torch.equal(a, b)


def test_launcher_prints_the_reference_line(monkeypatch):
    """Two smoke steps through each package's launcher: the same line
    format, the same steps and the same pipeline locality (the weights
    differ: each package draws its own)."""
    args = ["--arch", "mamba2_13b", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2"]
    from repro.launch import train as rtrain
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    out = {}
    for name, call in (("ref", rtrain.main),
                       ("port", lambda: launch_train.main(args,
                                                          device="cpu"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            call()
        out[name] = [LINE.match(x) for x in buf.getvalue().splitlines()]
    assert len(out["port"]) == len(out["ref"]) == 1
    assert all(out["port"]) and all(out["ref"])
    for r, p in zip(out["ref"], out["port"]):
        assert p.group(1) == r.group(1) and p.group(5) == r.group(5)
        assert np.isfinite(float(p.group(2)))
