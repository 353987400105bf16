"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports `jax`, the `repro` reference package or its
`benchmarks`; entry points run on the card unless the caller asks for
the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from repro_torch.configs import registry
from repro_torch.launch import serve as launch_serve
from repro_torch.models import params as P, transformer as T
from repro_torch.serve.engine import EngineConfig, ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _port_modules()
    for name in ("kernels.slot_step", "kernels.wwl_route", "kernels.maxweight",
                 "core.jsq_maxweight", "core.priority", "core.fifo",
                 "core.pandas_po2", "core.robustness", "core.claiming",
                 "kernels.flash_attention", "models.config", "models.params",
                 "models.layers", "models.transformer", "configs.registry",
                 "configs.chatglm3_6b", "configs.gemma2_2b", "core.cluster",
                 "core.estimator", "placement.policies", "telemetry.recorder",
                 "serve.engine", "launch.serve", "models.mamba",
                 "models.ssm_ops", "kernels.ssd_scan", "configs.mamba2_13b",
                 "workloads", "workloads.scenario", "workloads.library",
                 "workloads.trace", "workloads.ingest", "utils.doc",
                 "placement.policy", "placement.capacity", "replication",
                 "replication.lifecycle", "replication.controllers",
                 "replication.simproj", "replication.host", "telemetry",
                 "telemetry.events", "control", "control.plane",
                 "control.controllers", "control.simproj", "control.host",
                 "launch.elastic", "data", "data.pipeline", "optim",
                 "optim.adamw", "train", "train.trainer", "checkpoint",
                 "checkpoint.checkpointer", "launch.steps", "launch.train",
                 "configs.runtime", "configs.shapes",
                 "configs.whisper_medium", "configs.internvl2_2b",
                 "configs.jamba15_large", "launch.dryrun", "launch.mesh",
                 "sharding.rules", "utils.cache", "utils.hlo",
                 "utils.roofline", "examples", "examples.figures",
                 "examples.robustness_study", "examples.quickstart",
                 "examples.drift_study", "examples.placement_study",
                 "examples.replication_study",
                 "examples.tail_latency_study",
                 "examples.slo_control_study", "examples.replay",
                 "examples.trace_replay", "examples.serve_cluster",
                 "examples.train_100m", "examples.elastic_restart"):
        assert f"repro_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        f"for name in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    topo, rates = loc.Topology(24, 6), loc.Rates()
    cfg = sim.SimConfig(topo, rates, horizon=20, warmup=5, max_arrivals=16)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate("balanced_pandas", cfg, 5.0, est, fleet=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate("jsq_maxweight", cfg, 5.0, est)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sweep("fifo", cfg, [5.0], est[None], [0])
    study = rb.StudyConfig(sim=cfg, loads=(0.5,), eps_grid=(), seeds=(0,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.run_study(study, algos=("priority",))
    # the placement slice: its sampler, capacity, study and seams
    from repro_torch.placement import make_placement, placement_capacity
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_placement("spread").build_sampler(topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        placement_capacity(topo, rates, 0.5, "hdfs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate("balanced_pandas", cfg, 5.0, est, placement="hdfs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.placement_study(study, placements=("hot_aware",))
    # the replication slice: its simulator projection, seam and study
    from repro_torch.replication import make_replication
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_replication("repair").build_sim(topo, rates.values,
                                             make_placement(None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate("balanced_pandas", cfg, 5.0, est,
                     scenario="server_loss")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.replication_study(study, replications=("fixed",),
                             scenarios=("rack_loss",),
                             policies=("balanced_pandas",), loads=(0.5,))
    # the control slice: the controlled simulator and the control study
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate("balanced_pandas", cfg, 5.0, est, control="autoscale")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.control_study(study, policies=("balanced_pandas",),
                         arms=("admission",), loads=(0.9,))
    # the serving slice: parameters, caches, the engine and its launcher
    mcfg = registry.get_smoke_config("chatglm3_6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init_params(mcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_caches(mcfg, 1, 16)
    prm = P.init_params(mcfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(mcfg, prm, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main([])
    # the training slice: the train step, the trainer, restore, launcher
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import runtime
    from repro_torch.launch import steps, train as launch_train
    from repro_torch.train.trainer import Trainer, TrainerConfig
    plan = runtime.plan_for(mcfg, "train_4k", "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.build_train_step(mcfg, plan, 8, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.build_prefill_step(mcfg, plan, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.build_serve_step(mcfg, plan, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(mcfg, TrainerConfig(seq_len=16), plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1", "--seq-len", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Checkpointer(ROOT).restore({})
    # the examples: each raises before it runs or writes anything
    import importlib
    for name, argv in (("robustness_study", []), ("drift_study", []),
                       ("placement_study", []), ("replication_study", []),
                       ("tail_latency_study", []), ("slo_control_study", []),
                       ("trace_replay", []), ("quickstart", ["--fast"]),
                       ("serve_cluster", []), ("train_100m", ["--steps", "1"]),
                       ("elastic_restart", []), ("drift_study", ["--smoke"]),
                       ("placement_study", ["--smoke"])):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
    from repro_torch.examples import figures, replay
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay.replay_trace()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.fig2_highload()
