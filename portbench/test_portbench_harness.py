"""The harness end to end on the CPU at a cut size: it runs the window and
the comparison, writes no metric, refuses a traced run, and reads
``correct`` false when the timed path is broken underneath; the command
refuses to print a result without a card or without the program; and no
module of the benchmark imports what it must not."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, run, spec
from portbench._cut import cut

HERE = Path(__file__).resolve().parent
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name="rack10k-bp-study", seconds=0.0, trace=False):
    return harness.run(cut(name), spec.manifest(), SEED, seconds, trace,
                       "cpu", time.perf_counter())


def test_cpu_run_is_correct_and_writes_no_metric():
    out = _run(seconds=0.3)
    assert out["correct"] is True
    assert out["failed"] == 0
    assert out["attempted"] == out["calls"] * 12 >= 12
    assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"cells_unequal": {"value": 0, "limit": 0}}


def test_cpu_run_refuses_to_trace():
    with pytest.raises(ValueError, match="CUDA"):
        _run(trace=True)


@pytest.mark.parametrize("d", [1, 3])
def test_a_mix_whose_d_the_entry_does_not_run_is_refused(d):
    """The entry runs power-of-d at the policy's own d; a mix that asks
    for another would hold the program to a reference it does not run."""
    cell = cut("rack10k-po2-study")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, d=d))
    with pytest.raises(ValueError, match="candidates"):
        harness.run(cell, spec.manifest(), SEED, 0.0, False, "cpu",
                    time.perf_counter())


# ---------------------------------------------------------------------------
# faults planted under the timed path: each must read `correct` false
# ---------------------------------------------------------------------------


def _state_unchanged(monkeypatch):
    from repro_torch.sharding import sim as fleet

    build = fleet._build_fleet_step

    def broken(*args, **kw):
        init, _ = build(*args, **kw)
        return init, lambda carry, t, est, draws: carry

    monkeypatch.setattr(fleet, "_build_fleet_step", broken)


def _half_the_batch(monkeypatch):
    from repro_torch.sharding import sim as fleet

    sample = fleet._sample_arrivals

    def broken(draws, ctx, p_hot, batch):
        types, active = sample(draws, ctx, p_hot, batch)
        keep = torch.arange(batch, device=active.device) < batch // 2
        return types, active & keep

    monkeypatch.setattr(fleet, "_sample_arrivals", broken)


def _answer_altered(monkeypatch):
    from repro_torch.sharding import sim as fleet

    finalize = fleet._finalize

    def broken(carry, lam):
        out = finalize(carry, lam)
        out["mean_delay"] = out["mean_delay"].copy()
        out["mean_delay"][0] = np.nextafter(out["mean_delay"][0],
                                            np.float32(np.inf))
        return out

    monkeypatch.setattr(fleet, "_finalize", broken)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
@pytest.mark.parametrize("name", ["rack10k-bp-study", "rack10k-po2-study"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    out = _run(name)
    assert out["correct"] is False
    assert out["failed"] == out["checks"]["cells_unequal"]["value"] > 0


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------


def test_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "rack10k-bp-study", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


# pretend a card is there, then run the command where it was started
_FAKE_CARD = ("import runpy, sys, torch; "
              "torch.cuda.is_available = lambda: True; "
              "torch.cuda.device_count = lambda: 1; "
              "sys.argv = ['portbench.run'] + sys.argv[1:]; "
              "runpy.run_module('portbench.run', run_name='__main__')")


def test_command_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files it exits non-zero and prints no result."""
    shutil.copy(spec.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _FAKE_CARD, "--workload", "rack10k-bp-study",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
    assert "program is missing" in proc.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def _imports(path: Path):
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.relative_to(HERE).parts:
        assert not names & {"repro_torch", "portbench"}


def test_result_line_is_json():
    out = _run()
    assert json.loads(json.dumps(out)) == out


def test_set_up_warms_one_cell_of_the_cells_own_cluster(monkeypatch):
    """Set-up runs one cell (the highest load, exact rates, the first
    seed) for a few slots on the cell's own cluster and batch, not the
    grid: every per-cell Poisson CDF of the grid is the window's work."""
    from portbench.drivers import fleet_study

    seen = []
    real = fleet_study.run_study

    def spy(cell, study, fleet, device):
        seen.append(study)
        return real(cell, study, fleet, device)

    monkeypatch.setattr(fleet_study, "run_study", spy)
    cell = cut("fattree8k-bp-study")
    work = fleet_study.prepare(cell, SEED, "cpu")
    work.warm()
    (warm,) = seen
    assert warm.loads == (0.95,) and warm.eps_grid == ()
    assert warm.seeds == (fleet_study.seeds(cell, SEED)[0],)
    assert warm.sim.horizon == fleet_study.WARM_SLOTS < cell.traffic["horizon"]
    assert warm.sim.topo == work.study.sim.topo
    assert warm.sim.max_arrivals == work.study.sim.max_arrivals
