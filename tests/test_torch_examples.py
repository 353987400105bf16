"""The port's study examples (`repro_torch.examples`) against the
reference's `examples/` scripts, on the CPU.

Each study example runs its ``--smoke`` branch once through `smoke` (or
`run`), gates and all, at a cut horizon: the bitwise gates on 50 / 10
slots and the studies on 100 / 25, the control study on 200 / 50 (the
smokes' 400 / 100 and 1500 / 400 or 1200 / 300 take 16-63 s each on a
CPU, over this file's budget; `test_torch_examples_smoke.py` runs the
drift study's ``main(["--smoke"])`` as its CLI does).  Each
smoke's study is then fed, as the stubbed ``rb.*_study``, to the
reference script's ``main`` and to the port's: the CSVs must be equal
byte for byte and the printed lines equal but for the path each CSV was
written to.  `robustness_study` is held the same way under one stubbed
``sim.sweep``, and `trace_replay` under its smoke's drift study and a
stubbed serving leg that writes one canned export.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

from repro import workloads as rwl
from repro.core import robustness as rrb
from repro_torch import workloads as wl
from repro_torch.core import robustness as rb
from repro_torch.examples import (drift_study, placement_study,
                                  replication_study, slo_control_study,
                                  smoke_sim, smoke_study, tail_latency_study,
                                  trace_replay)
from _torch_port import (reference_benchmark, run_reference_script,
                         single_torch_thread, stub_sweep)  # noqa: F401

GATE = (50, 10)      # the bitwise gates' horizon and warmup
STUDY = (100, 25)    # the smoke studies'
# the admission arm's bucket (a burst of 8 x capacity, refilled at 0.93)
# empties at rho 0.99 only after about 130 slots
CONTROL_STUDY = (200, 50)


def _smoke(fn, *args, **kw):
    """Run a smoke, returning (study, printed text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        study = fn(*args, **kw)
    return study, buf.getvalue()


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """Each study example's smoke at the cut horizons, run on first use."""
    cache = {}
    runs = {
        "drift_study": lambda: _smoke(
            drift_study.run, smoke_study(*STUDY),
            drift_study.SMOKE_SCENARIOS, smoke=True, device="cpu"),
        "placement_study": lambda: _smoke(
            placement_study.smoke, smoke_sim(*GATE), smoke_study(*STUDY),
            0.7, device="cpu"),
        "replication_study": lambda: _smoke(
            replication_study.smoke, smoke_sim(*GATE), smoke_study(*STUDY),
            0.7, device="cpu"),
        "tail_latency_study": lambda: _smoke(
            tail_latency_study.smoke, smoke_sim(*GATE), smoke_study(*STUDY),
            device="cpu"),
        "slo_control_study": lambda: _smoke(
            slo_control_study.smoke, smoke_sim(*GATE),
            smoke_study(*CONTROL_STUDY), device="cpu"),
        "trace_replay": lambda: _smoke(
            trace_replay.run, "diurnal_week", smoke_study(*STUDY), smoke=True,
            device="cpu",
            export=tmp_path_factory.mktemp("trace") / "rerecorded.jsonl"),
    }

    def get(name):
        if name not in cache:
            cache[name] = runs[name]()
        return cache[name]
    return get


OK_LINES = {"drift_study": "scenario smoke OK",
            "placement_study": "placement smoke OK",
            "replication_study": "replication smoke OK",
            "tail_latency_study": "tail-latency smoke OK",
            "slo_control_study": "slo-control smoke OK",
            "trace_replay": "trace-replay smoke OK"}


@pytest.mark.parametrize("name", sorted(OK_LINES))
def test_smoke_gates_hold(smokes, name):
    study, out = smokes(name)
    assert out.rstrip().endswith(OK_LINES[name]), out


def _run_both(monkeypatch, tmp_path, capsys, name, stubs, argv=()):
    """Run the reference script and the port's module, each in a
    directory of its own with the same stubs; returns the two
    directories and the printed lines (``wrote`` lines dropped)."""
    out = {}
    for side in ("reference", "port"):
        where = tmp_path / side
        where.mkdir()
        monkeypatch.chdir(where)
        for mod, attr, fn in stubs:
            monkeypatch.setattr(mod, attr, fn)
        if side == "reference":
            run_reference_script(monkeypatch, name, argv)
        else:
            import importlib
            importlib.import_module(f"repro_torch.examples.{name}").main(
                list(argv), device="cpu")
        out[side] = [line for line in capsys.readouterr().out.splitlines()
                     if not line.startswith("wrote ")]
    assert out["reference"] == out["port"]
    return tmp_path / "reference", tmp_path / "port", out["port"]


def _same_files(ref_dir, port_dir, names):
    for name in names:
        ref = (ref_dir / name).read_bytes()
        assert ref == (port_dir / name).read_bytes(), name
        assert ref.count(b"\n") > 1


STUDIES = {  # script: (study function, CSVs written by default)
    "drift_study": ("drift_study", ("drift_study.csv",)),
    "placement_study": ("placement_study", ("placement_study_k3.csv",
                                            "placement_study_k4.csv")),
    "replication_study": ("replication_study", ("replication_study.csv",)),
    "tail_latency_study": ("tail_study", ("tail_latency.csv",)),
    "slo_control_study": ("control_study", ("slo_control.csv",)),
}


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_csv_equals_reference(monkeypatch, tmp_path, capsys, smokes,
                                    name):
    study, _ = smokes(name)
    attr, csvs = STUDIES[name]
    canned = lambda *a, **kw: study  # noqa: E731
    ref_dir, port_dir, lines = _run_both(
        monkeypatch, tmp_path, capsys, name,
        [(rb, attr, canned), (rrb, attr, canned)])
    _same_files(ref_dir / "experiments" / "figures",
                port_dir / "experiments" / "figures_torch",
                csvs)
    assert lines
    assert not (port_dir / "experiments" / "figures").exists()


def test_robustness_study_equals_reference(monkeypatch, tmp_path, capsys):
    reference_benchmark(monkeypatch, "figures")
    stub_sweep(monkeypatch)
    ref_dir, port_dir, lines = _run_both(monkeypatch, tmp_path, capsys,
                                         "robustness_study", [])
    _same_files(ref_dir / "experiments" / "figures",
                port_dir / "experiments" / "figures_torch",
                ["robustness_study.csv"])
    assert lines[-1].startswith("headline claims: {'fig1_pandas")
    assert sum(line.startswith("-- fig") for line in lines) == 4


def test_trace_replay_equals_reference(monkeypatch, tmp_path, capsys,
                                       smokes):
    """The smoke's drift study and one canned export (the arrivals of a
    12-request replay) stand in for the two legs."""
    study, _ = smokes("trace_replay")
    from repro_torch.examples import replay
    bench_serving = reference_benchmark(monkeypatch, "bench_serving")

    def canned_replay(spec=None, scheduler="balanced_pandas", fast=True,
                      export_path=None, **kw):
        arrivals = np.asarray([0, 1, 1, 3, 7, 8, 12, 20, 21, 33, 34, 50])
        Path(export_path).parent.mkdir(parents=True, exist_ok=True)
        wl.save_trace(wl.trace_from_arrivals(arrivals, 32, name=spec.name,
                                             horizon=58.0), export_path)
        return [(f"serve_{scheduler}_scn_x", 57.0, "tiers={0: 12}")]

    canned = lambda *a, **kw: study  # noqa: E731
    ref_dir, port_dir, lines = _run_both(
        monkeypatch, tmp_path, capsys, "trace_replay",
        [(rb, "drift_study", canned), (rrb, "drift_study", canned),
         (bench_serving, "replay_trace", canned_replay),
         (replay, "replay_trace", canned_replay)])
    _same_files(ref_dir / "experiments" / "figures",
                port_dir / "experiments" / "figures_torch",
                ["trace_replay_diurnal_week.csv"])
    _same_files(ref_dir / "experiments" / "traces",
                port_dir / "experiments" / "traces_torch",
                ["replay_rerecorded.jsonl"])
    assert any("replay round-trip OK" in line for line in lines)
    back = rwl.load_trace(port_dir / "experiments" / "traces_torch"
                          / "replay_rerecorded.jsonl")
    assert int(back.arrivals.sum()) == 12
