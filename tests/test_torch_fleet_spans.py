"""The program's spans and counters on the fleet study path
(`repro_torch.telemetry.span` / `count` / `recording`), on the CPU.

(a) Tracing on (a CPU `torch.profiler` and an installed recorder) leaves
    every output of `run_study` bit for bit.
(b) Under the profiler every span of the path appears, as often as the
    study's slots and rounds say, inside the span it belongs to: one
    ``fleet.draws`` a slot, three ``fleet.route.water_level`` a
    Balanced-PANDAS slot.
(c) The counters: ``fleet.tasks_arrived`` is the sum of a fresh
    `DeviceSource`'s counts and ``fleet_route.tasks_scanned`` rounds x
    horizon x N x B through `kernels.ops.fleet_route`; the recorder gets
    each as a ``C`` event.  They count only inside a run's `collecting`
    block, one thread's apart from another's: the fleet step profiled
    on its own counts nothing into a later study.
(d) With neither a profiler nor a recorder nothing is recorded, no
    ``record_function`` opens and `COUNTS` stays as it was.
(e) A recorder span and the profiler's range of the same region agree
    on the clock, and `maybe_span` is the same span path.
"""

import functools
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from repro_torch.core.rng import DeviceSource
from repro_torch.sharding import sim as fs
from repro_torch.telemetry import EventRecorder, events
from _torch_port import single_torch_thread  # noqa: F401

HORIZON, ROUNDS, BATCH = 12, 2, 24
# the fewest bisection steps the fleet path takes: the profiler records
# every operation, and the spans do not depend on the count
FLEET = fs.FleetConfig(rounds=ROUNDS, fill_iters=8, use_kernel=True)
TOPOS = {"rack": ((24, 6), (0.5, 0.45, 0.25)),
         "fattree": ((24, (4, 12)), (0.5, 0.45, 0.35, 0.25))}
POLICIES = ("balanced_pandas", "pandas_po2")
CASES = [(t, p) for t in TOPOS for p in POLICIES]
IDS = [f"{t}-{p}" for t, p in CASES]

# span -> the span it sits in (None: the outermost)
PARENTS = {"study": None, "study.estimates": "study",
           "fleet.setup": "study", "fleet.setup.estimates": "fleet.setup",
           "fleet.setup.step": "fleet.setup", "fleet.setup.cdf": "fleet.setup",
           "fleet.loop": "study",
           "fleet.draws": "fleet.loop", "fleet.arrivals": "fleet.loop",
           "fleet.route": "fleet.loop", "fleet.serve": "fleet.loop",
           "fleet.route.private": "fleet.route",
           "fleet.route.water_level": ("fleet.route",
                                       "fleet.route.pool_fill"),
           "fleet.route.rank_clamp": "fleet.route",
           "fleet.route.pool_fill": "fleet.route",
           "fleet.finalize": "study"}
BP_ONLY = {"fleet.route.private", "fleet.route.water_level",
           "fleet.route.rank_clamp", "fleet.route.pool_fill"}


def _study(topo):
    (m, groups), rates = TOPOS[topo]
    cfg = sim.SimConfig(topo=loc.Topology(m, groups),
                        true_rates=loc.Rates(rates), max_arrivals=BATCH,
                        horizon=HORIZON, warmup=3)
    return rb.StudyConfig(sim=cfg, loads=(0.6, 0.95), eps_grid=(0.3,),
                          seeds=(5, 6))


def _run(topo, policy):
    out = rb.run_study(_study(topo), algos=(policy,),
                       fleet=FLEET, device="cpu")
    return {k: out[k][policy] for k in ("delay", "throughput", "final_n")}


@functools.lru_cache(maxsize=None)
def _profiled(topo, policy):
    """(outputs, the profiler's program spans, the recorder) of one study
    run under both."""
    recorder = EventRecorder(capacity=1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.recording(recorder):
            out = _run(topo, policy)
    spans = [e for e in prof.events() if e.name in PARENTS]
    return out, spans, recorder


def _tracing_off():
    return events._INSTALLED == 0 and \
        not torch.autograd.profiler._is_profiler_enabled and \
        getattr(events._LOCAL, "pending", None) is None


def _span_parent(evt):
    up = evt.cpu_parent
    while up is not None and up.name not in PARENTS:
        up = up.cpu_parent
    return up


def _expected_counts(policy):
    slots = HORIZON
    want = {name: 1 for name in PARENTS}
    for name in ("fleet.draws", "fleet.arrivals", "fleet.route",
                 "fleet.serve"):
        want[name] = slots
    if policy == "balanced_pandas":
        want.update({"fleet.route.private": ROUNDS * slots,
                     "fleet.route.rank_clamp": ROUNDS * slots,
                     "fleet.route.water_level": (ROUNDS + 1) * slots,
                     "fleet.route.pool_fill": slots})
    else:
        for name in BP_ONLY:
            del want[name]
    return want


def _cells(topo):
    """The study's cells ``[(seed, lam), ...]`` in `fleet_sweep`'s order."""
    study = _study(topo)
    cap = loc.capacity_hot_rack(study.sim.topo, study.sim.true_rates,
                                study.sim.p_hot)
    lam = np.asarray(study.loads, np.float32) * cap
    estimates = 1 + len(study.eps_grid) * 2
    return [(s, l) for l in lam for _ in range(estimates)
            for s in study.seeds]


@pytest.mark.parametrize("topo,policy", CASES, ids=IDS)
def test_tracing_leaves_outputs_bit_for_bit(topo, policy):
    off = _run(topo, policy)
    on, _, _ = _profiled(topo, policy)
    for key in off:
        np.testing.assert_array_equal(on[key], off[key])


@pytest.mark.parametrize("topo,policy", CASES, ids=IDS)
def test_spans_appear_nested_as_documented(topo, policy):
    _, spans, recorder = _profiled(topo, policy)
    want = _expected_counts(policy)
    assert Counter(e.name for e in spans) == want
    for e in spans:
        parent = _span_parent(e)
        allowed = PARENTS[e.name]
        allowed = allowed if isinstance(allowed, tuple) else (allowed,)
        assert (parent.name if parent is not None else None) in allowed, \
            e.name
    if policy == "balanced_pandas":
        per_slot = Counter()    # by the slot's fleet.route span
        for e in spans:
            if e.name == "fleet.route.water_level":
                up = _span_parent(e)
                while up.name != "fleet.route":
                    up = _span_parent(up)
                per_slot[id(up)] += 1
        assert len(per_slot) == HORIZON and set(per_slot.values()) == {3}
    # the recorder saw the same spans, as complete events
    got = Counter(e["name"] for e in recorder.events() if e["ph"] == "X")
    assert got == want


def _check_counted_study(topo, policy):
    """One study under an installed recorder: its counters, in `COUNTS`
    and as the recorder's ``C`` events, are exactly its own work."""
    before = dict(telemetry.COUNTS)
    recorder = EventRecorder()
    with telemetry.recording(recorder):
        _run(topo, policy)
    counters = {e["name"]: e["args"]["value"] for e in recorder.events()
                if e["ph"] == "C"}
    names = {"fleet.tasks_arrived"}
    if policy == "balanced_pandas":
        names |= {"fleet_route.tasks_scanned"}
    assert set(counters) == names
    delta = {k: telemetry.COUNTS[k] - before.get(k, 0) for k in names}
    assert delta == counters
    m = TOPOS[topo][0][0]
    cells = _cells(topo)
    src = DeviceSource(cells, BATCH, m, "cpu", fs.candidates(policy))
    arrived = sum(int(src.slot(t).n.sum()) for t in range(HORIZON))
    assert delta["fleet.tasks_arrived"] == arrived > 0
    if policy == "balanced_pandas":
        assert delta["fleet_route.tasks_scanned"] == \
            ROUNDS * HORIZON * len(cells) * BATCH
    assert _tracing_off()


@pytest.mark.parametrize("topo,policy", CASES, ids=IDS)
def test_counters(topo, policy):
    _check_counted_study(topo, policy)


def test_the_step_profiled_alone_counts_nothing():
    """The fleet step run under a profiler outside a study (as
    `chip_smoke.py` profiles it) keeps no count, and a study traced
    after it counts exactly its own work."""
    topo, policy = "rack", "balanced_pandas"
    study, cells = _study(topo), _cells(topo)
    init, step = fs._build_fleet_step(policy, study.sim, FLEET,
                                      torch.device("cpu"))
    est = torch.as_tensor(np.stack(
        [sim.make_estimates(study.sim, "network", 0.0, -1)] * len(cells)))
    src = DeviceSource(cells, BATCH, study.sim.topo.num_servers, "cpu",
                       fs.candidates(policy))
    before = dict(telemetry.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]):
        carry = init(len(cells))
        for t in range(3):
            draws = src.slot(t)
            telemetry.count("fleet.tasks_arrived", draws.n)
            carry = step(carry, t, est, draws)
        assert not telemetry.counting()
    assert telemetry.COUNTS == before and _tracing_off()
    _check_counted_study(topo, policy)


def test_collecting_blocks_keep_to_their_threads():
    """Each thread's counts go to its own block's flush and its own
    recorder; a block that raises drops its counts; `counting` is true
    only inside a block while tracing is on."""
    import threading

    name = "test.collecting"
    before = telemetry.COUNTS.get(name, 0)
    recorders = [EventRecorder(), EventRecorder()]
    counted, flushed = threading.Event(), threading.Event()

    def first():
        with telemetry.recording(recorders[0]), telemetry.collecting():
            telemetry.count(name, torch.tensor([2, 3]))
            counted.set()
            assert flushed.wait(30)

    def second():
        assert counted.wait(30)
        with telemetry.recording(recorders[1]), telemetry.collecting():
            telemetry.count(name, 7)
        flushed.set()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [[e["args"]["value"] for e in r.events()] for r in recorders] \
        == [[5], [7]]
    assert telemetry.COUNTS[name] - before == 12

    assert not telemetry.counting()
    with telemetry.collecting():
        assert not telemetry.counting()          # tracing off
        with telemetry.recording(EventRecorder()):
            assert telemetry.counting()
            with pytest.raises(RuntimeError):
                with telemetry.collecting():     # part of the outer block
                    telemetry.count(name, 1)
                    raise RuntimeError
    assert telemetry.COUNTS[name] - before == 13
    with telemetry.recording(EventRecorder()):
        with pytest.raises(RuntimeError):
            with telemetry.collecting():
                telemetry.count(name, 1)
                raise RuntimeError
    assert telemetry.COUNTS[name] - before == 13 and _tracing_off()


@pytest.mark.parametrize("policy", POLICIES)
def test_nothing_recorded_when_tracing_is_off(policy, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = dict(telemetry.COUNTS)
    assert _tracing_off()
    assert telemetry.span("fleet.loop") is telemetry.span("study")
    _run("rack", policy)
    assert telemetry.COUNTS == before and _tracing_off()


def test_recorder_span_agrees_with_the_profiler_range():
    with telemetry.span("study"):   # first use: the profiler's lazy set-up
        pass
    recorder = EventRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.recording(recorder):
            with telemetry.span("study"):
                torch.ones(64).cumsum(0)
            with telemetry.span("fleet.setup"):
                sum(range(200_000))
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("study", "fleet.setup")}
    marks = {e["name"]: e for e in recorder.events()}
    assert set(ranges) == set(marks) == {"study", "fleet.setup"}
    for name, rng in ranges.items():
        start_us = rng.start_ns() * 1e-3
        end_us = (rng.start_ns() + rng.duration_ns()) * 1e-3
        ev = marks[name]
        assert abs(ev["ts"] - start_us) < 1000.0
        assert abs(ev["ts"] + ev["dur"] - end_us) < 1000.0


def test_maybe_span_is_the_span_path():
    """An explicit recorder replaces the installed one; under a profiler
    `maybe_span` opens the profiler's range too; `recording` nests."""
    mine, installed = EventRecorder(), EventRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.recording(installed):
            with telemetry.maybe_span(mine, "replica.step", tid=2, batch=3):
                pass
            with telemetry.maybe_span(None, "fleet.serve"):
                pass
            inner = EventRecorder()
            with telemetry.recording(inner):
                with telemetry.span("fleet.loop"):
                    pass
            with telemetry.span("fleet.finalize"):
                pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"replica.step", "fleet.serve", "fleet.loop",
            "fleet.finalize"} <= names
    (ev,) = mine.events()
    assert (ev["name"], ev["tid"], ev["args"]) == ("replica.step", 2,
                                                   {"batch": 3})
    assert [e["name"] for e in installed.events()] == ["fleet.serve",
                                                       "fleet.finalize"]
    assert [e["name"] for e in inner.events()] == ["fleet.loop"]
    assert _tracing_off()


def test_span_names_stay_off_the_device_kinds():
    """The profiler draws each range on the device's timeline too; trace
    readers take names with ``kernel`` or a copy's prefix for work."""
    for name in list(PARENTS) + ["fleet.tasks_arrived",
                                 "fleet_route.tasks_scanned"]:
        assert "kernel" not in name.lower()
        assert not name.startswith(("void ", "Memcpy", "Memset"))


def test_recorder_clock_is_the_profilers():
    """`EventRecorder.now_us` reads Unix-epoch microseconds, the clock
    `torch.profiler` stamps host events with."""
    import time

    a = time.time_ns() * 1e-3
    now = EventRecorder().now_us()
    b = time.time_ns() * 1e-3
    assert a <= now <= b


def test_recorders_stay_with_their_threads():
    """Each thread's spans go to the recorder it installed, and the count
    of installed recorders comes back to 0 (more threads than cores, a
    short switch interval)."""
    import os
    import sys
    import threading

    n, spans_each = 2 * (os.cpu_count() or 2) + 2, 200
    recorders = [EventRecorder() for _ in range(n)]
    errors = []

    def work(rec):
        try:
            for _ in range(spans_each):
                with telemetry.recording(rec):
                    with telemetry.span("fleet.loop"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(r,))
                   for r in recorders]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [len(r.events()) for r in recorders] == [spans_each] * n
    assert _tracing_off()
