"""The port's host-side event tracing (`repro_torch.telemetry.events`)
and its emitters, against the JAX reference's.

(a) tests/test_telemetry.py's `EventRecorder` tests on the port's copy:
    the Chrome-trace round trip, ring eviction, the validator; a trace
    the port writes loads with the reference's `load_trace`, and the
    reverse.
(b) `HostReplication`'s events (server_down/up, repair_start/commit on
    the ``CLOCK_UNIT_US`` clock) equal the reference's event for event
    under the same observe/note_read sequence.
(c) tests/test_serving_engine.py's engine trace test on the port's tiny
    engine; the engine's trace-export hook (`arrival_log`,
    `recorded_trace`, `sojourn_overflow_frac`) against the reference
    engine's for the same submit steps.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as rregistry
from repro.core import locality as rloc
from repro.models import params as RP
from repro.placement import make_placement as rmake_placement
from repro.replication import ReplicationConfig as RReplicationConfig
from repro.replication import make_replication as rmake_replication
from repro.serve import engine as rengine
from repro.telemetry import events as revents
from repro_torch.configs import registry
from repro_torch.core import locality as loc
from repro_torch.models import params as P
from repro_torch.placement import make_placement
from repro_torch.replication import ReplicationConfig, make_replication
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.telemetry import (CLOCK_UNIT_US, EventRecorder, events,
                                   load_trace, maybe_span,
                                   validate_chrome_trace)
from _torch_port import single_torch_thread  # noqa: F401


# -- the recorder -----------------------------------------------------------

def test_chrome_trace_roundtrip(tmp_path):
    tr = EventRecorder(capacity=64, pid=7)
    tr.metadata("process_name", name="test")
    tr.instant("hello", cat="t", ts_us=1000.0, tid=2, detail="x")
    tr.counter("depth", 3.0, ts_us=2000.0)
    tr.complete("work", ts_us=1000.0, dur_us=500.0, tid=1)
    with tr.span("wall", cat="host"):
        pass
    with maybe_span(None, "noop"):
        pass  # tracing off: a no-op context
    with maybe_span(tr, "maybe", tid=3):
        pass
    doc = load_trace(tr.save(tmp_path / "trace.json"))
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"] == {"emitted": 6, "dropped": 0, "capacity": 64}
    names = [e["name"] for e in doc["traceEvents"]]
    assert names == ["process_name", "hello", "depth", "work", "wall",
                     "maybe"]
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert by_name["hello"]["ph"] == "i"
    assert by_name["hello"]["args"] == {"detail": "x"}
    assert by_name["depth"]["args"] == {"value": 3.0}
    assert by_name["work"]["ph"] == "X" and by_name["work"]["dur"] == 500.0
    assert by_name["maybe"]["tid"] == 3 and by_name["maybe"]["dur"] >= 0.0
    assert all(e["pid"] == 7 for e in doc["traceEvents"])
    assert (events.PHASES, CLOCK_UNIT_US) == (revents.PHASES,
                                              revents.CLOCK_UNIT_US)


def test_ring_eviction_is_counted():
    tr = EventRecorder(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.to_chrome()["otherData"]["emitted"] == 10
    with pytest.raises(ValueError, match="capacity"):
        EventRecorder(capacity=0)


def test_validate_chrome_trace_rejects_malformed():
    for bad, match in (([], None),
                       ({"traceEvents": [{"name": "a", "ph": "i", "pid": 0,
                                          "tid": 0}]}, "ts"),
                       ({"traceEvents": [{"name": "a", "ph": "Z", "ts": 0.0,
                                          "pid": 0, "tid": 0}]}, "phase"),
                       ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0,
                                          "pid": 0, "tid": 0}]}, "dur")):
        with pytest.raises(ValueError, match=match) as got:
            validate_chrome_trace(bad)
        with pytest.raises(ValueError) as want:
            revents.validate_chrome_trace(bad)
        assert str(got.value) == str(want.value)
    validate_chrome_trace({"traceEvents": []})  # minimal valid doc


def _fill(tr):
    tr.metadata("thread_name", tid=1, name="replica0")
    tr.instant("submit", cat="engine", ts_us=3000.0, rid=4, prefix=2)
    tr.counter("queued", 5, ts_us=3000.0)
    tr.complete("request4", 3000.0, 2000.0, cat="request", tid=1, rid=4)
    return tr


def test_traces_load_across_packages(tmp_path):
    """A trace the port saves loads with the reference's `load_trace` as
    the same document, and the reverse."""
    mine, ref = _fill(EventRecorder(pid=3)), _fill(revents.EventRecorder(
        pid=3))
    assert mine.events() == ref.events()
    a = revents.load_trace(mine.save(tmp_path / "port.json"))
    b = load_trace(ref.save(tmp_path / "ref.json"))
    assert a == b == mine.to_chrome()
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


# -- the host replication lifecycle -----------------------------------------

@pytest.mark.parametrize("name,topo", [("popularity", (12, 4)),
                                       ("repair", (24, (4, 12)))])
def test_host_replication_events_equal_reference(name, topo):
    m, groups = topo
    rtopo, ptopo = rloc.Topology(m, groups), loc.Topology(m, groups)
    rates = np.asarray((0.5, 0.45, 0.35, 0.25)[:ptopo.num_tiers]
                       if ptopo.num_tiers == 4 else (0.5, 0.45, 0.25))
    opts = {"lanes": 2} if name == "repair" else {}
    ref = rmake_replication(RReplicationConfig(name, opts)).build_host(
        rtopo, rmake_placement(None), 24, 3, 2, rates)
    mine = make_replication(ReplicationConfig(name, opts)).build_host(
        ptopo, make_placement(None), 24, 3, 2, rates)
    ref.tracer, mine.tracer = revents.EventRecorder(), EventRecorder()
    rng = np.random.default_rng(7)
    rack = np.asarray(ptopo.rack_of)
    alive = np.ones(m, bool)
    for t in range(150):
        if t in (15, 90):            # a rack goes, then three servers
            alive = rack != 1 if t == 15 else np.ones(m, bool)
            if t == 90:
                alive[rng.choice(m, 3, replace=False)] = False
        if t in (60, 130):
            alive = np.ones(m, bool)
        for _ in range(int(rng.integers(0, 5))):
            c = int(rng.zipf(1.6)) % 40
            assert mine.replicas_for(c) == ref.replicas_for(c)
            mine.note_read(c)
            ref.note_read(c)
        mine.observe(float(t) + 0.5 * (t % 2), alive)
        ref.observe(float(t) + 0.5 * (t % 2), alive)
    assert mine.tracer.events() == ref.tracer.events()
    names = {e["name"] for e in mine.tracer.events()}
    assert {"server_down", "server_up", "repair_start",
            "repair_commit"} <= names
    for e in mine.tracer.events():
        assert e["ts"] % (CLOCK_UNIT_US / 2) == 0.0


# -- the serving engine -----------------------------------------------------

ARCH = "chatglm3_6b"
ECFG = dict(num_replicas=4, replicas_per_pod=2, slots_per_replica=2,
            max_len=64, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def model():
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def test_engine_trace_export(model, tmp_path):
    """tests/test_serving_engine.py's trace test on the port's engine: the
    trace round-trips as Chrome-trace JSON with submit/route/admit
    instants, request and decode spans, queue-depth counters and
    thread-name metadata; request spans sit on the step clock, on their
    replica's thread."""
    _, _, cfg, prm = model
    tracer = EventRecorder()
    rng = np.random.default_rng(6)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                    max_new_tokens=2, prefix_id=i) for i in range(4)]
    eng = ServingEngine(cfg, prm, EngineConfig(**ECFG, tracer=tracer),
                        device="cpu")
    eng.run_until_drained(reqs, max_steps=100)
    doc = load_trace(tracer.save(tmp_path / "engine_trace.json"))
    by_ph = {}
    for ev in doc["traceEvents"]:
        by_ph.setdefault(ev["ph"], []).append(ev)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"submit", "route", "admit", "queued", "decode"} <= names
    for name in ("submit", "route", "admit"):
        assert sum(e["name"] == name for e in by_ph["i"]) == len(reqs)
    req_evs = [e for e in by_ph["X"] if e["cat"] == "request"]
    assert sorted(e["name"] for e in req_evs) == [f"request{i}"
                                                  for i in range(4)]
    for e in req_evs:
        assert e["ts"] % 1000.0 == 0.0 and e["dur"] >= 1000.0
        assert 1 <= e["tid"] <= eng.spec.num_servers
        assert e["args"]["tokens"] == 3
    decode = [e for e in by_ph["X"] if e["name"] == "decode"]
    assert decode and all(e["cat"] == "kernel" and e["ts"] % 1000.0 == 0.0
                          for e in decode)
    assert sum(e["name"] == "queued" for e in by_ph["C"]) == eng.steps
    assert any(e["name"] == "thread_name" for e in by_ph["M"])
    assert doc["otherData"]["dropped"] == 0


def test_engine_trace_export_hook_matches_reference(model):
    """The same submit steps on both engines: the same `arrival_log`, the
    same re-recorded `Trace` at the same engine step (routing follows
    the wall clock, so the engines drain at different steps), and
    `sojourn_overflow_frac` read as the reference reads it."""
    rcfg, rprm, cfg, prm = model
    ecfg = dict(ECFG, sojourn_hist_bins=6, sojourn_hist_max=6.0)
    ref = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(**ecfg))
    eng = ServingEngine(cfg, prm, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(9)
    # submits a step; 14 at once outrun the 8 slots, so some sojourns
    # pass 6 steps whatever the routing
    plan = [14] + [int(k) for k in rng.integers(0, 4, 11)]
    for e, request in ((ref, rengine.Request), (eng, Request)):
        prompts = np.random.default_rng(2)
        rid = 0
        for k in plan:
            for _ in range(k):
                e.submit(request(rid=rid, prompt=prompts.integers(
                    0, cfg.vocab_size, 6).astype(np.int32),
                    max_new_tokens=4, prefix_id=rid % 5))
                rid += 1
            e.step()
        while e.in_system:
            e.step()
    for e in (ref, eng):   # the same engine-step clock on both
        while e.steps < max(ref.steps, eng.steps):
            e.step()
    assert eng.arrival_log == ref.arrival_log and len(eng.arrival_log) == \
        sum(plan)
    for n in (4, 32):
        got, want = (e.recorded_trace(n, name="drip") for e in (eng, ref))
        assert (got.name, got.interval) == (want.name, want.interval)
        np.testing.assert_array_equal(got.arrivals, want.arrivals)
    # the overflow share, from the port's histogram by both rules
    frac = eng.sojourn_overflow_frac
    ref.sojourn_hist = eng.sojourn_hist.copy()
    assert frac == ref.sojourn_overflow_frac
    assert 0.0 < frac < 1.0
