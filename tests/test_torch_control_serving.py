"""The control plane on the port's host side — the routers' autoscaling
mask and the serving engine's ``control=`` — against the JAX reference's
on the CPU.

(a) After each `set_active`, the masked Balanced-PANDAS, power-of-d and
    JSQ-MaxWeight routers (and FIFO, which ignores the mask) make the
    reference's decisions and claims under one seed, the fallback to the
    active fleet included, and refuse the reference's bad masks.
(b) tests/test_control.py's engine arms on the chatglm3-6b smoke config,
    the port beside the reference engine on the same requests with a
    stubbed clock on both (equal observed prefill times, so equal
    estimates): queue-threshold and token-bucket admission shed the same
    requests before routing, the rest drain with the same tokens; the
    autoscaler parks the same replicas, which drain; a closed-loop
    client pool polled by its caller submits and drains as the
    reference's does.  Traced, the engine's ``shed`` and ``autoscale``
    instants equal the reference's.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as rregistry
from repro.core import locality as rloc, policy as rpol
from repro.models import params as RP
from repro.serve import engine as rengine
from repro.telemetry import EventRecorder as REventRecorder
from repro_torch.configs import registry
from repro_torch.core import locality as loc, policy
from repro_torch.models import params as P
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.telemetry import EventRecorder
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "chatglm3_6b"
BASE = dict(num_replicas=4, replicas_per_pod=2, slots_per_replica=2,
            max_len=64, prefill_buckets=(16,))


def _outcome(x):
    return None if x is None else (type(x).__name__,) + tuple(
        vars(x).values())


@pytest.mark.parametrize("name", ["balanced_pandas", "pandas_po2",
                                  "jsq_maxweight", "fifo"])
def test_masked_routers_decide_as_reference(name):
    topo, rtopo = loc.Topology(8, 2), rloc.Topology(8, 2)
    prior = (1.0, 0.7, 0.4)
    got = policy.make_router(name, topo, prior, seed=4)
    want = rpol.make_router(name, rtopo, prior, seed=4)
    assert got.active_mask.all() and got.active_mask.shape == (8,)
    rng = np.random.default_rng(1)
    for op in range(400):
        if op % 9 == 0:
            mask = rng.random(8) < rng.uniform(0.15, 1.0)
            if not mask.any():
                mask[rng.integers(8)] = True
            if op % 45 == 0:
                mask[:] = True
            got.set_active(mask)
            want.set_active(mask)
        if rng.random() < 0.6:
            locs = [int(x) for x in rng.choice(8, 3, replace=False)]
            assert _outcome(got.route(locs)) == _outcome(want.route(locs))
        else:
            w = int(rng.integers(8))
            assert _outcome(got.claim(w)) == _outcome(want.claim(w))
        np.testing.assert_array_equal(got.queue_depths(),
                                      want.queue_depths())
    for bad in (np.zeros(8, bool), np.ones(7, bool)):
        with pytest.raises(ValueError) as e1:
            got.set_active(bad)
        with pytest.raises(ValueError) as e2:
            want.set_active(bad)
        assert str(e1.value) == str(e2.value)


@pytest.fixture(scope="module")
def model():
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def _clock():
    ticks = iter(range(1 << 30))

    class Clock:   # each read half a second after the last
        @staticmethod
        def monotonic():
            return 0.5 * next(ticks)
    return Clock


def _mk_reqs(cls, cfg, n, seed=0):
    """tests/test_control.py's requests."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           8).astype(np.int32),
                max_new_tokens=2, prefix_id=i % 3) for i in range(n)]


def _engines(model, monkeypatch, control, **kw):
    rcfg, rprm, cfg, prm = model
    monkeypatch.setattr(engine_mod, "time", _clock())
    monkeypatch.setattr(rengine, "time", _clock())
    ref = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(
        **BASE, control=control, **kw.get("ref", {})))
    eng = ServingEngine(cfg, prm, EngineConfig(
        **BASE, control=control, **kw.get("port", {})), device="cpu")
    return ref, eng


def _same_run(ref, eng, want, got):
    for r, w in zip(got, want):
        assert (r.finish_time == -1.0) == (w.finish_time == -1.0), r.rid
        assert (r.replica, r.tier, r.generated) == \
            (w.replica, w.tier, w.generated), f"request {r.rid}"
    assert eng.control.metrics() == ref.control.metrics()
    assert (eng.steps, eng.completed, eng.in_system) == \
        (ref.steps, ref.completed, ref.in_system)
    np.testing.assert_array_equal(eng._parked, ref._parked)
    np.testing.assert_array_equal(eng.router.active_mask,
                                  ref.router.active_mask)
    np.testing.assert_array_equal(eng.sojourn_hist, ref.sojourn_hist)


ADMISSION = [
    {"name": "queue_threshold", "options": {"threshold": 3}},
    {"name": "token_bucket", "options": {"rate": 0.25, "burst": 4}},
]


@pytest.mark.parametrize("control", ADMISSION,
                         ids=["queue_threshold", "token_bucket"])
def test_engine_admission_sheds_as_reference(model, monkeypatch, control):
    ref, eng = _engines(model, monkeypatch, control)
    want = ref.run_until_drained(_mk_reqs(rengine.Request, model[0], 12),
                                 max_steps=300)
    got = eng.run_until_drained(_mk_reqs(Request, model[2], 12),
                                max_steps=300)
    _same_run(ref, eng, want, got)
    shed = [r for r in got if r.finish_time == -1.0]
    m = eng.control.metrics()
    assert m["ctl_shed"] == len(shed) > 0
    assert m["ctl_admitted"] == len(got) - len(shed) == eng.completed
    assert eng.in_system == 0 and eng.queue_depths.sum() == 0
    assert all(r.replica == -1 and r.generated is None for r in shed)


def test_engine_autoscale_parks_as_reference(model, monkeypatch):
    control = {"name": "autoscale",
               "options": {"p95_high": 1e9, "p95_low": 1e8, "down_after": 2,
                           "cooldown": 2, "min_servers": 1,
                           "step_frac": 0.5}}
    ref, eng = _engines(model, monkeypatch, control,
                        ref={"tracer": REventRecorder()},
                        port={"tracer": EventRecorder()})
    want = ref.run_until_drained(_mk_reqs(rengine.Request, model[0], 10),
                                 max_steps=300)
    got = eng.run_until_drained(_mk_reqs(Request, model[2], 10),
                                max_steps=300)
    _same_run(ref, eng, want, got)
    assert all(r.finish_time > 0 for r in got)   # parked replicas drained
    m = eng.control.metrics()
    assert m["ctl_active"] < 4 and eng._parked.sum() > 0
    assert eng.router.active_mask.sum() == m["ctl_active"]

    def scaled(tracer):
        return [(e["ts"], e["args"]["target"]) for e in tracer.events()
                if e["name"] == "autoscale"]

    assert scaled(eng.tracer) == scaled(ref.ecfg.tracer)
    assert scaled(eng.tracer)


def test_engine_traced_shed_instants_as_reference(model, monkeypatch):
    ref, eng = _engines(model, monkeypatch, ADMISSION[0],
                        ref={"tracer": REventRecorder()},
                        port={"tracer": EventRecorder()})
    ref.run_until_drained(_mk_reqs(rengine.Request, model[0], 8),
                          max_steps=300)
    eng.run_until_drained(_mk_reqs(Request, model[2], 8), max_steps=300)

    def instants(tracer, name):
        return [(e["ts"], e["args"]) for e in tracer.events()
                if e["name"] == name]

    for name in ("shed", "submit", "route"):
        assert instants(eng.tracer, name) == \
            instants(ref.ecfg.tracer, name), name
    assert instants(eng.tracer, "shed")


def test_engine_closed_loop_drains_as_reference(model, monkeypatch):
    """The closed-loop arm as the serving bench drives it: every step,
    poll the client pool with the completions so far and submit what it
    asks for, until 12 requests have completed."""
    control = {"name": "closed_loop",
               "options": {"users": 5, "think_time": 3.0}}
    ref, eng = _engines(model, monkeypatch, control)
    runs = []
    for e, cls, cfg in ((ref, rengine.Request, model[0]),
                        (eng, Request, model[2])):
        rng = np.random.default_rng(4)
        out, in_flight = [], []
        while e.completed < 12:
            for _ in range(e.control.clients.poll(e.steps, e.completed)):
                out.append(cls(rid=len(out), max_new_tokens=2,
                               prefix_id=len(out) % 3,
                               prompt=rng.integers(0, cfg.vocab_size,
                                                   8).astype(np.int32)))
                e.submit(out[-1])
            in_flight.append(e.control.clients.in_flight)
            e.step()
            assert e.steps < 400
        runs.append((out, in_flight))
    (want, want_flight), (got, got_flight) = runs
    assert got_flight == want_flight and max(got_flight) <= 5
    assert len(got) == len(want)
    _same_run(ref, eng, want, got)
