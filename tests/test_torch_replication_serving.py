"""The replication lifecycle on the port's serving engine and in its
replication study, against the JAX reference's on the CPU.

(a) The reference test's engine shape (tests/test_replication.py: the
    chatglm3-6b smoke config, ``server_loss`` + ``repair``,
    ``scenario_horizon=12``, requests drip-fed through the loss window)
    drains, repairs and stays available; the lifecycle runs on the engine
    step clock, so after the same steps its `state_dict()` equals the
    reference engine's.  The gate: None/"fixed" without failures builds
    nothing.
(b) Post-repair replica rows of the port's host lifecycle equal the
    reference's and drive the port's `wwl_route`/`maxweight_claim` (their
    plain versions on the CPU) to the reference oracle's choices.
(c) `replication_study` has the reference's layout, shapes and gates,
    and `summarize_replication` gives the reference's text on the same
    numbers.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.core import locality as rloc, robustness as rrb
from repro.kernels import ref as rref
from repro.models import params as RP
from repro.placement import make_placement as rmake_placement
from repro.replication import make_replication as rmake_replication
from repro.serve import engine as rengine
from repro.telemetry import EventRecorder as REventRecorder
from repro_torch.configs import registry
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.placement import make_placement
from repro_torch.replication import make_replication
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.telemetry import EventRecorder
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "chatglm3_6b"
BASE = dict(num_replicas=4, replicas_per_pod=2, slots_per_replica=2,
            max_len=64, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def model():
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def _drip(eng, request, cfg, steps=30):
    """tests/test_replication.py's drive: two requests a step for 30
    steps, then steps until drained."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(steps):
        for _ in range(2):
            rid = len(out)
            req = request(rid=rid, max_new_tokens=2, prefix_id=rid % 6,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              8).astype(np.int32))
            eng.submit(req)
            out.append(req)
        eng.step()
    while any(r.finish_time == 0.0 for r in out) and eng.steps < 200:
        eng.step()
    return out


def test_engine_replication_gate_and_repair(model):
    rcfg, rprm, cfg, prm = model
    for spec in (None, "fixed"):
        assert ServingEngine(cfg, prm, EngineConfig(**BASE, replication=spec),
                             device="cpu").replication is None
    ecfg = dict(BASE, scenario="server_loss", replication="repair",
                scenario_horizon=12)
    ref = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(
        **ecfg, tracer=REventRecorder()))
    eng = ServingEngine(cfg, prm, EngineConfig(**ecfg,
                                               tracer=EventRecorder()),
                        device="cpu")
    # the engine installs its tracer on the lifecycle
    assert eng.replication is not None and \
        eng.replication.tracer is eng.tracer
    want, got = _drip(ref, rengine.Request, rcfg), _drip(eng, Request, cfg)
    assert all(r.finish_time > 0 and len(r.generated) == 3 for r in got)
    for e in (ref, eng):   # the same engine-step clock on both
        while e.steps < max(ref.steps, eng.steps):
            e.step()
    assert eng.replication.moves > 0          # the window forced repairs
    assert eng.replication.availability() == pytest.approx(1.0)
    assert eng.replication.state_dict() == ref.replication.state_dict()
    # the lifecycle's events follow the step clock alone: the reference's

    def lifecycle(tracer):
        return [e for e in tracer.events()
                if e.get("cat") in ("failure", "replication")]
    assert lifecycle(eng.tracer) == lifecycle(ref.tracer)
    assert any(e["name"] == "repair_commit" for e in lifecycle(eng.tracer))
    assert eng.lost_routes == ref.lost_routes == 0
    assert eng.routed == len(want) == len(got)
    # a failure track engages the lifecycle under the default controller
    fixed = ServingEngine(cfg, prm, EngineConfig(**dict(
        BASE, scenario="rack_loss", scenario_horizon=12)), device="cpu")
    assert fixed.replication is not None
    assert fixed.replication.ctrl.name == "fixed"


def test_engine_dead_replica_inflates_observed_time(model, monkeypatch):
    """A stubbed clock makes every prefill take 2.0 (each read is one
    tick later; the prefill reads it once): an admission on a migration
    endpoint reports it divided by the contention, on a dead replica
    multiplied by DEAD_SLOWDOWN, as the reference's engine scales them."""
    _, _, cfg, prm = model
    ticks = iter(range(1 << 30))

    class Clock:
        @staticmethod
        def monotonic():
            return float(next(ticks))

    monkeypatch.setattr(engine_mod, "time", Clock)
    eng = ServingEngine(cfg, prm, EngineConfig(**dict(
        BASE, scenario="server_loss", replication="repair",
        scenario_horizon=12)), device="cpu")
    rep, seen = eng.replication, []

    def on_complete(worker, tier, elapsed):
        want = 2.0 / rep.contention_mult(worker)
        if not rep.is_alive(worker):
            want *= engine_mod.DEAD_SLOWDOWN
        seen.append((elapsed, want))

    eng.router.on_complete = on_complete
    reqs = _drip(eng, Request, cfg, steps=12)
    assert all(r.finish_time > 0 for r in reqs)
    assert engine_mod.DEAD_SLOWDOWN == rengine.DEAD_SLOWDOWN == 25.0
    assert len(seen) == len(reqs)
    assert all(got == want for got, want in seen)
    assert any(want > 2.0 for _, want in seen)   # contention was observed


def test_post_repair_rows_feed_both_kernels():
    """tests/test_replication.py's post-repair rows at Topology(24, (4,
    12)), servers 0, 5 and 7 dead: the port's rows equal the reference's,
    and the port's `wwl_route`/`maxweight_claim` on them equal the
    reference's plain oracles."""
    rates = np.asarray([0.5, 0.45, 0.35, 0.25])
    rtopo, topo = rloc.Topology(24, (4, 12)), loc.Topology(24, (4, 12))
    rhost = rmake_replication("repair").build_host(
        rtopo, rmake_placement(None), 16, 3, 0, rates)
    host = make_replication("repair").build_host(
        topo, make_placement(None), 16, 3, 0, rates)
    alive = np.ones(24, bool)
    alive[[0, 5, 7]] = False
    for t in range(200):
        rhost.observe(float(t), alive)
        host.observe(float(t), alive)
    rows = [host.replicas_for(c) for c in range(9)]
    assert rows == [rhost.replicas_for(c) for c in range(9)]
    assert all(len(r) == 3 and alive[r].all() for r in rows)
    anc = np.array(topo.ancestors, np.int32)
    rng = np.random.default_rng(3)
    m, b = 24, 9
    wlv = rng.uniform(0, 50, m).astype(np.float32)
    er = np.tile(rates, (m, 1)).astype(np.float32)
    tl = np.asarray(rows, np.int32)
    got = ops.wwl_route(*(torch.as_tensor(x) for x in (wlv, er, anc, tl)))
    want = rref.wwl_route(wlv, er, anc, tl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q = np.bincount(tl.ravel(), minlength=m).astype(np.float32)
    ids = rng.choice(m, b, replace=False).astype(np.int32)
    er2 = np.tile(rates, (b, 1)).astype(np.float32)
    got = ops.maxweight_claim(*(torch.as_tensor(x) for x in (
        q, anc, ids, anc[:, ids], er2)))
    want = rref.maxweight_claim(q, anc, ids, anc[:, ids], er2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _study_cfg(mod):
    return mod.StudyConfig(
        sim=mod.sim.SimConfig(mod.loc.Topology(12, 4), mod.loc.Rates(),
                              p_hot=0.5, max_arrivals=16, horizon=600,
                              warmup=150), seeds=(0,))


def test_replication_study_shapes_and_gates():
    """tests/test_replication.py's study cell on the port, then the
    reference's text for the same numbers."""
    assert rb.REPLICATIONS == rrb.REPLICATIONS
    assert rb.REPLICATION_SCENARIOS == rrb.REPLICATION_SCENARIOS
    assert rb.REPLICATION_POLICIES == rrb.REPLICATION_POLICIES
    kw = dict(replications=("fixed", "repair"), scenarios=("server_loss",),
              policies=("balanced_pandas",), loads=(0.7,))
    study = rb.replication_study(_study_cfg(rb), **kw, device="cpu")
    a = study["availability"]["server_loss"]["repair"]["balanced_pandas"]
    assert a.shape == (1, 1)
    mv = study["repair_moves"]["server_loss"]
    assert float(mv["repair"]["balanced_pandas"].mean()) > 0
    assert float(mv["fixed"]["balanced_pandas"].mean()) == 0
    text = rb.summarize_replication(study)
    assert "server_loss" in text and "repair" in text
    assert text == rrb.summarize_replication(study)
    want = rrb.replication_study(_study_cfg(rrb), **kw)
    assert set(study) == set(want)
    for key in ("capacity", "replications", "scenarios", "policies"):
        assert study[key] == want[key]
    np.testing.assert_array_equal(study["loads"], want["loads"])
    for m in ("availability", "data_loss", "mean_replication",
              "repair_moves"):   # the lifecycle follows no draw
        for ctrl in ("fixed", "repair"):
            np.testing.assert_array_equal(
                study[m]["server_loss"][ctrl]["balanced_pandas"],
                want[m]["server_loss"][ctrl]["balanced_pandas"])
    # a missing lifecycle metric prints n/a, as the reference prints it
    study["availability"]["server_loss"]["fixed"]["balanced_pandas"] = None
    assert rb.summarize_replication(study) == \
        rrb.summarize_replication(study)
