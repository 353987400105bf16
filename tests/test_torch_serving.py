"""The port's serving path (`repro_torch.serve.engine` and the host
routers, estimator, placement and histogram it uses) against the JAX
reference on the CPU.

Routers and the estimator are numpy on both sides, so under one seed and
one scripted sequence of route/claim/on_complete calls they must make
identical decisions and estimates.  The engine's routing depends on wall
clock (the observed prefill time feeds the EWMA estimator, in the
reference too), so the engines are compared on what does not: the tokens
each request generates.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.core import estimator as rest, locality as rloc
from repro.core import policy as rpol
from repro.core import cluster as rcluster
from repro.models import params as RP
from repro.placement import policies as rplace
from repro.serve import engine as rengine
from repro.telemetry import recorder as rrec
from repro_torch.configs import registry
from repro_torch.core import cluster, estimator, locality as loc, policy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import params as P
from repro_torch.placement import make_placement, policies as place
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from repro_torch.telemetry import EventRecorder, percentiles_from_hist
from _torch_port import single_torch_thread  # noqa: F401

ROUTERS = ("balanced_pandas", "pandas_po2", "jsq_maxweight", "fifo")
TOPOS = {"k3": (8, 4), "k4": (16, (2, 8))}
PRIORS = {"k3": (1.0, 0.7, 0.4), "k4": (1.0, 0.8, 0.6, 0.4)}


def _decision(d):
    return None if d is None else tuple(dataclasses.astuple(d))


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("name", ROUTERS)
def test_routers_make_the_reference_decisions(name, topo):
    m, groups = TOPOS[topo]
    prior = np.asarray(PRIORS[topo], np.float32)
    ref_est = rest.EwmaRateEstimator(m, prior)
    est = estimator.EwmaRateEstimator(m, prior)
    ref = rpol.make_router(name, rloc.Topology(m, groups), prior,
                           estimator=ref_est, seed=3)
    port = policy.make_router(name, loc.Topology(m, groups), prior,
                              estimator=est, seed=3)
    script = np.random.default_rng(11)
    k = prior.size
    for _ in range(400):
        op = script.integers(0, 3)
        if op == 0:
            locs = sorted(script.choice(m, 3, replace=False).tolist())
            assert _decision(port.route(locs)) == _decision(ref.route(locs))
        elif op == 1:
            w = int(script.integers(0, m))
            assert _decision(port.claim(w)) == _decision(ref.claim(w))
        else:
            args = (int(script.integers(0, m)), int(script.integers(0, k)),
                    float(script.exponential(0.5)))
            port.on_complete(*args)
            ref.on_complete(*args)
    np.testing.assert_array_equal(port.queue_depths(), ref.queue_depths())
    np.testing.assert_array_equal(est.rates, ref_est.rates)
    np.testing.assert_array_equal(est.sample_counts, ref_est.sample_counts)


def test_router_registry_and_tiers():
    assert policy.available_routers() == tuple(sorted(ROUTERS))
    with pytest.raises(ValueError, match="unknown router"):
        policy.make_router("slo_pandas", loc.Topology(4, 2), (1, 0.7, 0.4))
    spec, rspec = loc.Topology(16, (2, 8)), rloc.Topology(16, (2, 8))
    assert spec.num_workers == rspec.num_workers == 16
    rng = np.random.default_rng(0)
    for _ in range(20):
        locs = sorted(rng.choice(16, 3, replace=False).tolist())
        np.testing.assert_array_equal(cluster.worker_tiers(spec, locs),
                                      rcluster.worker_tiers(rspec, locs))
        w = int(rng.integers(0, 16))
        np.testing.assert_array_equal(cluster.pair_worker_tiers(spec, w),
                                      rcluster.pair_worker_tiers(rspec, w))
        assert cluster.tier_of(spec, locs, w) == rcluster.tier_of(rspec,
                                                                  locs, w)


def test_estimator_matches_reference():
    prior = np.asarray((1.0, 0.7, 0.4), np.float32)
    ref, port = (rest.EwmaRateEstimator(6, prior),
                 estimator.EwmaRateEstimator(6, prior))
    rng = np.random.default_rng(1)
    for _ in range(300):
        args = (int(rng.integers(0, 6)), int(rng.integers(0, 3)),
                float(rng.exponential(1.0)))
        ref.observe(*args)
        port.observe(*args)
        sub = sorted(rng.choice(6, 2, replace=False).tolist())
        np.testing.assert_array_equal(port.rates_for(sub), ref.rates_for(sub))
    np.testing.assert_array_equal(port.rates, ref.rates)


def test_chunk_replicas_match_reference():
    for hosts, seed in ((4, 0), (16, 1), (10008, 0)):
        for cid in range(200 if hosts < 1000 else 5):
            assert place.chunk_replicas(cid, hosts, 3, seed) == \
                rplace.chunk_replicas(cid, hosts, 3, seed)
    uniform = make_placement(None)
    assert uniform.replicas(loc.Topology(4, 2), 7, 3, 0) == \
        rplace.UniformPlacement().replicas(rloc.Topology(4, 2), 7, 3, 0)
    hdfs = make_placement("hdfs")
    for cid in range(32):
        assert hdfs.replicas(loc.Topology(8, 4), cid, 3, 0) == \
            rplace.HdfsPlacement().replicas(rloc.Topology(8, 4), cid, 3, 0)


def test_percentiles_from_hist_matches_reference():
    rng = np.random.default_rng(2)
    for counts in (rng.integers(0, 9, 65), np.zeros(9), np.r_[0, 0, 5]):
        np.testing.assert_array_equal(
            percentiles_from_hist(counts, 0.5, (0.5, 0.95, 0.99)),
            rrec.percentiles_from_hist(counts, 0.5, (0.5, 0.95, 0.99)))


# ----------------------------------------------------------------- engine --

ARCH = "chatglm3_6b"
ECFG = dict(num_replicas=4, replicas_per_pod=2, slots_per_replica=2,
            max_len=64, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def model():
    """tests/test_serving_engine.py's model: the chatglm3-6b smoke config
    with PRNGKey(0) weights, on both sides."""
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def _requests(cls, cfg, n, length, new, seed, prefix=lambda i: i):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           length).astype(np.int32),
                max_new_tokens=new, prefix_id=prefix(i)) for i in range(n)]


def test_engine_generates_the_reference_tokens(model):
    """The prompts and engine of
    tests/test_serving_engine.py::test_engine_matches_direct_greedy: the
    port (prefill through the kernel's plain version) and the reference
    (its XLA prefill) generate the same tokens, request by request."""
    rcfg, rprm, cfg, prm = model
    ref = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(**ECFG))
    want = ref.run_until_drained(_requests(rengine.Request, rcfg, 6, 10, 4, 1),
                                 max_steps=100)
    eng = ServingEngine(cfg, prm, EngineConfig(**ECFG), device="cpu")
    got = eng.run_until_drained(_requests(Request, cfg, 6, 10, 4, 1),
                                max_steps=100)
    for r, w in zip(got, want):
        assert len(r.generated) == 5
        assert r.generated == w.generated, f"request {r.rid}"
    assert sum(eng.assign_tiers.values()) == 6
    assert eng.in_system == 0 and eng.completed == 6
    p50, p95, p99 = eng.sojourn_percentiles()
    assert 0 < p50 <= p95 <= p99 < np.inf


@pytest.mark.parametrize("scheduler", ROUTERS)
def test_all_schedulers_drain(model, scheduler):
    _, _, cfg, prm = model
    ecfg = EngineConfig(**dict(ECFG, num_replicas=2, scheduler=scheduler))
    reqs = _requests(Request, cfg, 6, 6, 2, 3, prefix=lambda i: i % 3)
    out = ServingEngine(cfg, prm, ecfg, device="cpu").run_until_drained(
        reqs, max_steps=200)
    assert all(r.finish_time > 0 and len(r.generated) == 3 for r in out)


def test_oversubscribed_engine_drains_on_every_replica(model):
    _, _, cfg, prm = model
    reqs = _requests(Request, cfg, 24, 8, 3, 2, prefix=lambda i: i % 4)
    eng = ServingEngine(cfg, prm, EngineConfig(**ECFG), device="cpu")
    out = eng.run_until_drained(reqs, max_steps=400)
    assert all(r.finish_time > 0 for r in out)
    assert len({r.replica for r in out}) == ECFG["num_replicas"]
    assert eng.queue_depths.sum() == 0


@pytest.mark.parametrize("field,value,slice_name", [
    ("tracer", EventRecorder, "telemetry"),
    ("control", {"name": "queue_threshold", "options": {"threshold": 3}},
     "control")])
def test_unported_engine_settings_raise(model, field, value, slice_name):
    """The telemetry slice's `tracer=` is taken (its events:
    tests/test_torch_events.py); the control slice's `control=` sheds and
    drains (tests/test_torch_control_serving.py), and a name that is no
    registered controller raises the reference's error."""
    _, _, cfg, prm = model
    if slice_name == "telemetry":
        tracer = value()
        eng = ServingEngine(cfg, prm, EngineConfig(**ECFG, tracer=tracer),
                            device="cpu")
        assert eng.tracer is tracer
        assert [e["args"]["name"] for e in tracer.events()] == [
            "serving_engine", "router"] + [f"replica{i}" for i in range(4)]
        return
    eng = ServingEngine(cfg, prm, EngineConfig(**dict(ECFG, **{
        field: value})), device="cpu")
    reqs = _requests(Request, cfg, 10, 8, 2, 0, prefix=lambda i: i % 3)
    out = eng.run_until_drained(reqs, max_steps=400)
    shed = [r for r in out if r.finish_time == -1.0]
    assert eng.control.metrics()["ctl_shed"] == len(shed) > 0
    assert eng.completed == len(out) - len(shed) and eng.in_system == 0
    assert eng.queue_depths.sum() == 0
    from repro.control import make_controller as rmake
    with pytest.raises(ValueError) as want:
        rmake("admission")
    with pytest.raises(ValueError) as got:
        ServingEngine(cfg, prm, EngineConfig(**dict(ECFG, control=(
            "admission"))), device="cpu")
    assert str(got.value) == str(want.value)


def test_scenario_slowdowns_reach_the_router(model, monkeypatch):
    """Under "stragglers" every observed prefill time is the base time x
    the reference playback's slowdown of that replica and tier at that
    step.  A stubbed clock makes the base exactly 1.0; the submissions
    are timed by the scenario's arrival plan (`arrival_steps`), as the
    reference's serving bench times them, so admissions fall inside the
    straggler window."""
    from repro import workloads as rwl
    from repro_torch import workloads as wl
    from repro_torch.serve import engine as engine_mod
    _, _, cfg, prm = model
    horizon = 24
    ticks = iter(range(1 << 30))

    class Clock:   # each read half a second after the last
        @staticmethod
        def monotonic():
            return 0.5 * next(ticks)

    monkeypatch.setattr(engine_mod, "time", Clock)
    eng = ServingEngine(cfg, prm, EngineConfig(**dict(
        ECFG, scenario="stragglers", scenario_horizon=horizon)),
        device="cpu")
    seen = []
    on_complete = eng.router.on_complete

    def record(replica, tier, elapsed):
        seen.append((eng.steps, replica, tier, elapsed))
        return on_complete(replica, tier, elapsed)

    eng.router.on_complete = record
    reqs = _requests(Request, cfg, 12, 6, 3, 5, prefix=lambda i: i % 5)
    when = wl.arrival_steps(eng.playback, len(reqs), len(reqs) / horizon)
    nxt = 0
    while any(r.finish_time == 0.0 for r in reqs):
        while nxt < len(reqs) and when[nxt] <= eng.steps:
            eng.submit(reqs[nxt])
            nxt += 1
        eng.step()
        assert eng.steps < 200
    spec = eng.spec
    want = rwl.host_playback(rwl.make_scenario("stragglers"),
                             spec.num_servers, float(horizon),
                             num_tiers=spec.num_tiers,
                             rack_of=np.asarray(spec.rack_of))
    assert len(seen) == len(reqs)
    for step, replica, tier, elapsed in seen:
        assert elapsed == 1.0 * want.slowdown(step, replica, tier)
    slowed = [s for s in seen if s[3] == 4.0]
    assert slowed and all(s[1] in (0, 1) and 6 <= s[0] < 18 for s in slowed)
    assert any(s[3] == 1.0 for s in seen)


def test_engine_defaults_match_reference():
    ours = dataclasses.asdict(EngineConfig())
    theirs = dataclasses.asdict(rengine.EngineConfig())
    assert ours == theirs


def test_launcher_on_cpu(capsys):
    launch_serve.main(["--requests", "4", "--scheduler", "fifo"],
                      device="cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith("scheduler=fifo drained 4 requests in ")
    assert "tier mix {0:" in line


# ------------------------------------------------------- the Mamba engine --

MAMBA_ECFG = dict(num_replicas=2, replicas_per_pod=1, slots_per_replica=2,
                  max_len=64, prefill_buckets=(16, 32))


def test_mamba_engine_generates_the_reference_tokens():
    """mamba2-1.3b's smoke config with PRNGKey(0) weights on both sides:
    prompts of 9-27 tokens (none a bucket length) that span both buckets,
    so each prefill runs pad steps through the SSM state.  The port's
    engine (prefill through the SSD kernel's plain version) and the
    reference's (its XLA prefill) generate the same tokens, request by
    request."""
    rcfg = rregistry.get_smoke_config("mamba2_13b")
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = registry.get_smoke_config("mamba2_13b")
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    lengths = (9, 27, 14, 20, 11, 31)

    def requests(cls):
        rng = np.random.default_rng(4)
        return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               n).astype(np.int32),
                    max_new_tokens=4, prefix_id=i) for i, n in
                enumerate(lengths)]

    ref = rengine.ServingEngine(rcfg, rprm,
                                rengine.EngineConfig(**MAMBA_ECFG))
    want = ref.run_until_drained(requests(rengine.Request), max_steps=100)
    eng = ServingEngine(cfg, prm, EngineConfig(**MAMBA_ECFG), device="cpu")
    assert all(rep.prefill_impl == "pallas_ssd" for rep in eng.replicas)
    got = eng.run_until_drained(requests(Request), max_steps=100)
    for r, w in zip(got, want):
        assert len(r.generated) == 5
        assert r.generated == w.generated, f"request {r.rid}"
    assert eng.in_system == 0 and eng.completed == len(lengths)


def test_launcher_serves_mamba_on_cpu(capsys, monkeypatch):
    """`--arch mamba2_13b` serves the smoke config, and prints the
    reference launcher's line: the same steps and tier mix (all four
    requests are routed on the prior rates before any completes), the
    wall-clock latency aside."""
    import re

    from repro.launch import serve as rserve

    args = ["--arch", "mamba2_13b", "--requests", "4"]
    launch_serve.main(args, device="cpu")
    line = capsys.readouterr().out.strip()
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    rserve.main()
    want = capsys.readouterr().out.strip()
    assert line.startswith("scheduler=balanced_pandas drained 4 requests "
                           "in ")
    latency = re.compile(r"mean latency \d+ms")
    assert latency.search(line)
    assert latency.sub("", line) == latency.sub("", want)
