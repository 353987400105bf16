"""`repro_torch.core.simulator.simulate` end to end on the fleet path:
replayed metrics equal the reference's exactly; with its own generator
it serves the offered load and its delay stays inside a band of the
reference fleet path; the engage rule and the refusals are the
reference's."""

import numpy as np
import pytest

from repro import replication as rrepl
from repro.core import locality as rloc, simulator as rsim
from repro.sharding import sim as rfs
from repro_torch import replication as repl
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.policy import (PolicyConfig, available_policies,
                                     make_policy)
from repro_torch.sharding import sim as fs
from _torch_port import JaxReplay, single_torch_thread  # noqa: F401


def test_replay_simulate_equals_reference_metrics():
    seed, m = 5, 24
    rtopo, rr = rloc.Topology(m, 4), rloc.Rates()
    lam = 0.8 * rloc.capacity_hot_rack(rtopo, rr, 0.5)
    kw = dict(horizon=300, warmup=100, p_hot=0.5,
              max_arrivals=max(8, int(2.2 * lam)))
    rcfg = rsim.SimConfig(topo=rtopo, true_rates=rr, **kw)
    cfg = sim.SimConfig(topo=loc.Topology(m, 4), true_rates=loc.Rates(), **kw)
    est = np.array(rloc.per_server_rates(rr.as_array(), m))
    # results are chunk-invariant (pinned in tests/test_fleet_scale.py);
    # a small chunk keeps the reference's compile short
    want = rfs.fleet_simulate("balanced_pandas", rcfg, lam, est, seed=seed,
                              fleet=rfs.FleetConfig(chunk=50, unroll=1))
    got = sim.simulate("balanced_pandas", cfg, lam, est, seed=seed,
                       fleet=True, device="cpu",
                       rng=JaxReplay([(seed, lam)], cfg.max_arrivals, m))
    assert got == want


def test_delay_band_vs_reference_fleet_path():
    """Topology(240, 6) at rho = 0.8, the reference's own band cell
    (tests/test_fleet_scale.py).  Seeds 0-3 of the reference fleet path
    gave mean_delay 4.040/4.068/4.021/4.024 and the port's (its own
    generator, CPU) 4.054/4.067/4.058/4.055: within 1% of each other.
    The band is 5%, a third of the 15% that the reference licenses for
    fleet against dense."""
    topo, rates = rloc.Topology(240, 6), rloc.Rates()
    lam = 0.8 * rloc.capacity_hot_rack(topo, rates, 0.5)
    kw = dict(horizon=2000, warmup=600, p_hot=0.5,
              max_arrivals=int(2.05 * lam))
    est = np.array(rloc.per_server_rates(rates.as_array(), 240))
    ref = rfs.fleet_simulate("balanced_pandas",
                             rsim.SimConfig(topo=topo, true_rates=rates, **kw),
                             lam, est, seed=0)
    cfg = sim.SimConfig(topo=loc.Topology(240, 6), true_rates=loc.Rates(),
                        **kw)
    port = sim.simulate("balanced_pandas", cfg, lam, est, seed=0,
                        fleet=True, device="cpu")
    assert port["throughput"] == pytest.approx(lam, rel=0.02)
    assert ref["throughput"] == pytest.approx(lam, rel=0.02)
    assert port["mean_delay"] == pytest.approx(ref["mean_delay"], rel=0.05)
    assert np.isfinite(port["final_n"]) and port["final_n"] > 0


# ---------------------------------------------------------------------------
# gating: the reference's reasons and engage rule


def _small(m=24):
    return (rsim.SimConfig(topo=rloc.Topology(m, 6), true_rates=rloc.Rates(),
                           p_hot=0.5, max_arrivals=16, horizon=100,
                           warmup=20),
            sim.SimConfig(topo=loc.Topology(m, 6), true_rates=loc.Rates(),
                          p_hot=0.5, max_arrivals=16, horizon=100,
                          warmup=20))


SEAM_CASES = (
    ("balanced_pandas", {}),
    ("pandas_po2", {}),
    ("fifo", {}),
    ("jsq_maxweight", {}),
    ("balanced_pandas", {"scenario": "server_loss"}),
    ("balanced_pandas", {"scenario": "static"}),
    ("balanced_pandas", {"placement": "hdfs"}),
    ("balanced_pandas", {"placement": "uniform"}),
    ("balanced_pandas", {"replication": "repair"}),
    ("balanced_pandas", {"replication": "fixed"}),
    ("balanced_pandas", {"replication": ("config", "fixed", {})}),
    ("balanced_pandas", {"replication": ("instance", "fixed", {})}),
    ("balanced_pandas", {"replication": ("config", "repair", {"lanes": 2})}),
    ("balanced_pandas", {"telemetry": True}),
    ("balanced_pandas", {"telemetry": False}),
)


def _args(kw, ref):
    """A case's seam arguments; a ``(kind, name, options)`` replication
    becomes a config or an instance of the reference's package (`ref`) or
    the port's."""
    args = [kw.get(a) for a in ("scenario", "placement", "replication",
                                "telemetry")]
    if isinstance(args[2], tuple):
        kind, name, opts = args[2]
        mod = rrepl if ref else repl
        args[2] = (mod.ReplicationConfig(name, opts) if kind == "config"
                   else mod.make_replication(name, **opts))
    return args


def test_fleet_supported_reasons_match_reference():
    rcfg, cfg = _small()
    for policy, kw in SEAM_CASES:
        assert fs.fleet_supported(policy, cfg, *_args(kw, False)) == \
            rfs.fleet_supported(policy, rcfg, *_args(kw, True)), (policy, kw)


def test_engage_rule_matches_reference():
    assert fs.FLEET_AUTO_THRESHOLD == rfs.FLEET_AUTO_THRESHOLD == 1024
    for m in (24, 1026):
        rcfg, cfg = _small(m)
        for fleet in (None, False, True):
            for policy, kw in SEAM_CASES:
                args, rargs = _args(kw, False), _args(kw, True)
                try:
                    want = rsim._fleet_engaged(fleet, policy, rcfg, *rargs)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        sim._fleet_engaged(fleet, policy, cfg, *args)
                    assert str(got.value) == str(e)
                else:
                    assert sim._fleet_engaged(fleet, policy, cfg,
                                              *args) == want
        with pytest.raises(ValueError, match="control"):
            sim._fleet_engaged(True, "balanced_pandas", cfg, None, None,
                               None, None, control="admission")
        assert not sim._fleet_engaged(None, "balanced_pandas", cfg, None,
                                      None, None, None, control="admission")


def test_unported_paths_raise_naming_their_slice():
    rcfg, cfg = _small()
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    # the control slice: the fleet path refuses a control plane with the
    # reference's message; the dense path runs it and grows ctl_* metrics
    bucket = {"name": "token_bucket", "options": {"rate": 3.0, "burst": 6}}
    with pytest.raises(ValueError) as want:
        rsim.simulate("balanced_pandas", rcfg, 5.0, est, fleet=True,
                      control=bucket)
    with pytest.raises(ValueError) as got:
        sim.simulate("balanced_pandas", cfg, 5.0, est, fleet=True,
                     device="cpu", control=bucket)
    assert str(got.value) == str(want.value)
    for fleet in (None, False):
        out = sim.simulate("balanced_pandas", cfg, 5.0, est, fleet=fleet,
                           device="cpu", control=bucket)
        assert out["ctl_offered"] == out["ctl_admitted"] + out["ctl_shed"]
        assert out["ctl_shed"] > 0
    grid = sim.sweep("balanced_pandas", cfg, [5.0], est[None], [0],
                     device="cpu", control=["queue_threshold", "autoscale"])
    for k in ("ctl_offered", "ctl_shed_rate", "ctl_active_mean",
              "ctl_active_min"):
        assert grid[k].shape == (1, 1, 1), k
    # "admission" is a kind, not a registered controller
    with pytest.raises(ValueError) as want:
        rsim.simulate("balanced_pandas", rcfg, 5.0, est,
                      control="admission")
    with pytest.raises(ValueError) as got:
        sim.simulate("balanced_pandas", cfg, 5.0, est, device="cpu",
                     control="admission")
    assert str(got.value) == str(want.value)
    # telemetry runs on the dense path; the fleet path refuses it with
    # the reference's message
    with pytest.raises(ValueError) as want:
        rsim.simulate("balanced_pandas", rcfg, 5.0, est, fleet=True,
                      telemetry=True)
    with pytest.raises(ValueError) as got:
        sim.simulate("balanced_pandas", cfg, 5.0, est, fleet=True,
                     telemetry=True, device="cpu")
    assert str(got.value) == str(want.value)
    for fleet in (None, False):
        out = sim.simulate("balanced_pandas", cfg, 5.0, est, fleet=fleet,
                           telemetry=True, device="cpu")
        assert out["delay_hist"].shape == (257,)
    grid = sim.sweep("balanced_pandas", cfg, [5.0], est[None], [0],
                     telemetry=True, device="cpu")
    assert grid["delay_p99"].shape == (1, 1, 1)
    with pytest.raises(ValueError, match="unsupported"):
        sim.simulate("fifo", cfg, 5.0, est, fleet=True, device="cpu")
    # placement runs on the dense path; the fleet path stays uniform-only
    # and refuses another placement with the reference's message
    rcfg, _ = _small()
    with pytest.raises(ValueError) as want:
        rsim.simulate("balanced_pandas", rcfg, 5.0, est, fleet=True,
                      placement="hdfs")
    for run in (lambda: sim.simulate("balanced_pandas", cfg, 5.0, est,
                                     fleet=True, placement="hdfs",
                                     device="cpu"),
                lambda: sim.sweep("balanced_pandas", cfg, [5.0], est[None],
                                  [0], fleet=True, placement="hdfs",
                                  device="cpu")):
        with pytest.raises(ValueError) as got:
            run()
        assert str(got.value) == str(want.value)
        assert "only uniform placement has a fleet sampler" in str(got.value)
    with pytest.raises(ValueError, match="lam_total"):
        sim.simulate("balanced_pandas", cfg, -1.0, est, fleet=True,
                     device="cpu")
    with pytest.raises(ValueError, match="lam_grid"):
        sim.sweep("balanced_pandas", cfg, [-0.5], est[None], [0],
                  device="cpu")
    # the dense path runs every registered policy: the reference's seven
    assert available_policies() == ("balanced_pandas", "blind_pandas",
                                    "fifo", "jsq_maxweight", "pandas_po2",
                                    "priority", "slo_pandas")
    for name in available_policies():
        out = sim.simulate(name, cfg, 5.0, est, fleet=False, device="cpu")
        assert np.isfinite(out["mean_delay"]) and out["throughput"] > 0
    zero = sim.simulate("balanced_pandas", cfg, 0.0, est, device="cpu")
    assert np.isnan(zero["mean_delay"]) and zero["mean_n"] == 0.0
    with pytest.raises(ValueError, match="d >= 1"):
        make_policy(PolicyConfig("pandas_po2", {"d": 0}))
    for bad in ({"rounds": 0}, {"fill_iters": 4}):
        with pytest.raises(ValueError):
            fs.FleetConfig(**bad)
