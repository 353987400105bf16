"""Whole dense runs with the port's replication lifecycle against the JAX
reference's.

(a) The replayed ``simulate(..., scenario, replication)`` returns the
    reference's metrics exactly, for Balanced-PANDAS, JSQ-MaxWeight and
    Blind-PANDAS.
(b) For fixed and repair, every lifecycle metric except ``lost_tasks`` is
    a function of the catalogue and the alive track alone, so on the
    port's own draws it equals the reference's `simulate` exactly, at
    Topology(12, 4), horizon 800.
"""

import numpy as np
import pytest

from repro.core import locality as rloc
from repro.core import simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.replication import ReplicationConfig as RReplicationConfig
from repro_torch import workloads as wl
from repro_torch.core import locality as loc
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PolicyConfig
from repro_torch.replication import ReplicationConfig, make_replication
from _torch_port import JaxDenseReplay, single_torch_thread  # noqa: F401

BATCH = 16
RATES = (0.5, 0.45, 0.25)
LIFECYCLE = ("availability", "data_loss_frac", "mean_replication",
             "final_replication", "repair_moves", "dropped_replicas",
             "migration_busy_slots", "max_concurrent_moves")


def _lam(rtopo):
    return np.float32(0.8 * rloc.capacity_hot_rack(rtopo, rloc.Rates(RATES),
                                                   0.5))


def _cfgs(horizon, warmup):
    rtopo, topo = rloc.Topology(12, 4), loc.Topology(12, 4)
    kw = dict(p_hot=0.5, max_arrivals=BATCH, horizon=horizon, warmup=warmup)
    return (rsim.SimConfig(rtopo, rloc.Rates(RATES), **kw),
            sim.SimConfig(topo, loc.Rates(RATES), **kw))


def _policy(name):
    if name == "blind_pandas":
        return (PolicyConfig(name, {"prior": RATES}),
                RPolicyConfig(name, {"prior": RATES}))
    return name, name


SIM_CASES = (("balanced_pandas", "repair", "server_loss", "uniform"),
             ("balanced_pandas", "popularity", "rack_loss", "spread"),
             ("jsq_maxweight", "repair", "rack_loss", "uniform"),
             ("jsq_maxweight", "fixed", "server_loss", "uniform"),
             ("blind_pandas", "popularity", "server_loss", "uniform"),
             ("blind_pandas", "repair", "rack_loss", "spread"))


@pytest.mark.parametrize("name,ctrl,scen,plc", SIM_CASES)
def test_replayed_simulate_equals_reference_metrics(name, ctrl, scen, plc):
    horizon, warmup, seed = 160, 40, 5
    rcfg, cfg = _cfgs(horizon, warmup)
    lam = _lam(rcfg.topo)
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol = _policy(name)
    want = rsim.simulate(rpol, rcfg, lam, est, seed=seed, scenario=scen,
                         placement=plc, replication=ctrl)
    sched = wl.compile_schedule(wl.make_scenario(scen), cfg.topo, horizon,
                                0.5, device="cpu")
    rep = make_replication(ctrl)
    src = JaxDenseReplay(name, [(seed, lam)], BATCH, cfg.topo.num_servers,
                         horizon, lam_mult=sched.lam_mult[sched.seg].numpy(),
                         placement=plc,
                         reads=(rep.num_chunks, rep.read_skew))
    got = sim.simulate(pol, cfg, lam, est, seed=seed, scenario=scen,
                       placement=plc, replication=ctrl, device="cpu",
                       rng=src)
    assert got == want
    assert set(LIFECYCLE) <= set(got)


@pytest.mark.parametrize("ctrl", ("fixed", "repair"))
@pytest.mark.parametrize("scen", ("server_loss", "rack_loss"))
def test_lifecycle_follows_no_draw(ctrl, scen):
    """On the port's own draws (not the reference's), every lifecycle
    metric but `lost_tasks` equals the reference's: fixed and repair
    read no chunk popularity, so the catalogue and the alive track alone
    decide them."""
    rcfg, cfg = _cfgs(800, 200)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    want = rsim.simulate("balanced_pandas", rcfg, 3.0, est, seed=0,
                         scenario=scen, replication=ctrl)
    got = sim.sweep("balanced_pandas", cfg, [3.0], est[None], [0, 1],
                    scenario=scen, replication=ctrl, device="cpu")
    for key in LIFECYCLE:
        assert (got[key] == want[key]).all(), key
    assert np.isfinite(got["mean_delay"]).all()
    if ctrl == "fixed":
        assert (got["repair_moves"] == 0).all()
    elif scen == "server_loss":   # rack_loss loses chunks for good
        assert (got["final_replication"] == 3.0).all()


def test_repair_options_pass_through_the_config():
    _, cfg = _cfgs(400, 100)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    out = sim.simulate("balanced_pandas", cfg, 3.0, est, seed=0,
                       scenario="server_loss", device="cpu",
                       replication=ReplicationConfig("repair", {"lanes": 2}))
    assert 0 < out["max_concurrent_moves"] <= 2
    want = rsim.simulate(
        "balanced_pandas", _cfgs(400, 100)[0], 3.0, est, seed=0,
        scenario="server_loss",
        replication=RReplicationConfig("repair", {"lanes": 2}))
    for key in LIFECYCLE:
        assert out[key] == want[key], key
