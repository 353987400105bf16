"""The port's own draws under a scenario.

(a) ``"static"`` equals the run without a scenario bit for bit, and
    ``sweep[l, e, s]`` equals `simulate` cell by cell under a scenario.
(b) A segment's counts follow its rate; the other draws stay those of
    the static run; a weighted schedule adds the rack Gumbels.
(c) Failure-track scenarios run through the replication machinery
    (tests/test_torch_replication*.py holds it against the reference) and
    return its metrics; the fleet path stays static-only.
"""

import numpy as np
import pytest
import torch

from repro_torch import workloads as wl
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.policy import PolicyConfig
from _torch_port import single_torch_thread  # noqa: F401


def _weighted():
    return wl.Scenario("weighted", (
        wl.Segment(0.0),
        wl.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                   tier_mult=(1.0, 0.7, 0.5)),
        wl.Segment(0.7, hot_rack=2, p_hot=0.6, slow_servers={3: 0.5})))


def _spec(scenario):
    return _weighted() if scenario == "weighted" else scenario


def _policy(name, rates):
    return PolicyConfig(name, {"prior": rates}) \
        if name == "blind_pandas" else name


_SMALL = sim.SimConfig(topo=loc.Topology(12, 4), true_rates=loc.Rates(),
                       p_hot=0.5, max_arrivals=12, horizon=120, warmup=30)


@pytest.mark.parametrize("name", ("balanced_pandas", "blind_pandas",
                                  "jsq_maxweight", "fifo", "pandas_po2"))
def test_static_equals_no_scenario_bit_for_bit(name):
    cap = loc.capacity_hot_rack(_SMALL.topo, _SMALL.true_rates, 0.5)
    lams = np.asarray([0.6, 0.95], np.float32) * cap
    est = np.stack([sim.make_estimates(_SMALL, "network", 0.0, -1),
                    sim.make_estimates(_SMALL, "per_server", 0.3, 1)])
    seeds = np.asarray([4, 1])
    runs = [sim.sweep(name, _SMALL, lams, est, seeds, scenario=s,
                      device="cpu")
            for s in (None, "static", wl.ScenarioConfig("static"),
                      wl.make_scenario("static"))]
    for other in runs[1:]:
        assert set(other) == set(runs[0])
        for key, v in runs[0].items():
            np.testing.assert_array_equal(other[key], v, err_msg=key)


@pytest.mark.parametrize("name,scenario", [
    ("balanced_pandas", "flash_crowd"), ("blind_pandas", "stragglers"),
    ("jsq_maxweight", "weighted")])
def test_sweep_equals_simulate_cell_by_cell_under_scenario(name, scenario):
    spec = _spec(scenario)
    pol = _policy(name, _SMALL.true_rates.values)
    cap = loc.capacity_hot_rack(_SMALL.topo, _SMALL.true_rates, 0.5)
    lams = np.asarray([0.5, 0.9], np.float32) * cap
    est = np.stack([sim.make_estimates(_SMALL, "network", 0.0, -1),
                    sim.make_estimates(_SMALL, "per_server", 0.3, 1)])
    seeds = np.asarray([4, 1])
    grid = sim.sweep(pol, _SMALL, lams, est, seeds, scenario=spec,
                     device="cpu")
    static = sim.sweep(pol, _SMALL, lams, est, seeds, device="cpu")
    assert not np.array_equal(grid["mean_n"], static["mean_n"])
    for li, lam in enumerate(lams):
        for ei in range(2):
            for si, seed in enumerate(seeds):
                one = sim.simulate(pol, _SMALL, float(lam), est[ei],
                                   seed=int(seed), scenario=spec,
                                   device="cpu")
                for key, v in one.items():
                    assert v == grid[key][li, ei, si], (key, li, ei, si)


def test_scenario_arrivals_follow_the_segment_rate():
    """The port's own source: a segment's counts follow lam x lam_mult,
    uniforms and Gumbels stay those of the static run (common random
    numbers across scenarios of one weight layout), and a weighted
    schedule adds rack Gumbels."""
    from repro_torch.core.policy import make_policy
    from repro_torch.core.rng import DenseDeviceSource
    m, batch, horizon = 12, 12, 40
    lam = np.float32(6.0)
    plan = make_policy("balanced_pandas").draw_plan(m)
    scn = wl.Scenario("step", (wl.Segment(0.0, lam_mult=0.0),
                               wl.Segment(0.5, lam_mult=2.0)))
    sched = wl.compile_schedule(scn, _SMALL.topo, horizon, 0.5, device="cpu")
    src = DenseDeviceSource([(7, lam)], plan, batch, m, "cpu", sched)
    ref = DenseDeviceSource([(7, lam)], plan, batch, m, "cpu")
    for t in range(horizon):
        got, want = src.slot(t), ref.slot(t)
        for field in ("u_hot", "g_type", "u_serve", "route"):
            assert torch.equal(getattr(got, field), getattr(want, field))
        if t < horizon // 2:
            assert int(got.n[0]) == 0
        else:
            assert int(got.n[0]) >= int(want.n[0])
        assert got.g_rack is None
    wsched = wl.compile_schedule(_weighted(), _SMALL.topo, horizon, 0.5,
                                 device="cpu")
    d = DenseDeviceSource([(7, lam), (2, lam)], plan, batch, m, "cpu",
                          wsched).slot(0)
    assert d.g_rack.shape == (2, batch, _SMALL.topo.num_racks)


def test_failure_scenarios_raise_naming_replication():
    """The four failure-track specs that raised before the replication
    slice now run (the name is kept from then): each engages the
    lifecycle under the default "fixed" controller and returns its
    metrics, with the scenario's arrivals the same as the static run's."""
    est = sim.make_estimates(_SMALL, "network", 0.0, -1)
    down = wl.Scenario("down", (wl.Segment(0.0),
                                wl.Segment(0.5, down_servers=(1,))))
    static = sim.simulate("balanced_pandas", _SMALL, 5.0, est, device="cpu")
    for spec in ("server_loss", "rack_loss", down,
                 wl.ScenarioConfig("server_loss", {"servers": (3,)})):
        one = sim.simulate("balanced_pandas", _SMALL, 5.0, est,
                           scenario=spec, device="cpu")
        assert set(one) > set(static)
        assert one["repair_moves"] == 0.0 and one["availability"] <= 1.0
        assert one["mean_replication"] < 3.0   # the failure wiped replicas
        grid = sim.sweep(_policy("blind_pandas", (0.5, 0.45, 0.25)), _SMALL,
                         [5.0], est[None], [0], scenario=spec, device="cpu")
        assert grid["data_loss_frac"].shape == (1, 1, 1)
        assert np.isfinite(grid["mean_delay"]).all()
    # the fleet path stays static-only, as in the reference
    with pytest.raises(ValueError, match="only the static scenario"):
        sim.simulate("balanced_pandas", _SMALL, 5.0, est, fleet=True,
                     scenario="stragglers", device="cpu")
