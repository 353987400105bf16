"""The SLO-control study of the port and a controlled sweep, against the
JAX reference's.

(a) `control_study` under the replayed draws of every sweep (both
    policies, the four arms, three loads, two seeds) returns the
    reference's arrays exactly, and `summarize_control` the reference's
    text; `control_arm_spec` gives the reference's arms.
(b) A replayed (L, E, S) sweep under closed loop with the deferring
    token bucket equals the reference's key for key; ``mean_delay``
    follows the reference's compiled sweep over a load axis (two float32
    divisions), one ulp at most from this program's (see the test).
"""

import numpy as np
import pytest

from repro.core import locality as rloc, robustness as rrb
from repro.core import simulator as rsim
from repro_torch import workloads as wl
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from _torch_port import JaxDenseReplay
from _torch_port import single_torch_thread  # noqa: F401

BATCH = 16


def _replayed(real, monkeypatch):
    """`sim.sweep` with the reference's draws of each call's cells."""
    def replayed(policy, scfg, lam, est, seeds, **opts):
        cells = [(int(s), lam_l) for lam_l in lam for _ in range(len(est))
                 for s in seeds]
        sched = wl.compile_schedule(wl.make_scenario(None), scfg.topo,
                                    scfg.horizon, scfg.p_hot, device="cpu")
        law = sim.build_control(opts.get("control"), scfg, sched,
                                "cpu")
        law = {} if law is None else law.count_law()
        src = JaxDenseReplay(getattr(policy, "name", policy), cells, BATCH,
                             scfg.topo.num_servers, scfg.horizon,
                             extra=law.get("extra_mult", 1.0),
                             think=law.get("users"))
        return real(policy, scfg, lam, est, seeds, rng=src, **opts)

    monkeypatch.setattr(sim, "sweep", replayed)


def test_control_study_equals_reference(monkeypatch):
    """The reference's study and the port's at a bucket of 80% of
    capacity and an SLO target of 4 slots, so the admission arm sheds
    and SLO-PANDAS's breach branch runs: the same arrays and text."""
    kw = dict(max_arrivals=BATCH, horizon=90, warmup=25)
    rcfg = rrb.StudyConfig(sim=rsim.default_config(**kw), seeds=(0, 1))
    cfg = rb.StudyConfig(sim=sim.default_config(**kw), seeds=(0, 1))
    opts = dict(admit_frac=0.8, slo_target=4.0)
    want = rrb.control_study(rcfg, **opts)
    _replayed(sim.sweep, monkeypatch)
    got = rb.control_study(cfg, device="cpu", **opts)
    assert rb.CONTROL_ARMS == rrb.CONTROL_ARMS
    assert rb.CONTROL_POLICIES == rrb.CONTROL_POLICIES
    assert rb.CONTROL_LOADS == rrb.CONTROL_LOADS
    assert set(got) == set(want)
    for k in ("capacity", "policies", "arms", "admit_frac", "slo_target"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["loads"], want["loads"])
    for m in ("mean", "p50", "p95", "p99", "shed_rate", "throughput"):
        for pol in want["policies"]:
            for arm in want["arms"]:
                assert got[m][pol][arm].shape == (3, 2)
                np.testing.assert_array_equal(
                    got[m][pol][arm], want[m][pol][arm],
                    err_msg=f"{m}/{pol}/{arm}")
    assert np.isnan(got["shed_rate"]["balanced_pandas"]["none"]).all()
    assert (got["shed_rate"]["balanced_pandas"]["admission"][2] > 0).all()
    text = rb.summarize_control(got)
    assert text == rrb.summarize_control(want)
    assert "beats uncontrolled p99" in text


@pytest.mark.parametrize("arm", ["none", "admission", "autoscale", "both"])
def test_control_arm_spec_equals_reference(arm):
    assert rb.control_arm_spec(arm, 9.5, 0.9) == \
        rrb.control_arm_spec(arm, 9.5, 0.9)


def test_sweep_equals_reference():
    """A replayed (L, E, S) sweep under closed loop (its count gathered
    from ``n_by_k`` cell by cell) with the deferring bucket equals the
    reference's, key for key."""
    rates = (0.45, 0.35, 0.2)
    kw = dict(p_hot=0.5, max_arrivals=BATCH, horizon=80, warmup=20)
    rcfg = rsim.SimConfig(rloc.Topology(12, 4), rloc.Rates(rates), **kw)
    cfg = sim.SimConfig(loc.Topology(12, 4), loc.Rates(rates), **kw)
    control = [{"name": "closed_loop", "options": {"users": 24,
                                                   "think_time": 2.7}},
               {"name": "token_bucket", "options": {
                   "rate": 3.1, "burst": 6.5, "defer": True,
                   "backlog_cap": 9.5}}]
    lams = np.asarray([2.0, 4.0], np.float32)
    est = np.stack([rsim.make_estimates(rcfg, "network", 0.0, -1),
                    rsim.make_estimates(rcfg, "per_server", 0.2, 1, 3)])
    seeds = np.asarray([0, 5])
    want = rsim.sweep("balanced_pandas", rcfg, lams, est, seeds,
                      control=control)
    cells = [(int(s), lam) for lam in lams for _ in range(len(est))
             for s in seeds]
    sched = wl.compile_schedule(wl.make_scenario(None), cfg.topo,
                                cfg.horizon, 0.5, device="cpu")
    law = sim.build_control(control, cfg, sched, "cpu").count_law()
    src = JaxDenseReplay("balanced_pandas", cells, BATCH, 12, cfg.horizon,
                         think=law["users"])
    got = sim.sweep("balanced_pandas", cfg, lams, est, seeds,
                    control=control, device="cpu", rng=src)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (2, 2, 2), k
        if k != "mean_delay":
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert (got["ctl_shed"] > 0).any() and (got["ctl_backlog"] > 0).any()
    # Little's law over the admitted rate: the port's two float32
    # divisions.  The reference's compiled program drops the unused load
    # axis here (closed loop ignores lam_total), and XLA then rewrites
    # a / (b / c) as (a * c) / b, as in its `simulate`: one ulp at most
    mean_n = np.asarray(want["mean_n"], np.float32)
    adm = np.asarray(want["ctl_admitted"], np.float32)
    n_meas = np.float32(cfg.horizon - cfg.warmup)
    np.testing.assert_array_equal(got["mean_delay"], mean_n / (adm / n_meas))
    np.testing.assert_array_equal(np.asarray(want["mean_delay"]),
                                  (mean_n * n_meas) / adm)
    assert (np.abs(got["mean_delay"] - want["mean_delay"])
            <= np.spacing(np.asarray(want["mean_delay"]))).all()
