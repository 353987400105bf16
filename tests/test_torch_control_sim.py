"""The control plane in the port's dense simulator, against the JAX
reference's.

(a) Under the replayed draws (`_torch_port.replay_control`: its
    `JaxDenseReplay` with closed loop's ``n_by_k`` table and open loop's
    ``extra``), the port's
    `CtlState` and the policy state equal the reference's after every
    slot, for the token bucket with and without defer, the queue
    threshold, open loop at ``extra_mult`` 0.8, closed loop (static and
    under a ``users_mult`` track), the autoscaler at 0.3 of capacity,
    and the token bucket with the autoscaler on SLO-PANDAS with
    telemetry.  The reference's per-slot states are read out of its
    compiled scan (`read_out_of_scan` around `SimControl.pre` and the
    policy's `slot_step`); the final metrics, ``ctl_*`` and
    ``mean_delay`` included, equal the reference's ``simulate`` (a
    replayed ``sweep``: tests/test_torch_control_study.py).
(b) On the port's own draws: ``control=None`` is the run without
    control, and open loop at ``extra_mult`` 1.0 keeps every policy's
    sample path, for every registered policy; conservation, the
    queue-threshold bound and the closed-loop bound hold; an autoscaler
    on a policy without mask support raises the reference's error.
"""

import pytest

from repro.core import simulator as rsim
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PolicyConfig, available_policies
from _torch_port import (CTL_BUCKET as BUCKET, CTL_CAP as CAP,
                         CTL_CLOSED as CLOSED, CTL_DEFER as DEFER,
                         CTL_RATES as RATES, CTL_SERVERS,
                         ctl_cfgs as _cfgs, replay_control, users_wave)
from _torch_port import single_torch_thread  # noqa: F401

# (id, policy, control, rho, telemetry, scenario)
ARMS = [
    ("bucket", "balanced_pandas", BUCKET, 1.3, None, False),
    ("bucket-defer", "balanced_pandas", DEFER, 1.3, None, False),
    ("threshold", "balanced_pandas",
     {"name": "queue_threshold", "options": {"threshold": 13}}, 1.3, None,
     False),
    ("open_loop-0.8", "balanced_pandas",
     {"name": "open_loop", "options": {"extra_mult": 0.8}}, 1.1, None,
     False),
    ("closed_loop", "balanced_pandas", CLOSED, 1.0, None, False),
    ("closed_loop-users_wave", "balanced_pandas", CLOSED, 1.0, None, True),
    ("autoscale", "balanced_pandas", "autoscale", 0.3, None, False),
    ("slo-bucket+autoscale", "slo_pandas", [BUCKET, "autoscale"], 0.99,
     True, False),
]


@pytest.mark.parametrize("arm,name,control,rho,telemetry,wave", ARMS,
                         ids=[a[0] for a in ARMS])
def test_state_equals_reference_after_every_slot(monkeypatch, arm, name,
                                                 control, rho, telemetry,
                                                 wave):
    want, _ = replay_control(monkeypatch, name, control, rho, telemetry,
                          users_wave if wave else None)
    # the arm did what it is for
    if arm.startswith(("bucket", "threshold")):
        assert want["ctl_shed"] > 0
    if "autoscale" in arm:
        assert want["ctl_active_min"] < CTL_SERVERS or arm.startswith("slo")


# -- on the port's own draws ------------------------------------------------

@pytest.mark.parametrize("policy", sorted(set(available_policies())))
def test_control_none_and_open_loop_keep_the_path(policy):
    """``control=None`` is the run without control, bit for bit; open loop
    at ``extra_mult`` 1.0 draws and routes the same, so every metric but
    the Little's-law mean (its denominator becomes the measured admitted
    rate) is unchanged, and no arrival is shed."""
    _, cfg = _cfgs(150, 40)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    opts = {"prior": RATES} if policy == "blind_pandas" else {}
    run = dict(policy=PolicyConfig(policy, opts), cfg=cfg,
               lam_total=0.9 * CAP, est=est, seed=1, device="cpu")
    off = sim.simulate(**run)
    assert sim.simulate(control=None, **run) == off
    assert not any(k.startswith("ctl_") for k in off)
    lg = sim.simulate(control="open_loop", **run)
    for k, v in off.items():
        if k != "mean_delay":
            assert lg[k] == v, (policy, k)
    assert lg["ctl_offered"] == lg["ctl_admitted"] and lg["ctl_shed"] == 0
    n_meas = cfg.horizon - cfg.warmup
    assert lg["mean_delay"] == pytest.approx(
        lg["mean_n"] / (lg["ctl_admitted"] / n_meas), rel=1e-6)


def test_admission_conserves_and_bounds():
    _, cfg = _cfgs(300, 75)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    run = dict(policy="balanced_pandas", cfg=cfg, lam_total=1.5 * CAP,
               est=est, seed=0, device="cpu")
    res = sim.simulate(control=BUCKET, **run)
    assert res["ctl_shed"] > 0
    assert res["ctl_offered"] == res["ctl_admitted"] + res["ctl_shed"]
    assert 0.0 < res["ctl_shed_rate"] < 1.0
    assert "ctl_backlog" not in res
    thr = sim.simulate(control={"name": "queue_threshold",
                                "options": {"threshold": 20}}, **run)
    assert thr["final_n"] <= 20 and thr["ctl_shed"] > 0
    n_meas = cfg.horizon - cfg.warmup
    assert thr["mean_delay"] == pytest.approx(
        thr["mean_n"] / (thr["ctl_admitted"] / n_meas), rel=1e-5)
    # the deferring bucket over a window from slot 0: offered == admitted
    # + shed + still deferred
    _, cfg0 = _cfgs(300, 0)
    run["cfg"] = cfg0
    dfr = sim.simulate(control=dict(DEFER, options=dict(
        DEFER["options"], backlog_cap=64.0)), **run)
    assert dfr["ctl_offered"] == dfr["ctl_admitted"] + dfr["ctl_shed"] \
        + dfr["ctl_backlog"]
    assert 0.0 <= dfr["ctl_backlog"] <= 64.0


@pytest.mark.parametrize("users,think,seed", [(7, 1.5, 0), (23, 6.3, 3),
                                              (40, 2.0, 1)])
def test_closed_loop_bound(users, think, seed):
    """At most ``users`` tasks in the system, and over a window from slot
    0: admitted == offered, admitted - completed == final_n."""
    _, cfg = _cfgs(200, 0)
    cfg = sim.SimConfig(cfg.topo, cfg.true_rates, max_arrivals=48,
                        horizon=200, warmup=0)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    res = sim.simulate("balanced_pandas", cfg, 1.0, est, seed=seed,
                       device="cpu", control={"name": "closed_loop",
                                              "options": {"users": users,
                                                          "think_time":
                                                          think}})
    assert res["ctl_offered"] == res["ctl_admitted"] and res["ctl_shed"] == 0
    completed = round(res["throughput"] * cfg.horizon)
    assert res["ctl_admitted"] - completed == res["final_n"]
    assert res["final_n"] <= users


def test_autoscale_needs_mask_support():
    rcfg, cfg = _cfgs(50, 10)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    for policy in ("jsq_maxweight", "fifo", "pandas_po2"):
        with pytest.raises(ValueError) as got:
            sim.simulate(policy, cfg, 1.0, est, device="cpu",
                         control="autoscale")
        with pytest.raises(ValueError) as want:
            rsim.simulate(policy, rcfg, 1.0, est, control="autoscale")
        assert "server_mask" in str(got.value)
        assert str(got.value) == str(want.value)
    res = sim.simulate("balanced_pandas", cfg, 0.3 * CAP, est, device="cpu",
                       control="autoscale")
    assert res["ctl_active_min"] <= res["ctl_active_mean"] < 12


def test_loadgen_without_a_count_law_raises():
    """The draw seam picks the count before the slot from a law it knows
    (open loop's and closed loop's); another loadgen is refused, not
    drawn at the configured rate."""
    from repro_torch.control import LoadGenController

    class Burst(LoadGenController):
        name = "burst"

        def sim_offered(self, in_flight, lam_total, knobs):
            return 2.0 * lam_total * knobs.lam_mult, None

    _, cfg = _cfgs(50, 10)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    with pytest.raises(ValueError, match="count law"):
        sim.simulate("balanced_pandas", cfg, 1.0, est, device="cpu",
                     control=Burst())
