"""SLO-PANDAS's breach branch and the tail-latency study of the port,
against the JAX reference's.

(a) Under the replayed draws, with telemetry on at ``slo_target`` 2.0 and
    rho 0.99, SLO-PANDAS's state and the recorder's equal the
    reference's after every slot (read out of its compiled scan), the
    breach engages and moves the sample path away from Balanced-PANDAS;
    without telemetry SLO-PANDAS is Balanced-PANDAS bit for bit.
(b) `tail_study` under the replayed draws returns the reference's
    arrays exactly, and `summarize_tail` the reference's text.
"""

import numpy as np
import pytest
import torch

import jax

from repro.core import locality as rloc, robustness as rrb
from repro.core import simulator as rsim
from repro.core import slo_pandas as rslo
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.telemetry import recorder as rrec
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PolicyConfig
from repro_torch.telemetry import TelemetryConfig
from _torch_port import JaxDenseReplay, read_out_of_scan
from _torch_port import single_torch_thread  # noqa: F401

BATCH = 16
RATES = (0.5, 0.45, 0.25)


def _cfgs(horizon, warmup):
    kw = dict(p_hot=0.5, max_arrivals=BATCH, horizon=horizon, warmup=warmup)
    return (rsim.SimConfig(rloc.Topology(12, 4), rloc.Rates(RATES), **kw),
            sim.SimConfig(loc.Topology(12, 4), loc.Rates(RATES), **kw))


def test_slo_pandas_state_equals_reference_after_every_slot(monkeypatch):
    horizon, warmup, seed, target = 150, 30, 4, 2.0
    rcfg, cfg = _cfgs(horizon, warmup)
    lam = np.float32(0.99 * rloc.capacity_hot_rack(
        rcfg.topo, rloc.Rates(RATES), 0.5))
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    r_steps, r_tel = [], []
    read_out_of_scan(monkeypatch, rslo.SloPandasPolicy, "slot_step",
                     r_steps)
    read_out_of_scan(monkeypatch, rrec.SimTelemetry, "record", r_tel)
    want = rsim.simulate(RPolicyConfig("slo_pandas",
                                       {"slo_target": target}),
                         rcfg, lam, est, seed=seed, telemetry=True)
    jax.effects_barrier()
    assert len(r_steps) == len(r_tel) == horizon

    src = JaxDenseReplay("slo_pandas", [(seed, lam)], BATCH, 12, horizon)
    pol, init, step, _, tel = sim._build_dense_step(
        PolicyConfig("slo_pandas", {"slo_target": target}), cfg,
        torch.as_tensor(est)[None], "cpu", telemetry=True)
    carry, breached = init(), 0
    for t in range(horizon):
        breached += bool(tel.live_quantile(carry[-1], 0.99)[0] > target)
        carry = step(carry, t, src.slot(t))
        (r_state, r_compl) = r_steps[t]
        for field, got, ref in zip(carry[0]._fields, carry[0], r_state):
            np.testing.assert_array_equal(got[0].numpy(), ref,
                                          err_msg=f"{field} at slot {t}")
        for field, got, ref in zip(carry[-1]._fields, carry[-1], r_tel[t]):
            np.testing.assert_array_equal(got[0].numpy(), ref,
                                          err_msg=f"{field} at slot {t}")
    assert breached > horizon // 2          # the branch really ran
    got = sim._dense_metrics(pol, carry, torch.tensor([lam]), None, tel)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k][0], v, err_msg=k)


def test_breach_moves_the_path_and_no_telemetry_is_bp():
    """On the port's own draws: without telemetry SLO-PANDAS is
    Balanced-PANDAS in every metric; with it, at target 2.0 and rho
    0.99, the breach branch moves the sample path off Balanced-PANDAS's;
    at a target no p99 reaches it is Balanced-PANDAS again."""
    _, cfg = _cfgs(300, 60)
    lam = 0.99 * loc.capacity_hot_rack(cfg.topo, loc.Rates(RATES), 0.5)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    run = dict(cfg=cfg, lam_total=lam, est=est, seed=1, device="cpu")
    bp_off = sim.simulate("balanced_pandas", **run)
    assert sim.simulate("slo_pandas", **run) == bp_off
    bp_on = sim.simulate("balanced_pandas", telemetry=True, **run)
    slo = sim.simulate(PolicyConfig("slo_pandas", {"slo_target": 2.0}),
                       telemetry=True, **run)
    assert not np.array_equal(slo["delay_hist"], bp_on["delay_hist"])
    assert slo["mean_n"] != bp_on["mean_n"]
    far = sim.simulate(PolicyConfig("slo_pandas", {"slo_target": 1e6}),
                       telemetry=True, **run)
    for k, v in bp_on.items():
        np.testing.assert_array_equal(far[k], v, err_msg=k)


def test_tail_study_equals_reference(monkeypatch):
    """The reference's tail study and the port's, the port replaying the
    reference's draws of every sweep: the same arrays and the same
    text."""
    kw = dict(max_arrivals=BATCH, horizon=200, warmup=50)
    rcfg = rrb.StudyConfig(sim=rsim.default_config(**kw), seeds=(0, 1))
    cfg = rb.StudyConfig(sim=sim.default_config(**kw), seeds=(0, 1))
    want = rrb.tail_study(rcfg)
    real = sim.sweep

    def replayed(policy, scfg, lam, est, seeds, **opts):
        cells = [(int(s), lam_l) for lam_l in lam for _ in range(len(est))
                 for s in seeds]
        src = JaxDenseReplay(policy, cells, BATCH, scfg.topo.num_servers,
                             scfg.horizon)
        return real(policy, scfg, lam, est, seeds, rng=src, **opts)

    monkeypatch.setattr(sim, "sweep", replayed)
    got = rb.tail_study(cfg, device="cpu")
    assert rb.TAIL_POLICIES == rrb.TAIL_POLICIES
    assert rb.TAIL_LOADS == rrb.TAIL_LOADS
    assert set(got) == set(want) and got["policies"] == want["policies"]
    assert got["capacity"] == want["capacity"]
    np.testing.assert_array_equal(got["loads"], want["loads"])
    for m in ("mean", "p50", "p95", "p99", "dropped", "unmatched"):
        for pol in want["policies"]:
            assert got[m][pol].shape == (3, 2)
            np.testing.assert_array_equal(got[m][pol], want[m][pol],
                                          err_msg=f"{m}/{pol}")
    assert rb.summarize_tail(got) == rrb.summarize_tail(want)


def test_summarize_tail_flags_a_tail_flip():
    """`summarize_tail` gives the reference's text on the same numbers,
    the tail-flip line included."""
    study = {"capacity": 9.5, "loads": np.asarray([0.9, 0.99]),
             "policies": ("balanced_pandas", "fifo")}
    rng = np.random.default_rng(0)
    for m in ("mean", "p50", "p95", "p99"):
        study[m] = {p: rng.uniform(1, 50, (2, 3)) for p in study["policies"]}
    study["mean"]["balanced_pandas"][1] = 1.0   # mean winner ...
    study["p99"]["fifo"][1] = 0.5               # ... is not the p99 winner
    text = rb.summarize_tail(study)
    assert text == rrb.summarize_tail(study)
    assert "tail flip: mean winner balanced_pandas, p99 winner fifo" in text


@pytest.mark.parametrize("telemetry", [True, TelemetryConfig(stride=4)])
def test_run_study_passes_telemetry_through(telemetry):
    """`run_study(telemetry=...)` grows the percentile keys, shaped like
    the delays."""
    cfg = rb.StudyConfig(sim=sim.SimConfig(
        loc.Topology(12, 4), loc.Rates(), max_arrivals=BATCH, horizon=120,
        warmup=30), loads=(0.8,), eps_grid=(0.2,), seeds=(0, 1))
    out = rb.run_study(cfg, algos=("balanced_pandas", "fifo"),
                       telemetry=telemetry, device="cpu")
    for k in ("delay_p50", "delay_p95", "delay_p99"):
        for algo in ("balanced_pandas", "fifo"):
            assert out[k][algo].shape == out["delay"][algo].shape
    assert "delay_p99" not in rb.run_study(cfg, algos=("fifo",),
                                           device="cpu")
