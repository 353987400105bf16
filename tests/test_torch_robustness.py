"""The port's robustness study (`repro_torch.core.robustness`) against the
JAX reference's: the same result layout, and delays inside a stated band
of the reference's with the port's own draws.

Band, measured on the CPU at Topology(24, 6), rho = 0.8, horizon 2000:
the reference's mean Balanced-PANDAS delay over seeds 0-23 was 3.677
(seed std 0.084); the port's own draws gave 3.736, 3.759 and 3.745 over
three sets of 24 seeds, and independent numpy draws of the same law
3.757 over 48.  So the port sits about 2% above the reference, which is
a property of the reference's draws, not of the port (JSQ-MaxWeight:
3.321 against 3.362, 1.2%).  The band is 6%: that gap plus three
standard errors of each 12-seed mean.
"""

import numpy as np
import pytest

from repro.core import robustness as rrb, simulator as rsim
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from _torch_port import single_torch_thread  # noqa: F401

BAND = 0.06


def test_study_layout_and_delay_band_match_reference():
    kw = dict(loads=(0.8,), eps_grid=(0.2,), seeds=tuple(range(12)))
    algos = ("balanced_pandas", "jsq_maxweight")
    ref = rrb.run_study(rrb.StudyConfig(
        sim=rsim.default_config(horizon=1500, warmup=500), **kw),
        algos=algos, signs=(-1,))
    port = rb.run_study(rb.StudyConfig(
        sim=sim.default_config(horizon=1500, warmup=500), **kw),
        algos=algos, signs=(-1,), device="cpu")
    assert set(port) == set(ref)
    assert port["est_settings"] == ref["est_settings"]
    assert port["capacity"] == ref["capacity"]
    np.testing.assert_array_equal(port["lam"], ref["lam"])
    for key in ("delay", "throughput", "final_n"):
        assert set(port[key]) == set(ref[key]) == set(algos)
        for algo in algos:
            assert port[key][algo].shape == ref[key][algo].shape == (1, 2, 12)
    for algo in algos:
        got, want = port["delay"][algo].mean(), ref["delay"][algo].mean()
        assert got == pytest.approx(want, rel=BAND), algo
        lam = float(port["lam"][0])
        assert port["throughput"][algo].mean() == pytest.approx(lam, rel=0.02)


def test_every_policy_runs_the_study_grid():
    cfg = rb.StudyConfig(sim=sim.default_config(horizon=60, warmup=20),
                         loads=(0.5, 0.9), eps_grid=(0.1, 0.3),
                         seeds=(0, 5, 9))
    out = rb.run_study(cfg, device="cpu")
    assert list(out["delay"]) == list(rb.RATE_AWARE + rb.RATE_OBLIVIOUS)
    assert len(out["est_settings"]) == 5
    for algo, d in out["delay"].items():
        e = 5 if algo in rb.RATE_AWARE else 1
        assert d.shape == out["throughput"][algo].shape == (2, e, 3)
        assert np.isfinite(d).all()
    sens = rb.sensitivity(out["delay"]["balanced_pandas"])
    assert sens.shape == (2, 4)
    ref_sens = rrb.sensitivity(out["delay"]["balanced_pandas"])
    np.testing.assert_array_equal(sens, ref_sens)
    text = rb.summarize(out)
    assert text == rrb.summarize(out)
    assert "per_server-10%" in text and "fifo" in text


@pytest.mark.parametrize("study,slice_name", [
    ("tail_study", "telemetry"), ("control_study", "control")])
def test_later_studies_raise_naming_their_slice(study, slice_name):
    """The studies of the telemetry and control slices run, with the
    reference's keys and shapes (their numbers:
    tests/test_torch_tail.py, tests/test_torch_control_study.py)."""
    assert getattr(rb, study).__name__ == getattr(rrb, study).__name__
    if slice_name == "control":
        kw = dict(max_arrivals=16, horizon=60, warmup=15)
        args = dict(policies=("balanced_pandas",), arms=("none", "both"),
                    loads=(0.9, 0.99))
        got = rb.control_study(rb.StudyConfig(
            sim=sim.default_config(**kw), seeds=(0, 1, 2)), device="cpu",
            **args)
        want = rrb.control_study(rrb.StudyConfig(
            sim=rsim.default_config(**kw), seeds=(0, 1, 2)), **args)
        assert set(got) == set(want)
        for m in ("mean", "p50", "p95", "p99", "shed_rate", "throughput"):
            for arm in args["arms"]:
                assert got[m]["balanced_pandas"][arm].shape == \
                    want[m]["balanced_pandas"][arm].shape == (2, 3)
        assert np.isnan(got["shed_rate"]["balanced_pandas"]["none"]).all()
        assert np.isfinite(got["shed_rate"]["balanced_pandas"]["both"]).all()
        return
    cfg = rb.StudyConfig(sim=sim.SimConfig(
        loc.Topology(12, 4), loc.Rates(), max_arrivals=16, horizon=120,
        warmup=30), seeds=(0, 1))
    out = rb.tail_study(cfg, policies=("fifo",), loads=(0.9,),
                        device="cpu")
    for key in ("mean", "p50", "p95", "p99", "dropped", "unmatched"):
        assert out[key]["fifo"].shape == (1, 2)


def test_default_study_matches_reference():
    for fast in (False, True):
        got, want = rb.default_study(fast), rrb.default_study(fast)
        for field in ("loads", "high_loads", "eps_grid", "error_mode",
                      "seeds"):
            assert tuple(np.atleast_1d(getattr(got, field))) == \
                tuple(np.atleast_1d(getattr(want, field)))
        assert (got.sim.horizon, got.sim.warmup, got.sim.max_arrivals) == \
            (want.sim.horizon, want.sim.warmup, want.sim.max_arrivals)
    assert rb.EPS_GRID == rrb.EPS_GRID
    assert rb.RATE_AWARE == rrb.RATE_AWARE
    assert rb.RATE_OBLIVIOUS == rrb.RATE_OBLIVIOUS
