"""The port's drift study (`repro_torch.core.robustness.drift_study`)
against the JAX reference's: the same result layout, and delays inside a
stated band of the reference's with the port's own draws."""

import numpy as np
import pytest

from repro.core import robustness as rrb, simulator as rsim
from repro_torch import workloads as wl
from repro_torch.core import robustness as rb, simulator as sim
from _torch_port import single_torch_thread  # noqa: F401


def _weighted():
    return wl.Scenario("weighted", (
        wl.Segment(0.0),
        wl.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                   tier_mult=(1.0, 0.7, 0.5))))


# The drift study's band, measured on the CPU by tools/drift_band.py at
# Topology(24, 6), load 0.75, horizon 1500 / warmup 500: the reference's
# mean delay over seeds 0-23 against the port's own draws over three
# disjoint sets of 24 seeds.  stragglers: reference 4.145 (fixed prior)
# and 4.142 (blind EWMA), seed std 0.18; the port 2.4-3.5% above it in
# every set (seed std 0.17-0.22).  hot_shift: reference 3.336 and 3.377,
# seed std 0.10-0.11; the port 1.3-2.8% above (std 0.12-0.13).  The same
# 2-3% as the static study's (tests/test_torch_robustness.py), a property
# of the reference's key schedule.  The band is 12%: the largest gap, 3.5%,
# plus three standard errors of each 12-seed mean of the wider scenario
# (3 x 0.048 / sqrt(12) = 4.2% each, relative).
DRIFT_BAND = 0.12
DRIFT_BAND_SCENARIOS = ("stragglers", "hot_shift")


def test_drift_study_layout_and_delay_band_match_reference():
    kw = dict(seeds=tuple(range(12)))
    ref = rrb.drift_study(rrb.StudyConfig(
        sim=rsim.default_config(horizon=1500, warmup=500), **kw),
        DRIFT_BAND_SCENARIOS)
    port = rb.drift_study(rb.StudyConfig(
        sim=sim.default_config(horizon=1500, warmup=500), **kw),
        DRIFT_BAND_SCENARIOS, device="cpu")
    assert set(port) == set(ref)
    for key in ("capacity", "load", "arms", "scenarios"):
        assert port[key] == ref[key], key
    assert set(port["blind_wins"]) == set(ref["blind_wins"])
    lam = float(port["capacity"]) * 0.75
    for key in ("delay", "throughput", "final_n"):
        assert set(port[key]) == set(DRIFT_BAND_SCENARIOS)
        for scen in DRIFT_BAND_SCENARIOS:
            assert set(port[key][scen]) == set(port["arms"])
            for arm in port["arms"]:
                assert port[key][scen][arm].shape == \
                    ref[key][scen][arm].shape == (12,)
    for scen in DRIFT_BAND_SCENARIOS:
        for arm in port["arms"]:
            got = port["delay"][scen][arm].mean()
            want = ref["delay"][scen][arm].mean()
            assert got == pytest.approx(want, rel=DRIFT_BAND), (scen, arm)
            assert port["throughput"][scen][arm].mean() == \
                pytest.approx(lam, rel=0.02)
    assert rb.summarize_drift(port) == rrb.summarize_drift(port)
    assert rb.DRIFT_SCENARIOS == rrb.DRIFT_SCENARIOS


def test_drift_study_and_run_study_take_any_scenario_spec():
    """A mapping of labels to specs, as the reference's drift study takes
    one (a trace replay among them); `run_study` takes a scenario for
    every arm."""
    cfg = rb.StudyConfig(sim=sim.default_config(horizon=60, warmup=20),
                         loads=(0.7,), eps_grid=(0.2,), seeds=(0, 3))
    out = rb.drift_study(cfg, {
        "surge": wl.ScenarioConfig("flash_crowd", {"peak": 2.0}),
        "day": wl.ScenarioConfig("trace", {"name": "flash_day",
                                           "max_segments": 16}),
        "weighted": _weighted()}, device="cpu")
    assert out["scenarios"] == ("surge", "day", "weighted")
    for scen in out["scenarios"]:
        for arm in out["arms"]:
            assert np.isfinite(out["delay"][scen][arm]).all()
    text = rb.summarize_drift(out)
    assert text.splitlines()[1].startswith("surge")
    study = rb.run_study(cfg, algos=("balanced_pandas", "fifo"),
                         scenario="diurnal", device="cpu")
    assert study["delay"]["balanced_pandas"].shape == (1, 3, 2)
    assert np.isfinite(study["delay"]["fifo"]).all()
