"""The port's placement study (`repro_torch.core.robustness.placement_study`
and `summarize_placement`) against the JAX reference's on the CPU: the
same layout and grids, fluid capacities within Monte-Carlo error, the
same summary text on the same numbers, and, on the port's own draws,
Balanced-PANDAS's delays within `STUDY_BAND` of the reference's under
every placement, with every rack-aware placement below uniform.
"""

import pytest

from repro.core import robustness as rrb
from repro_torch.core import robustness as rb
from _torch_port import single_torch_thread  # noqa: F401


# Balanced-PANDAS's static delay on the port's own draws against the
# reference's at Topology(24, 6), load 0.7, horizon 600 / warmup 150, 16
# seeds: tools/placement_band.py measured gaps of 0.2-2.4% over three
# disjoint seed sets, and the largest gap plus three standard errors of
# the difference of two 16-seed means at 7.90% (uniform)
STUDY_BAND = 0.08
STUDY_SEEDS = tuple(range(16))
# fluid capacities from 300 sampled types on either side: the same tool
# measured uniform's std across sampling seeds at 1.84% (the rack-aware
# placements sit at the all-local bound, 12.0), so two independent
# samples need 7.82% (three standard deviations of their difference)
CAPACITY_RTOL = 0.08


def _study_cfg(mod, horizon, seeds):
    return mod.StudyConfig(
        sim=mod.sim.SimConfig(mod.loc.Topology(24, 6), mod.loc.Rates(),
                              horizon=horizon, warmup=horizon // 4),
        seeds=seeds)


def test_placement_study_matches_reference():
    kw = dict(policies=("balanced_pandas",), scenarios=("static",),
              load=0.7, capacity_samples=300)
    want = rrb.placement_study(_study_cfg(rrb, 600, STUDY_SEEDS), **kw)
    got = rb.placement_study(_study_cfg(rb, 600, STUDY_SEEDS), **kw,
                             device="cpu")
    assert rb.PLACEMENTS == rrb.PLACEMENTS
    assert rb.PLACEMENT_POLICIES == rrb.PLACEMENT_POLICIES
    assert rb.PLACEMENT_SCENARIOS == rrb.PLACEMENT_SCENARIOS
    assert set(got) == set(want)
    for key in ("placements", "policies", "scenarios", "load"):
        assert got[key] == want[key]
    assert got["capacity_uniform"] == pytest.approx(want["capacity_uniform"],
                                                    rel=1e-6)
    for plc in want["placements"]:
        assert got["capacity"][plc] == pytest.approx(want["capacity"][plc],
                                                     rel=CAPACITY_RTOL)
        for name in ("delay", "throughput", "final_n"):
            assert got[name][plc]["static"]["balanced_pandas"].shape == \
                (len(STUDY_SEEDS),)
        d_got = float(got["delay"][plc]["static"]["balanced_pandas"].mean())
        d_want = float(want["delay"][plc]["static"]["balanced_pandas"].mean())
        assert abs(d_got - d_want) <= STUDY_BAND * d_want, (plc, d_got,
                                                            d_want)
        if plc != "uniform":   # rack-aware placements beat uniform
            assert d_got < float(got["delay"]["uniform"]["static"]
                                 ["balanced_pandas"].mean())
    # the same numbers give the same text
    assert rb.summarize_placement(want) == rrb.summarize_placement(want)
    got["capacity"]["spread"] = None   # the scipy-less cell
    assert rb.summarize_placement(got) == rrb.summarize_placement(got)


def test_placement_study_grid_and_summary():
    """The default grid (every placement x the three policies x the three
    scenarios) at a short horizon: each cell's (S,) arrays, and the
    reference's `summarize_placement` text on the port's numbers."""
    cfg = _study_cfg(rb, 40, (0, 1))
    study = rb.placement_study(cfg, capacity_samples=50, device="cpu")
    assert study["placements"] == rrb.PLACEMENTS
    assert study["policies"] == rrb.PLACEMENT_POLICIES
    assert study["scenarios"] == rrb.PLACEMENT_SCENARIOS
    for plc in rrb.PLACEMENTS:
        for scen in rrb.PLACEMENT_SCENARIOS:
            for pol in rrb.PLACEMENT_POLICIES:
                for name in ("delay", "throughput", "final_n"):
                    assert study[name][plc][scen][pol].shape == (2,)
    assert rb.summarize_placement(study) == rrb.summarize_placement(study)
    labelled = rb.placement_study(cfg, placements=("spread",),
                                  policies=("jsq_maxweight",),
                                  scenarios={"moved": "hot_shift"},
                                  capacity_samples=50, device="cpu")
    assert labelled["scenarios"] == ("moved",)
    assert rb.summarize_placement(labelled) == \
        rrb.summarize_placement(labelled)
