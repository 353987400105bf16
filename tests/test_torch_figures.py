"""The port's paper figures (`repro_torch.examples.figures`) against the
reference's `benchmarks/figures.py`: under one stubbed `sim.sweep` (a
seeded numpy function of the grid, in both packages) every `fig*` gives
the same rows, key for key and value for value, `fig_drift` the same
rows from one canned drift study, and `headline_claims` the same claims
on those rows and on 50 seeded random row sets with ties and missing
figures."""

import numpy as np
import pytest

from repro.core import robustness as rrb, simulator as rsim
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from repro_torch.examples import figures
from _torch_port import reference_benchmark, stub_sweep

FIGS = ("fig1_precise", "fig2_highload", "fig34_under", "fig56_over")


@pytest.fixture
def ref_figures(monkeypatch):
    return reference_benchmark(monkeypatch, "figures")


@pytest.mark.parametrize("fast", (True, False))
@pytest.mark.parametrize("fig", FIGS)
def test_figure_rows_equal_reference(monkeypatch, ref_figures, fig, fast):
    stub_sweep(monkeypatch)
    ours = getattr(figures, fig)(fast, device="cpu")
    theirs = getattr(ref_figures, fig)(fast)
    assert ours == theirs
    assert [list(r) for r in ours] == [list(r) for r in theirs]
    assert len(ours) == {
        ("fig1_precise", True): 20, ("fig1_precise", False): 30,
        ("fig2_highload", True): 4, ("fig2_highload", False): 8,
        ("fig34_under", True): 28, ("fig34_under", False): 92,
        ("fig56_over", True): 28, ("fig56_over", False): 92}[fig, fast]


def test_cfg_overrides_the_figures_study(monkeypatch):
    """``cfg=`` replaces ``_study(fast)``: the grid and the simulator the
    sweep is given come from it."""
    seen = []
    stub_sweep(monkeypatch, seen=seen)
    cfg = rb.StudyConfig(sim=sim.SimConfig(loc.Topology(12, 4), loc.Rates(),
                                           max_arrivals=16, horizon=50,
                                           warmup=10),
                         loads=(0.5, 0.7), high_loads=(0.7,),
                         eps_grid=(0.2,), seeds=(3, 4))
    rows = figures.fig34_under(True, cfg=cfg, device="cpu")
    assert {r["load"] for r in rows} == {0.7}
    assert {r["eps"] for r in rows} == {0.0, 0.2}
    assert all(c is cfg.sim and list(s) == [3, 4] for c, s in seen)
    assert len(figures.fig1_precise(cfg=cfg, device="cpu")) == 5 * 2


def _canned_drift(scenarios):
    rng = np.random.default_rng(11)
    return {"load": 0.75, "arms": ("fixed_prior", "blind_ewma"),
            "scenarios": tuple(scenarios),
            "delay": {s: {a: rng.uniform(1, 9, 2).astype(np.float32)
                          for a in ("fixed_prior", "blind_ewma")}
                      for s in scenarios}}


@pytest.mark.parametrize("scenarios", (None, ("static", "mmpp")))
def test_fig_drift_rows_equal_reference(monkeypatch, ref_figures, scenarios):
    calls = []

    def canned(cfg, scenarios=rb.DRIFT_SCENARIOS, device=None, **kw):
        calls.append((cfg, tuple(scenarios)))
        return _canned_drift(scenarios)

    monkeypatch.setattr(rb, "drift_study", canned)
    monkeypatch.setattr(rrb, "drift_study", canned)
    ours = figures.fig_drift(True, scenarios, device="cpu")
    theirs = ref_figures.fig_drift(True, scenarios)
    assert ours == theirs and len(ours) == 2 * len(calls[0][1])
    assert calls[0][1] == calls[1][1] == (scenarios or rb.DRIFT_SCENARIOS)
    assert figures.headline_claims(ours) == ref_figures.headline_claims(
        theirs)


def test_headline_claims_on_stubbed_figures(monkeypatch, ref_figures):
    stub_sweep(monkeypatch)
    rows = [r for fig in FIGS for r in getattr(figures, fig)(True,
                                                             device="cpu")]
    claims = figures.headline_claims(rows)
    assert claims == ref_figures.headline_claims(rows)
    assert set(claims) == {
        "fig1_pandas_beats_jsq_mw", "fig2_pandas_beats_jsq_mw",
        "fig3_4_pandas_dominates_jsq_mw", "fig3_4_pandas_narrower_band",
        "fig5_6_pandas_dominates_jsq_mw", "fig5_6_pandas_narrower_band"}


def _random_rows(rng):
    """A row set over the claims' figures, algos, loads and eps with
    delays from three values (so ties are frequent); each figure and each
    (figure, algo) may be missing, and drift rows may be there."""
    figs = [f for f in ("fig1", "fig2", "fig3_4", "fig5_6")
            if rng.random() < 0.7]
    values = rng.choice([1.0, 2.0, 3.0], 3, replace=False)
    rows = []
    for fig in figs:
        for algo in ("balanced_pandas", "jsq_maxweight", "fifo"):
            if rng.random() < 0.2:
                continue
            for load in (0.9, 0.95):
                for eps in ((0.0,) if fig in ("fig1", "fig2")
                            else (0.0, 0.1, 0.3)):
                    if rng.random() < 0.1:
                        continue
                    rows.append({"figure": fig, "algo": algo, "load": load,
                                 "eps": eps, "sign": 0,
                                 "mean_delay": float(rng.choice(values))})
    if rng.random() < 0.5:
        for scen in ("static", "mmpp", "flash_crowd")[:rng.integers(1, 4)]:
            for arm in ("fixed_prior", "blind_ewma"):
                rows.append({"figure": "drift", "algo": arm,
                             "scenario": scen, "load": 0.75, "eps": 0.0,
                             "sign": 0,
                             "mean_delay": float(rng.choice(values))})
    return rows


def test_headline_claims_equal_reference_on_random_rows(ref_figures):
    rng = np.random.default_rng(29)
    keys = set()
    for _ in range(50):
        rows = _random_rows(rng)
        ours = figures.headline_claims(rows)
        assert ours == ref_figures.headline_claims(rows), rows
        keys |= {(k, v) for k, v in ours.items()}
    # the sets reach every claim both ways
    assert len(keys) == 14


def test_stub_is_a_function_of_the_grid(monkeypatch):
    stub_sweep(monkeypatch)
    lam = np.asarray([1.0, 2.0], np.float32)
    a = sim.sweep("fifo", None, lam, np.zeros((3, 4, 3)), [0])
    b = rsim.sweep("fifo", None, lam, np.zeros((3, 4, 3)), [0])
    c = sim.sweep("priority", None, lam, np.zeros((3, 4, 3)), [0])
    assert a["mean_delay"].shape == (2, 3, 1)
    np.testing.assert_array_equal(a["mean_delay"], b["mean_delay"])
    assert not np.array_equal(a["mean_delay"], c["mean_delay"])


def _old_study_claims(study):
    """chip_smoke.py's study claims as it computed them before it called
    `figures.headline_claims`, on the (L, E) seed means of BP and
    JSQ-MW."""
    bp, mw = (study["delay"][a].mean(-1)
              for a in ("balanced_pandas", "jsq_maxweight"))
    out = {"fig1_2_pandas_beats_jsq_mw": bool(bp[:, 0].max()
                                              <= mw[:, 0].max())}
    high = np.asarray(study["loads"]) >= 0.9
    for fig, sign in (("fig3_4", -1), ("fig5_6", 1)):
        cols = [0] + [e for e, (_, _, sg) in enumerate(study["est_settings"])
                      if sg == sign]
        b, w = bp[high][:, cols], mw[high][:, cols]
        out[f"{fig}_pandas_dominates_jsq_mw"] = bool((b <= w).all())
        out[f"{fig}_pandas_narrower_band"] = bool(b.max() - b.min()
                                                  <= w.max() - w.min())
    return out


def test_chip_smoke_study_claims_keep_their_old_values():
    """chip_smoke.py's `headline_claims(study)` builds figure rows from a
    `run_study` result and calls the ported `headline_claims`: on 300
    seeded studies shaped as `run_study` shapes them (a rate-oblivious
    policy has only the exact column; delays from three values, so ties
    are frequent) it gives what its own formula gave before, every claim
    both ways."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(6)
    loads = np.asarray([0.6, 0.8, 0.9, 0.95])
    settings = [("exact", 0.0, 0)] + [("per_server", eps, sign)
                                      for sign in (-1, 1)
                                      for eps in (0.1, 0.3)]
    seen = set()
    for _ in range(300):
        values = rng.choice([1.0, 2.0, 3.0, 4.0], 3, replace=False)
        study = {"loads": loads, "est_settings": settings,
                 "delay": {a: rng.choice(values, (4, len(settings), 2))
                           for a in rb.RATE_AWARE}}
        study["delay"].update({a: rng.choice(values, (4, 1, 2))
                               for a in rb.RATE_OBLIVIOUS})
        claims = smoke.headline_claims(study)
        assert claims == _old_study_claims(study), study
        seen |= set(claims.items())
    assert len(seen) == 10
