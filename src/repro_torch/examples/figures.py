"""Paper-figure experiments (Figures 1-6 of Daghighi & Chen 2020) on the
port: the counterpart of `benchmarks/figures.py`.

Each function runs the corresponding experiment on the dense simulator
and returns tidy rows, the reference's dicts with the same keys in the
same order; `robustness_study` prints them and writes a CSV under
``experiments/figures_torch/``.

fig1  all four algorithms, exact parameters, load sweep
fig2  high-load closeup: Balanced-PANDAS vs JSQ-MaxWeight
fig3  delay under parameters LOWER than real (eps in 5..30%)
fig4  sensitivity (relative delay change) for fig3
fig5  delay under parameters HIGHER than real
fig6  sensitivity for fig5
drift (beyond-paper) fixed-prior vs blind-EWMA Balanced-PANDAS under the
      registered time-varying scenarios

Each ``fig*`` takes the reference's ``fast`` and two keywords: ``cfg``
(a `StudyConfig` in place of ``_study(fast)``) and ``device`` (None:
the card).  The rest of `benchmarks/` (the bench harnesses, `run.py`,
`compare.py`, `update_experiments.py`) is not ported here: it comes
with the port's benchmark, which writes ``BENCHMARK.json``.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from repro_torch.core import locality as loc, robustness as rb, simulator as sim


def _study(fast: bool) -> rb.StudyConfig:
    if fast:
        return rb.StudyConfig(
            sim=sim.default_config(horizon=6_000, warmup=1_500),
            loads=(0.6, 0.8, 0.9, 0.95), high_loads=(0.9, 0.95),
            eps_grid=(0.1, 0.2, 0.3), seeds=(0,))
    return rb.StudyConfig(
        sim=sim.default_config(horizon=30_000, warmup=8_000),
        loads=(0.5, 0.6, 0.7, 0.8, 0.9, 0.95),
        eps_grid=rb.EPS_GRID, seeds=(0, 1))


def _exact_rows(figure, algos, cfg: rb.StudyConfig, loads, device):
    """Rows of `figure`: each algo at exact rates over `loads`."""
    cap = loc.capacity_hot_rack(cfg.sim.topo, cfg.sim.true_rates,
                                cfg.sim.p_hot)
    lam = np.asarray(loads, np.float32) * cap
    exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]
    rows = []
    for algo in algos:
        res = sim.sweep(algo, cfg.sim, lam, exact, np.asarray(cfg.seeds),
                        device=device)
        d = res["mean_delay"].mean(axis=(1, 2))
        for load, delay in zip(loads, d):
            rows.append({"figure": figure, "algo": algo, "load": load,
                         "eps": 0.0, "sign": 0, "mean_delay": float(delay)})
    return rows


def fig1_precise(fast: bool = True, *, cfg: Optional[rb.StudyConfig] = None,
                 device=None):
    """All four algorithms with exact rate knowledge."""
    cfg = cfg or _study(fast)
    return _exact_rows("fig1", rb.RATE_AWARE + rb.RATE_OBLIVIOUS, cfg,
                       cfg.loads, device)


def fig2_highload(fast: bool = True, *, cfg: Optional[rb.StudyConfig] = None,
                  device=None):
    cfg = cfg or _study(fast)
    return _exact_rows("fig2", ("balanced_pandas", "jsq_maxweight"), cfg,
                       cfg.high_loads, device)


def _fig_err(fig: str, sign: int, fast: bool, cfg=None, device=None):
    """figs 3/5 (delay) + 4/6 (sensitivity) share one sweep."""
    cfg = cfg or _study(fast)
    cap = loc.capacity_hot_rack(cfg.sim.topo, cfg.sim.true_rates,
                                cfg.sim.p_hot)
    loads = cfg.high_loads if fast else cfg.loads[-4:]
    lam = np.asarray(loads, np.float32) * cap
    ests = [sim.make_estimates(cfg.sim, "network", 0.0, -1)]
    for eps in cfg.eps_grid:
        ests.append(sim.make_estimates(cfg.sim, cfg.error_mode, eps, sign))
    est_stack = np.stack(ests)
    rows = []
    for algo in rb.RATE_AWARE:
        res = sim.sweep(algo, cfg.sim, lam, est_stack, np.asarray(cfg.seeds),
                        device=device)
        d = res["mean_delay"].mean(-1)  # (L, E)
        for li, load in enumerate(loads):
            rows.append({"figure": fig, "algo": algo, "load": load,
                         "eps": 0.0, "sign": sign,
                         "mean_delay": float(d[li, 0])})
            for ei, eps in enumerate(cfg.eps_grid):
                rows.append({"figure": fig, "algo": algo, "load": load,
                             "eps": eps, "sign": sign,
                             "mean_delay": float(d[li, ei + 1]),
                             "sensitivity": float(
                                 (d[li, ei + 1] - d[li, 0]) / d[li, 0])})
    # rate-oblivious baselines appear once (their decisions ignore rates)
    exact = est_stack[:1]
    for algo in rb.RATE_OBLIVIOUS:
        res = sim.sweep(algo, cfg.sim, lam, exact, np.asarray(cfg.seeds),
                        device=device)
        d = res["mean_delay"].mean(-1)
        for li, load in enumerate(loads):
            rows.append({"figure": fig, "algo": algo, "load": load,
                         "eps": 0.0, "sign": sign,
                         "mean_delay": float(d[li, 0])})
    return rows


def fig34_under(fast: bool = True, *, cfg: Optional[rb.StudyConfig] = None,
                device=None):
    return _fig_err("fig3_4", -1, fast, cfg, device)


def fig56_over(fast: bool = True, *, cfg: Optional[rb.StudyConfig] = None,
               device=None):
    return _fig_err("fig5_6", +1, fast, cfg, device)


def fig_drift(fast: bool = True, scenarios=None, *,
              cfg: Optional[rb.StudyConfig] = None, device=None):
    """Drift study rows: mean delay of the fixed-prior vs blind-EWMA arms
    under each scenario (see `robustness.drift_study`)."""
    cfg = cfg or _study(fast)
    study = rb.drift_study(cfg, scenarios=scenarios or rb.DRIFT_SCENARIOS,
                           device=device)
    rows = []
    for scen in study["scenarios"]:
        for arm in study["arms"]:
            rows.append({"figure": "drift", "algo": arm, "scenario": scen,
                         "load": study["load"], "eps": 0.0, "sign": 0,
                         "mean_delay":
                             float(study["delay"][scen][arm].mean())})
    return rows


def headline_claims(rows) -> dict:
    """The paper's central claims, checked on the generated data.

    (1) fig1/2: PANDAS delay <= JSQ-MW delay at high load (the paper's
        headline comparison; the Priority deviation is reported
        separately).
    (2) figs 3-6: PANDAS dominates JSQ-MW at EVERY error setting, and its
        absolute delay deviation band (slots) is narrower.  Relative
        sensitivity would punish the algorithm with the lower baseline, so
        absolute deviation is compared — same quantity the paper's figs
        4/6 plot.
    (3) drift: under at least one time-varying scenario the blind EWMA
        estimator beats the (initially exact) fixed prior.
    """
    by = collections.defaultdict(list)
    for r in rows:
        by[(r["figure"], r["algo"])].append(r)

    out = {}
    for fig in ("fig1", "fig2"):
        f = {a: max(r["mean_delay"] for r in by[(fig, a)])
             for a in ("balanced_pandas", "jsq_maxweight")
             if (fig, a) in by}
        if len(f) == 2:
            out[f"{fig}_pandas_beats_jsq_mw"] = (
                f["balanced_pandas"] <= f["jsq_maxweight"])
    for fig in ("fig3_4", "fig5_6"):
        if ("fig3_4", "balanced_pandas") not in by and \
                (fig, "balanced_pandas") not in by:
            continue
        bp = {(r["load"], r["eps"]): r["mean_delay"]
              for r in by[(fig, "balanced_pandas")]}
        mw = {(r["load"], r["eps"]): r["mean_delay"]
              for r in by[(fig, "jsq_maxweight")]}
        common = sorted(set(bp) & set(mw))
        if not common:
            continue
        out[f"{fig}_pandas_dominates_jsq_mw"] = all(
            bp[k] <= mw[k] for k in common)
        band = lambda d: (max(d[k] for k in common)  # noqa: E731
                          - min(d[k] for k in common))
        out[f"{fig}_pandas_narrower_band"] = band(bp) <= band(mw)
    fix = {r["scenario"]: r["mean_delay"] for r in by[("drift", "fixed_prior")]}
    bl = {r["scenario"]: r["mean_delay"] for r in by[("drift", "blind_ewma")]}
    moving = sorted((set(fix) & set(bl)) - {"static"})
    if moving:
        out["drift_blind_beats_fixed_somewhere"] = any(
            bl[s] < fix[s] for s in moving)
    return out
