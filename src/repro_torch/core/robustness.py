"""Robustness study driver (paper §4), port of `repro.core.robustness`.

Sweeps load x estimation error for every registered algorithm and returns
the data behind Figures 1-6:

  fig1: all algorithms, exact parameters, load sweep;
  fig2: PANDAS vs JSQ-MW, exact parameters, high load;
  fig3/fig4: parameters LOWER than real by eps (delay, sensitivity);
  fig5/fig6: the same with parameters HIGHER than real.

Priority and FIFO never consult the rate estimates, so they run the exact
column only.  With ``fleet=True`` (or a topology of at least
`sharding.sim.FLEET_AUTO_THRESHOLD` servers) the Balanced-PANDAS and
power-of-d arms run the fleet path, each arm's whole (load x error x
seed) grid as one batch of cells (`sharding.sim.fleet_sweep`).

Drift study (`drift_study`): fixed-prior against blind-EWMA
Balanced-PANDAS under each time-varying scenario (`repro_torch.workloads`),
the experiment behind the paper's "change of traffic over time in
addition to estimation errors of processing rates".  Both arms start from
the exact static rates; the fixed prior never updates, the blind EWMA
policy (`blind_pandas`) keeps learning, so a blind win is pure
drift-tracking.

Placement study (`placement_study`): every registered placement x one
policy a family (full-scan PANDAS, blind EWMA PANDAS, MaxWeight) under
the scenarios that move locality and network structure, all at one
offered load (a fraction of the *uniform* static capacity), beside each
placement's fluid capacity (`repro_torch.placement.placement_capacity`).

Replication study (`replication_study`): every replication controller x
failure scenario x scheduler, at loads x the healthy static capacity:
what failure-driven repair and adaptive replication buy (availability,
data loss, replication factor) and cost (migration moves, delay).

Tail-latency study (`tail_study`): p50/p95/p99 sojourn from the
telemetry recorder next to the Little's-law mean for each scheduler at
heavy-traffic loads, where mean ordering and tail ordering can diverge.

SLO-control study (`control_study`): the control plane's arms (none,
admission, autoscale, both; `repro_torch.control`) x the mean-optimal and
the SLO-conditioned scheduler at heavy-traffic loads, telemetry on: what
each control lever buys at the tail.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.policy import PolicyConfig, PolicyLike
from repro_torch.placement import placement_capacity
from repro_torch.telemetry import span
from repro_torch.workloads import Scenario, ScenarioConfig, ScenarioLike

EPS_GRID = (0.05, 0.10, 0.15, 0.20, 0.25, 0.30)
RATE_AWARE = ("balanced_pandas", "pandas_po2", "jsq_maxweight")
RATE_OBLIVIOUS = ("priority", "fifo")
# Scenarios for the drift study: "static" is the control arm where the
# fixed prior is unbeatable (it is exact and never goes stale).
DRIFT_SCENARIOS = ("static", "diurnal", "flash_crowd", "mmpp", "hot_shift",
                   "stragglers", "rack_congestion")
# Placement-study grid: every registered placement x one representative
# policy per family (full-scan PANDAS, blind EWMA PANDAS, MaxWeight)
# under the two scenarios that move locality/network structure.
PLACEMENTS = ("uniform", "hdfs", "spread", "hot_aware")
PLACEMENT_POLICIES = ("balanced_pandas", "blind_pandas", "jsq_maxweight")
PLACEMENT_SCENARIOS = ("static", "hot_shift", "rack_congestion")
# Replication-lifecycle study grid: every shipped controller under the two
# failure scenarios, for the two schedulers whose robustness gap the paper
# cares about.  "fixed" is the no-repair control arm.
REPLICATIONS = ("fixed", "popularity", "repair")
REPLICATION_SCENARIOS = ("server_loss", "rack_loss")
REPLICATION_POLICIES = ("balanced_pandas", "jsq_maxweight")
# Tail-latency study grid: heavy-traffic loads where mean ordering and
# tail ordering can diverge, for the delay-optimal arm, the
# throughput-optimal arm, and the Hadoop floor.
TAIL_POLICIES = ("balanced_pandas", "jsq_maxweight", "fifo")
TAIL_LOADS = (0.90, 0.95, 0.99)
# SLO-control study grid: control-plane arms x {mean-optimal,
# SLO-conditioned} schedulers at heavy-traffic loads.
CONTROL_ARMS = ("none", "admission", "autoscale", "both")
CONTROL_POLICIES = ("balanced_pandas", "slo_pandas")
CONTROL_LOADS = (0.90, 0.95, 0.99)


@dataclasses.dataclass(frozen=True)
class StudyConfig:
    sim: sim.SimConfig
    loads: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
    high_loads: Sequence[float] = (0.90, 0.93, 0.95, 0.97)
    eps_grid: Sequence[float] = EPS_GRID
    error_mode: str = "per_server"
    seeds: Sequence[int] = (0, 1)


def default_study(fast: bool = False) -> StudyConfig:
    if fast:
        return StudyConfig(
            sim=sim.default_config(horizon=4_000, warmup=1_000),
            loads=(0.6, 0.8, 0.9), high_loads=(0.9, 0.95),
            eps_grid=(0.1, 0.3), seeds=(0,),
        )
    return StudyConfig(sim=sim.default_config(horizon=30_000, warmup=8_000))


def run_study(cfg: StudyConfig, algos: Optional[Sequence[str]] = None,
              signs: Sequence[int] = (-1, 1), scenario=None, placement=None,
              telemetry=None, fleet=None, device=None) -> Dict:
    """Returns nested results: delay[algo], throughput[algo] and
    final_n[algo] of shape (L, E, S) with E = 1 (exact) +
    len(eps_grid) * len(signs) for rate-aware algorithms and E = 1 for
    oblivious ones, plus the grids needed to plot.  With `telemetry`
    enabled (True / TelemetryConfig) the result grows
    delay_p50/delay_p95/delay_p99[algo] arrays of the same shape, the
    FCFS-coupled sojourn percentiles.  ``device=None`` runs on the
    card.  The call is the span ``study``, its estimates
    ``study.estimates`` (`repro_torch.telemetry.span`)."""
    with span("study"):
        algos = list(algos or (RATE_AWARE + RATE_OBLIVIOUS))
        cap = loc.capacity_hot_rack(cfg.sim.topo, cfg.sim.true_rates,
                                    cfg.sim.p_hot)
        lam = np.asarray(cfg.loads, np.float32) * cap
        seeds = np.asarray(cfg.seeds)

        with span("study.estimates"):
            est_settings = [("exact", 0.0, 0)]
            ests = [sim.make_estimates(cfg.sim, "network", 0.0, -1)]
            for sign in signs:
                for eps in cfg.eps_grid:
                    est_settings.append((cfg.error_mode, eps, sign))
                    ests.append(sim.make_estimates(cfg.sim, cfg.error_mode,
                                                   eps, sign))
            est_stack = np.stack(ests)

        out: Dict = {"capacity": cap, "loads": np.asarray(cfg.loads),
                     "lam": lam, "est_settings": est_settings,
                     "delay": {}, "throughput": {}, "final_n": {}}
        pct_keys = ("delay_p50", "delay_p95", "delay_p99")
        if telemetry is not None:
            for k in pct_keys:
                out[k] = {}
        for algo in algos:
            stack = est_stack if algo in RATE_AWARE else est_stack[:1]
            res = sim.sweep(algo, cfg.sim, lam, stack, seeds,
                            scenario=scenario, placement=placement,
                            telemetry=telemetry, fleet=fleet, device=device)
            out["delay"][algo] = res["mean_delay"]
            out["throughput"][algo] = res["throughput"]
            out["final_n"][algo] = res["final_n"]
            if telemetry is not None:
                for k in pct_keys:
                    out[k][algo] = res[k]
        return out


def sensitivity(delay_les: np.ndarray) -> np.ndarray:
    """Paper figs 4/6 metric: relative delay deviation from the
    exact-parameter run, per error setting.  delay_les: (L, E, S) ->
    (L, E-1), mean over seeds."""
    d = delay_les.mean(-1)
    return (d[:, 1:] - d[:, :1]) / d[:, :1]


def summarize(study: Dict) -> str:
    """Human-readable table of the study results."""
    lines = []
    settings = study["est_settings"]
    for algo, d in study["delay"].items():
        dm = d.mean(-1)  # (L, E)
        for li, load in enumerate(study["loads"]):
            cols = "  ".join(f"{dm[li, ei]:8.2f}"
                             for ei in range(dm.shape[1]))
            lines.append(f"{algo:16s} rho={load:4.2f}  {cols}")
        lines.append("")
    lines.append("columns: " + ", ".join(
        f"{m}{'' if s == 0 else ('-' if s < 0 else '+')}{e:.0%}"
        for (m, e, s) in settings))
    return "\n".join(lines)


def drift_study(cfg: StudyConfig,
                scenarios: Union[Sequence[str],
                                 Mapping[str, ScenarioLike]] = DRIFT_SCENARIOS,
                load: float = 0.75, device=None) -> Dict:
    """Fixed-prior vs blind-EWMA Balanced-PANDAS under each scenario.

    Both arms start from the exact static rates -- the *best possible*
    fixed prior -- so any blind win is pure drift-tracking, not prior
    quality.  Returns delay/throughput/final_n[scenario][arm] arrays of
    shape (S_seeds,) plus the winner per scenario.  `scenarios` is a
    sequence of registered names or a ``{label: ScenarioLike}`` mapping;
    results are keyed by the label either way.  ``device=None`` runs on
    the card.
    """
    scen_map = _scenario_map(scenarios)
    r = cfg.sim.true_rates
    arms: Dict[str, PolicyLike] = {
        "fixed_prior": "balanced_pandas",
        "blind_ewma": PolicyConfig("blind_pandas", {"prior": r.values}),
    }
    cap = loc.capacity_hot_rack(cfg.sim.topo, r, cfg.sim.p_hot)
    lam = np.asarray([load], np.float32) * cap
    seeds = np.asarray(cfg.seeds)
    est_exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]

    out: Dict = {"capacity": cap, "load": load, "arms": tuple(arms),
                 "scenarios": tuple(scen_map), "delay": {},
                 "throughput": {}, "final_n": {}}
    for scen, spec in scen_map.items():
        for name in ("delay", "throughput", "final_n"):
            out[name][scen] = {}
        for arm, policy in arms.items():
            res = sim.sweep(policy, cfg.sim, lam, est_exact, seeds,
                            scenario=spec, device=device)
            out["delay"][scen][arm] = res["mean_delay"][0, 0]
            out["throughput"][scen][arm] = res["throughput"][0, 0]
            out["final_n"][scen][arm] = res["final_n"][0, 0]
    out["blind_wins"] = {
        scen: float(out["delay"][scen]["blind_ewma"].mean())
        < float(out["delay"][scen]["fixed_prior"].mean())
        for scen in scen_map}
    return out


def summarize_drift(study: Dict) -> str:
    """Human-readable drift-study table (one row per scenario)."""
    width = max([16] + [len(s) for s in study["scenarios"]])
    lines = [f"{'scenario':{width}s} {'fixed_prior':>12s} {'blind_ewma':>12s}"
             f"  winner   (mean delay, slots; load "
             f"{study['load']:.2f} x static capacity)"]
    for scen in study["scenarios"]:
        d_fix = float(study["delay"][scen]["fixed_prior"].mean())
        d_bl = float(study["delay"][scen]["blind_ewma"].mean())
        win = "blind" if study["blind_wins"][scen] else "fixed"
        lines.append(f"{scen:{width}s} {d_fix:12.2f} {d_bl:12.2f}  {win}")
    return "\n".join(lines)


def _scenario_map(scenarios) -> Dict[str, ScenarioLike]:
    """``{label: ScenarioLike}`` from a sequence of registered names /
    scenarios or a mapping."""
    if isinstance(scenarios, Mapping):
        return dict(scenarios)
    return {s.name if isinstance(s, (Scenario, ScenarioConfig))
            else str(s): s for s in scenarios}


def placement_study(cfg: StudyConfig,
                    placements: Sequence[str] = PLACEMENTS,
                    policies: Sequence[str] = PLACEMENT_POLICIES,
                    scenarios: Union[Sequence[str],
                                     Mapping[str, ScenarioLike]]
                    = PLACEMENT_SCENARIOS,
                    load: float = 0.7,
                    capacity_samples: int = 2000, device=None) -> Dict:
    """Placement x policy x scenario sweep: what hierarchy-aware replica
    placement buys each scheduler.

    Every arm runs at the same offered load — `load` x the *uniform*
    static fluid capacity — so delay deltas across placements are
    placement effects, not load normalization artifacts.  Per placement
    the study also records the fluid capacity its replica distribution
    induces (None without scipy).  Returns
    delay/throughput/final_n[placement][scenario][policy] arrays of shape
    (S_seeds,).  ``device=None`` runs on the card.
    """
    scen_map = _scenario_map(scenarios)
    r = cfg.sim.true_rates
    arms: Dict[str, PolicyLike] = {
        str(p): (PolicyConfig("blind_pandas", {"prior": r.values})
                 if p == "blind_pandas" else p)
        for p in policies}
    cap = loc.capacity_hot_rack(cfg.sim.topo, r, cfg.sim.p_hot)
    lam = np.asarray([load], np.float32) * cap
    seeds = np.asarray(cfg.seeds)
    est_exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]

    out: Dict = {"capacity_uniform": cap, "load": load,
                 "placements": tuple(placements), "policies": tuple(arms),
                 "scenarios": tuple(scen_map),
                 "capacity": {}, "delay": {}, "throughput": {}, "final_n": {}}
    for plc in placements:
        out["capacity"][plc] = placement_capacity(
            cfg.sim.topo, r, cfg.sim.p_hot, plc,
            n_samples=capacity_samples, strict=False, device=device)
        for name in ("delay", "throughput", "final_n"):
            out[name][plc] = {scen: {} for scen in scen_map}
        for scen, spec in scen_map.items():
            for pol, policy in arms.items():
                res = sim.sweep(policy, cfg.sim, lam, est_exact, seeds,
                                scenario=spec, placement=plc, device=device)
                out["delay"][plc][scen][pol] = res["mean_delay"][0, 0]
                out["throughput"][plc][scen][pol] = res["throughput"][0, 0]
                out["final_n"][plc][scen][pol] = res["final_n"][0, 0]
    return out


def summarize_placement(study: Dict) -> str:
    """Human-readable placement-study table (scenario-major, one row per
    placement; columns are policies)."""
    pols = list(study["policies"])
    width = max([10] + [len(p) for p in study["placements"]])
    lines = [f"load {study['load']:.2f} x uniform static capacity "
             f"({study['capacity_uniform']:.2f} tasks/slot); "
             f"cells: mean delay (slots) over seeds"]
    header = f"{'placement':{width}s} {'fluid_cap':>9s}  " + \
        "  ".join(f"{p:>15s}" for p in pols)
    for scen in study["scenarios"]:
        lines.append(f"-- scenario: {scen}")
        lines.append(header)
        for plc in study["placements"]:
            cap = study["capacity"][plc]
            cap_s = f"{cap:9.2f}" if cap is not None else f"{'n/a':>9s}"
            cells = "  ".join(
                f"{float(study['delay'][plc][scen][p].mean()):15.2f}"
                for p in pols)
            lines.append(f"{plc:{width}s} {cap_s}  {cells}")
    return "\n".join(lines)


def replication_study(cfg: StudyConfig,
                      replications: Sequence[str] = REPLICATIONS,
                      scenarios: Union[Sequence[str],
                                       Mapping[str, ScenarioLike]]
                      = REPLICATION_SCENARIOS,
                      policies: Sequence[str] = REPLICATION_POLICIES,
                      loads: Sequence[float] = (0.7, 0.95),
                      device=None) -> Dict:
    """Replication-controller x failure-scenario x scheduler sweep: what
    adaptive replication and failure-driven repair buy (and cost) when the
    scenario actually kills servers.

    Every arm runs at `loads` x the static fluid capacity of the *healthy*
    cluster, with exact ("network", eps 0) estimates, so delay deltas
    under a loss window mix two effects the study separates: capacity
    lost to dead servers (visible in `availability` / `data_loss`) and
    foreground slots consumed by the re-replication storm (visible in
    `repair_moves` and the delay gap between the `fixed` control arm and
    the repairing controllers).  Returns per-metric nested dicts
    ``out[metric][scenario][controller][policy]`` with shape (L, S_seeds);
    replication metrics (availability, data_loss, mean_replication,
    repair_moves) come from the lifecycle machinery, which every failure
    scenario engages for all controllers including `fixed`.
    ``device=None`` runs on the card.
    """
    scen_map = _scenario_map(scenarios)
    r = cfg.sim.true_rates
    cap = loc.capacity_hot_rack(cfg.sim.topo, r, cfg.sim.p_hot)
    lam = np.asarray(loads, np.float32) * cap
    seeds = np.asarray(cfg.seeds)
    est_exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]

    metrics = ("delay", "throughput", "availability", "data_loss",
               "mean_replication", "repair_moves")
    src_key = {"delay": "mean_delay", "data_loss": "data_loss_frac"}
    out: Dict = {"capacity": cap, "loads": np.asarray(loads),
                 "replications": tuple(replications),
                 "scenarios": tuple(scen_map), "policies": tuple(policies)}
    for m in metrics:
        out[m] = {scen: {ctrl: {} for ctrl in replications}
                  for scen in scen_map}
    for scen, spec in scen_map.items():
        for ctrl in replications:
            for pol in policies:
                res = sim.sweep(pol, cfg.sim, lam, est_exact, seeds,
                                scenario=spec, replication=ctrl,
                                device=device)
                for m in metrics:
                    val = res.get(src_key.get(m, m))
                    out[m][scen][ctrl][pol] = (
                        None if val is None else val[:, 0])
    return out


def summarize_replication(study: Dict) -> str:
    """Human-readable replication-study table (scenario-major; one row per
    controller x load, columns per scheduler: delay / availability /
    data-loss / repair moves)."""
    pols = list(study["policies"])
    width = max([10] + [len(c) for c in study["replications"]])
    lines = [f"loads x healthy static capacity "
             f"({study['capacity']:.2f} tasks/slot); cells: "
             f"delay(slots) | avail | data_loss | repair_moves, "
             f"mean over seeds"]
    for scen in study["scenarios"]:
        lines.append(f"-- scenario: {scen}")
        lines.append(f"{'controller':{width}s} {'rho':>5s}  " +
                     "  ".join(f"{p:>34s}" for p in pols))
        for ctrl in study["replications"]:
            for li, rho in enumerate(study["loads"]):
                cells = []
                for p in pols:
                    d = float(study["delay"][scen][ctrl][p][li].mean())
                    av = study["availability"][scen][ctrl][p]
                    dl = study["data_loss"][scen][ctrl][p]
                    mv = study["repair_moves"][scen][ctrl][p]
                    if av is None:
                        cells.append(f"{d:9.2f} | {'n/a':>5s} | {'n/a':>6s}"
                                     f" | {'n/a':>5s}")
                    else:
                        cells.append(
                            f"{d:9.2f} | {float(av[li].mean()):5.3f} | "
                            f"{float(dl[li].mean()):6.4f} | "
                            f"{float(mv[li].mean()):5.0f}")
                lines.append(f"{ctrl:{width}s} {float(rho):5.2f}  " +
                             "  ".join(cells))
    return "\n".join(lines)


def tail_study(cfg: StudyConfig,
               policies: Sequence[str] = TAIL_POLICIES,
               loads: Sequence[float] = TAIL_LOADS,
               scenario: ScenarioLike = None,
               telemetry=True, device=None) -> Dict:
    """Heavy-traffic tail-latency study: p50/p95/p99 sojourn next to the
    Little's-law mean for each scheduler across a rho grid.

    Mean-delay ordering between schedulers need not match tail ordering:
    a policy can win on average and still lose the p99.  All arms run at
    exact rate estimates; percentiles come from the recorder's
    FCFS-coupled histogram, so values are upper bin edges (error <= one
    bin width; see `repro_torch.telemetry`).  Returns nested dicts
    ``out[metric][policy]`` with shape (L, S_seeds) for metric in mean /
    p50 / p95 / p99, plus accounting (`dropped`, `unmatched`).
    ``device=None`` runs on the card.
    """
    cap = loc.capacity_hot_rack(cfg.sim.topo, cfg.sim.true_rates,
                                cfg.sim.p_hot)
    lam = np.asarray(loads, np.float32) * cap
    seeds = np.asarray(cfg.seeds)
    est_exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]

    keymap = {"mean": "mean_delay", "p50": "delay_p50", "p95": "delay_p95",
              "p99": "delay_p99", "dropped": "telemetry_dropped",
              "unmatched": "telemetry_unmatched"}
    out: Dict = {"capacity": cap, "loads": np.asarray(loads),
                 "policies": tuple(policies)}
    for m in keymap:
        out[m] = {}
    for pol in policies:
        res = sim.sweep(pol, cfg.sim, lam, est_exact, seeds,
                        scenario=scenario, telemetry=telemetry,
                        device=device)
        for m, k in keymap.items():
            out[m][pol] = res[k][:, 0]  # drop the singleton est axis
    return out


def summarize_tail(study: Dict) -> str:
    """Human-readable tail-latency table (one row per policy x load),
    flagging loads where the p99 winner differs from the mean winner."""
    width = max([16] + [len(p) for p in study["policies"]])
    lines = [f"loads x static capacity ({study['capacity']:.2f} tasks/slot);"
             f" delays in slots, mean over seeds; percentiles are upper "
             f"histogram-bin edges (inf = past hist_max)"]
    lines.append(f"{'policy':{width}s} {'rho':>5s} {'mean':>9s} "
                 f"{'p50':>8s} {'p95':>8s} {'p99':>8s}")
    for li, rho in enumerate(study["loads"]):
        by = {m: {p: float(np.mean(study[m][p][li]))
                  for p in study["policies"]}
              for m in ("mean", "p50", "p95", "p99")}
        for pol in study["policies"]:
            lines.append(
                f"{pol:{width}s} {float(rho):5.2f} {by['mean'][pol]:9.2f} "
                f"{by['p50'][pol]:8.1f} {by['p95'][pol]:8.1f} "
                f"{by['p99'][pol]:8.1f}")
        mean_win = min(by["mean"], key=by["mean"].get)
        p99_win = min(by["p99"], key=by["p99"].get)
        if mean_win != p99_win:
            lines.append(f"{'':{width}s}       ^ tail flip: mean winner "
                         f"{mean_win}, p99 winner {p99_win}")
    return "\n".join(lines)


def control_arm_spec(arm: str, cap: float, admit_frac: float = 0.93):
    """The ``control=`` value for one study arm.

    The admission arm is a token bucket refilling at ``admit_frac`` x the
    fluid capacity (burst = 8 x cap): it clips the offered load to just
    under the stability boundary, which is precisely the regime where
    shedding a few percent of arrivals collapses the queueing tail.  The
    autoscale arm is the planned headroom autoscaler; "both" composes the
    two in one plane.
    """
    bucket = {"name": "token_bucket",
              "options": {"rate": admit_frac * cap, "burst": 8.0 * cap}}
    return {"none": None, "admission": bucket, "autoscale": "autoscale",
            "both": (bucket, "autoscale")}[arm]


def control_study(cfg: StudyConfig,
                  policies: Sequence[str] = CONTROL_POLICIES,
                  arms: Sequence[str] = CONTROL_ARMS,
                  loads: Sequence[float] = CONTROL_LOADS,
                  admit_frac: float = 0.93,
                  slo_target: float = 40.0, device=None) -> Dict:
    """SLO-control study: {no control, admission, autoscale, both} x
    {balanced_pandas, slo_pandas} at heavy-traffic loads, telemetry on.

    Admission trades throughput (shed arrivals) for p99; autoscaling
    trades fleet size for nothing at high rho (it keeps everything on)
    but shows its descale floor at moderate rho; the SLO-conditioned
    scheduler moves the tail with zero shed.  Under admission or loadgen
    control the Little's-law mean uses the measured admitted rate as its
    denominator, so means stay comparable across arms.  ``slo_target``
    (slots) is applied to every signal-reading policy
    (``uses_signals``).  Returns ``out[metric][policy][arm]`` arrays of
    shape (L, S_seeds) for metric in mean / p50 / p95 / p99 / shed_rate
    / throughput (shed_rate is NaN for the uncontrolled arm).
    ``device=None`` runs on the card.
    """
    from repro_torch.core.policy import get_policy_cls
    cap = loc.capacity_hot_rack(cfg.sim.topo, cfg.sim.true_rates,
                                cfg.sim.p_hot)
    lam = np.asarray(loads, np.float32) * cap
    seeds = np.asarray(cfg.seeds)
    est_exact = sim.make_estimates(cfg.sim, "network", 0.0, -1)[None]

    keymap = {"mean": "mean_delay", "p50": "delay_p50", "p95": "delay_p95",
              "p99": "delay_p99", "throughput": "throughput"}
    out: Dict = {"capacity": cap, "loads": np.asarray(loads),
                 "policies": tuple(policies), "arms": tuple(arms),
                 "admit_frac": admit_frac, "slo_target": slo_target}
    for m in list(keymap) + ["shed_rate"]:
        out[m] = {p: {} for p in policies}
    for pol in policies:
        pol_like: PolicyLike = pol
        if get_policy_cls(pol).uses_signals:
            pol_like = PolicyConfig(pol, {"slo_target": slo_target})
        for arm in arms:
            res = sim.sweep(pol_like, cfg.sim, lam, est_exact, seeds,
                            telemetry=True,
                            control=control_arm_spec(arm, cap, admit_frac),
                            device=device)
            for m, k in keymap.items():
                out[m][pol][arm] = res[k][:, 0]  # drop singleton est axis
            out["shed_rate"][pol][arm] = (
                res["ctl_shed_rate"][:, 0] if "ctl_shed_rate" in res
                else np.full((len(loads), len(seeds)), np.nan))
    return out


def summarize_control(study: Dict) -> str:
    """Human-readable SLO-control table (policy x arm rows per load),
    flagging loads where a controlled arm beats the uncontrolled p99."""
    width = max([16] + [len(p) for p in study["policies"]])
    lines = [f"loads x static capacity ({study['capacity']:.2f} tasks/slot); "
             f"admission bucket at {study['admit_frac']:.0%} of capacity; "
             f"SLO target {study['slo_target']:.0f} slots; delays in slots "
             f"(mean via measured admitted rate), mean over seeds"]
    lines.append(f"{'policy':{width}s} {'arm':>10s} {'rho':>5s} "
                 f"{'mean':>9s} {'p99':>8s} {'shed':>7s} {'thru':>7s}")
    for li, rho in enumerate(study["loads"]):
        for pol in study["policies"]:
            base_p99 = float(np.mean(study["p99"][pol]["none"][li])) \
                if "none" in study["arms"] else np.nan
            for arm in study["arms"]:
                mean = float(np.mean(study["mean"][pol][arm][li]))
                p99 = float(np.mean(study["p99"][pol][arm][li]))
                shed = float(np.mean(study["shed_rate"][pol][arm][li]))
                thru = float(np.mean(study["throughput"][pol][arm][li]))
                mark = " <- beats uncontrolled p99" \
                    if arm != "none" and p99 < base_p99 else ""
                lines.append(
                    f"{pol:{width}s} {arm:>10s} {float(rho):5.2f} "
                    f"{mean:9.2f} {p99:8.1f} "
                    f"{('-' if np.isnan(shed) else f'{shed:.1%}'):>7s} "
                    f"{thru:7.3f}{mark}")
        lines.append("")
    return "\n".join(lines[:-1])
