"""The port's in-loop telemetry recorder (`repro_torch.telemetry.recorder`)
and its seam in the dense simulator, against the JAX reference's.

(a) Under the replayed draws (`_torch_port.JaxDenseReplay`), the port's
    recorder state (`TelState`) equals the reference `SimTelemetry`'s
    after every slot, for every policy but SLO-PANDAS, at stride 1 and
    16, with a ring small enough to drop, at bin widths that are not
    powers of two (the reference's compiled division is a product with
    the float32 reciprocal; `tools/telemetry_bin_division.py`) and under
    server_loss + repair (the ``alive_servers``/``open_lanes`` tracks).
    The reference's per-slot states are read out of its own compiled
    scan (`_torch_port.read_out_of_scan` around `SimTelemetry.record`).
(b) Every telemetry key of whole replayed `simulate`/`sweep` runs equals
    the reference's exactly; the sweep's shapes are (L, E, S, H+1) and
    (L, E, S, T_s, tracks).
(c) tests/test_telemetry.py's recorder tests on the port's own draws:
    purity for every policy that reads no signal, the histogram
    quantiles against `fcfs_sojourns`, the downsampled series, the
    accounting, key collisions, construction guards and
    `maybe_warn_overflow`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.core import locality as rloc
from repro.core import simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.telemetry import TelemetryConfig as RTelemetryConfig
from repro.telemetry import recorder as rrec
from repro_torch import workloads as wl
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.balanced_pandas import BalancedPandasPolicy
from repro_torch.core.policy import (PolicyConfig, available_policies,
                                     get_policy_cls)
from repro_torch.replication import make_replication
from repro_torch.telemetry import (OVERFLOW_WARN_FRAC, TELEMETRY_METRIC_KEYS,
                                   SimTelemetry, TelemetryConfig,
                                   as_telemetry_config, fcfs_sojourns,
                                   maybe_warn_overflow, percentiles_from_hist)
from _torch_port import JaxDenseReplay, read_out_of_scan
from _torch_port import single_torch_thread  # noqa: F401

BATCH = 16
RATES = (0.5, 0.45, 0.25)
# bin widths 100/30 and 64/7 (not powers of two)
ODD_BINS = dict(hist_bins=30, hist_max=100.0, qhist_bins=7, qhist_max=64.0)


def _cfgs(horizon, warmup):
    kw = dict(p_hot=0.5, max_arrivals=BATCH, horizon=horizon, warmup=warmup)
    return (rsim.SimConfig(rloc.Topology(12, 4), rloc.Rates(RATES), **kw),
            sim.SimConfig(loc.Topology(12, 4), loc.Rates(RATES), **kw))


def _policy(name, opts=None):
    opts = dict(opts or {})
    if name == "blind_pandas":
        opts["prior"] = RATES
    return PolicyConfig(name, opts), RPolicyConfig(name, opts)


def _replay(name, cfg, cells, scenario=None, replication=None):
    """The reference's draws of `cells` under `scenario`/`replication`."""
    lam_mult, reads = None, None
    if scenario is not None:
        sched = wl.compile_schedule(wl.make_scenario(scenario), cfg.topo,
                                    cfg.horizon, cfg.p_hot, device="cpu")
        lam_mult = sched.lam_mult[sched.seg].numpy()
    if replication is not None:
        rep = make_replication(replication)
        reads = (rep.num_chunks, rep.read_skew)
    return JaxDenseReplay(name, cells, BATCH, cfg.topo.num_servers,
                          cfg.horizon, lam_mult=lam_mult, reads=reads)


def _reference_states(monkeypatch, rpol, rcfg, lam, est, seed, tcfg, **kw):
    """The reference simulate's metrics and its recorder state after each
    slot, read out of the compiled scan."""
    states = []
    read_out_of_scan(monkeypatch, rrec.SimTelemetry, "record", states)
    out = rsim.simulate(rpol, rcfg, lam, est, seed=seed, telemetry=tcfg,
                        **kw)
    jax.effects_barrier()
    return out, states


# (policy, TelemetryConfig options, seams, load)
SLOT_CASES = (
    [(p, {}, {}, 0.9) for p in ("balanced_pandas", "jsq_maxweight",
                                "priority", "fifo", "pandas_po2",
                                "blind_pandas")]
    + [("balanced_pandas", dict(stride=1, **ODD_BINS), {}, 0.9),
       ("fifo", dict(stride=1, ring_capacity=BATCH), {}, 1.2),
       ("jsq_maxweight", dict(stride=3, ring_capacity=BATCH, **ODD_BINS),
        {}, 1.1),
       ("balanced_pandas", dict(stride=1),
        dict(scenario="server_loss", replication="repair"), 0.8),
       ("jsq_maxweight", dict(ODD_BINS),
        dict(scenario="rack_loss", replication="repair"), 0.8)])
SLOT_IDS = (["bp", "jsq_mw", "priority", "fifo", "po2", "blind",
             "bp-stride1-odd_bins", "fifo-tiny_ring", "jsq_mw-tiny_ring-odd",
             "bp-server_loss-repair", "jsq_mw-rack_loss-repair"])


@pytest.mark.parametrize("name,topts,seams,rho", SLOT_CASES, ids=SLOT_IDS)
def test_recorder_state_equals_reference_after_every_slot(
        monkeypatch, name, topts, seams, rho):
    horizon, warmup, seed = 120, 30, 3
    rcfg, cfg = _cfgs(horizon, warmup)
    lam = np.float32(rho * rloc.capacity_hot_rack(rcfg.topo,
                                                  rloc.Rates(RATES), 0.5))
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol = _policy(name)
    want, r_states = _reference_states(
        monkeypatch, rpol, rcfg, lam, est, seed, RTelemetryConfig(**topts),
        **seams)
    assert len(r_states) == horizon

    src = _replay(name, cfg, [(seed, lam)], **seams)
    sched = wl.compile_schedule(wl.make_scenario(seams.get("scenario")),
                                cfg.topo, horizon, 0.5, device="cpu")
    policy, init, step, rep, tel = sim._build_dense_step(
        pol, cfg, torch.as_tensor(est)[None], "cpu", sched, None,
        seams.get("replication"), TelemetryConfig(**topts))
    assert (rep is not None) == bool(seams)
    if seams:
        assert tel.extra_tracks[:2] == ("alive_servers", "open_lanes")
    carry = init()
    for t in range(horizon):
        carry = step(carry, t, src.slot(t))
        for field, got, ref in zip(carry[-1]._fields, carry[-1],
                                   r_states[t]):
            np.testing.assert_array_equal(got[0].numpy(), ref,
                                          err_msg=f"{field} at slot {t}")
    if topts.get("ring_capacity") == BATCH:
        assert int(carry[-1].dropped[0]) > 0     # the ring really dropped
    got = sim._dense_metrics(policy, carry, torch.tensor([lam]), rep, tel)
    for k in TELEMETRY_METRIC_KEYS:
        np.testing.assert_array_equal(got[k][0], want[k], err_msg=k)


def test_replayed_sweep_and_simulate_equal_reference():
    """Whole runs: every key of the replayed `sweep` (a 2 x 2 x 2 grid)
    and `simulate` equals the reference's, histograms, series,
    percentiles and accounting included."""
    horizon, warmup = 120, 30
    rcfg, cfg = _cfgs(horizon, warmup)
    cap = rloc.capacity_hot_rack(rcfg.topo, rloc.Rates(RATES), 0.5)
    lams = np.asarray([0.8, 0.95], np.float32) * cap
    est = np.stack([rsim.make_estimates(rcfg, "network", 0.0, -1),
                    rsim.make_estimates(rcfg, "per_server", 0.3, 1)])
    seeds = np.asarray([2, 5])
    topts = dict(stride=8, **ODD_BINS)
    want = rsim.sweep("balanced_pandas", rcfg, lams, est, seeds,
                      telemetry=RTelemetryConfig(**topts))
    cells = [(int(s), lam) for lam in lams for _ in range(2) for s in seeds]
    got = sim.sweep("balanced_pandas", cfg, lams, est, seeds,
                    telemetry=TelemetryConfig(**topts), device="cpu",
                    rng=_replay("balanced_pandas", cfg, cells))
    assert set(got) == set(want)
    assert got["delay_hist"].shape == (2, 2, 2, 31)
    assert got["queue_len_hist"].shape == (2, 2, 2, 8)
    assert got["series"].shape == (2, 2, 2, 15, 7)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    one = sim.simulate("balanced_pandas", cfg, lams[1], est[0], seed=5,
                       telemetry=TelemetryConfig(**topts), device="cpu",
                       rng=_replay("balanced_pandas", cfg,
                                   [(5, lams[1])]))
    for k, v in one.items():
        np.testing.assert_array_equal(v, want[k][1, 0, 1], err_msg=k)
        assert isinstance(v, float) == (np.ndim(want[k][1, 0, 1]) == 0)


# -- tests/test_telemetry.py's recorder tests, on the port's own draws ----

TOPO = loc.Topology(12, 4)
CFG = sim.SimConfig(topo=TOPO, true_rates=loc.Rates(), max_arrivals=16,
                    horizon=300, warmup=60)
EST = sim.make_estimates(CFG, "network", 0.0, -1)


@pytest.mark.parametrize("policy", available_policies())
def test_telemetry_is_pure_observation(policy):
    """The recorder draws nothing and changes no policy state: every
    metric of the run without it is the same bit for bit with it, and
    without it nothing telemetry-shaped appears.  A policy that reads
    signals is the documented exception: without telemetry it is its
    signal-free base policy (SLO-PANDAS: Balanced-PANDAS) bit for bit."""
    off = sim.simulate(policy, CFG, 3.0, EST, seed=0, device="cpu")
    if get_policy_cls(policy).uses_signals:
        base = sim.simulate("balanced_pandas", CFG, 3.0, EST, seed=0,
                            device="cpu")
        assert off == base
        return
    on = sim.simulate(policy, CFG, 3.0, EST, seed=0, telemetry=True,
                      device="cpu")
    for k, v in off.items():
        assert np.array_equal(np.asarray(v), np.asarray(on[k])), (policy, k)
    for k in TELEMETRY_METRIC_KEYS:
        assert k in on and k not in off, (policy, k)


def test_percentiles_match_exact_fcfs_quantiles():
    """Width-1 bins + integer sojourns: the histogram quantile sits within
    one bin width above the exact order statistic of the same
    FIFO-coupled sojourn multiset (rebuilt from the dense series); the
    numpy mirror agrees with the in-loop quantile."""
    cfg = sim.SimConfig(topo=TOPO, true_rates=loc.Rates(), max_arrivals=16,
                        horizon=400, warmup=0)
    tcfg = TelemetryConfig(stride=1)
    res = sim.simulate("balanced_pandas", cfg, 3.2, EST, seed=1,
                       telemetry=tcfg, device="cpu")
    soj = fcfs_sojourns(res["series"][:, 1], res["series"][:, 2])
    assert len(soj) == int(res["delay_hist"].sum())
    s = np.sort(soj)
    for q, key in ((0.50, "delay_p50"), (0.95, "delay_p95"),
                   (0.99, "delay_p99")):
        exact = s[int(np.ceil(q * len(s))) - 1]
        assert 0.0 < res[key] - exact <= tcfg.bin_width + 1e-6, key
    np.testing.assert_allclose(
        percentiles_from_hist(res["delay_hist"], tcfg.bin_width,
                              (0.5, 0.95, 0.99)),
        [res["delay_p50"], res["delay_p95"], res["delay_p99"]])


def test_downsampled_series_and_accounting():
    """stride=s point-samples the dense track (row i == dense row s*i);
    with an ample ring nothing is dropped or unmatched, every in-window
    completion is binned and the queue-length histogram covers the
    window; a tiny ring drops and counts, binned + unmatched still equal
    to the window's completions."""
    dense = sim.simulate("balanced_pandas", CFG, 3.0, EST, seed=0,
                         telemetry=TelemetryConfig(stride=1), device="cpu")
    coarse = sim.simulate("balanced_pandas", CFG, 3.0, EST, seed=0,
                          telemetry=TelemetryConfig(stride=4), device="cpu")
    n = coarse["series"].shape[0]
    np.testing.assert_array_equal(coarse["series"],
                                  dense["series"][: 4 * n: 4])
    window = dense["series"][CFG.warmup:, 2].sum()
    assert dense["telemetry_dropped"] == dense["telemetry_unmatched"] == 0
    assert dense["delay_hist"].sum() == window
    assert dense["queue_len_hist"].sum() == CFG.horizon - CFG.warmup
    tiny = sim.simulate("balanced_pandas", CFG, 5.0, EST, seed=0,
                        telemetry=TelemetryConfig(stride=1,
                                                  ring_capacity=16),
                        device="cpu")
    assert tiny["telemetry_dropped"] > 0
    assert tiny["delay_hist"].sum() + tiny["telemetry_unmatched"] == \
        tiny["series"][CFG.warmup:, 2].sum()


def test_metric_key_collision_raises():
    """A policy metric that shadows a core key fails loudly."""
    class ShadowingPolicy(BalancedPandasPolicy):
        def extra_metrics(self, s):
            return {"mean_delay": torch.zeros(s.q.shape[0])}

    with pytest.raises(ValueError, match="mean_delay"):
        sim.simulate(ShadowingPolicy(), CFG, 3.0, EST, seed=0, device="cpu")


def test_recorder_construction_guards():
    """The reference's guards, the same defaults, and extras that must
    match the recorder's tracks."""
    with pytest.raises(ValueError, match="ring_capacity"):
        SimTelemetry(TelemetryConfig(ring_capacity=4), 100, 0, 12, 16)
    with pytest.raises(ValueError, match="collide"):
        SimTelemetry(TelemetryConfig(), 100, 0, 4, 4,
                     extra_tracks=("admitted",))
    with pytest.raises(ValueError, match="duplicate"):
        SimTelemetry(TelemetryConfig(), 100, 0, 4, 4,
                     extra_tracks=("x", "x"))
    with pytest.raises(ValueError):
        TelemetryConfig(stride=0)
    with pytest.raises(TypeError):
        as_telemetry_config("yes")
    assert as_telemetry_config(True) == TelemetryConfig() == \
        TelemetryConfig(**dataclasses.asdict(RTelemetryConfig()))
    tel = SimTelemetry(TelemetryConfig(), 100, 10, 12, 16, ("x",))
    with pytest.raises(ValueError, match="extras"):
        tel.record(tel.init(1), 0, *(torch.zeros(1, dtype=torch.int32),) * 3,
                   {})


def test_maybe_warn_overflow_matches_reference():
    """Past `OVERFLOW_WARN_FRAC` both warn, with the same text."""
    cfg, rcfg = TelemetryConfig(hist_max=64.0), RTelemetryConfig(
        hist_max=64.0)
    assert OVERFLOW_WARN_FRAC == rrec.OVERFLOW_WARN_FRAC
    for frac in (0.0, OVERFLOW_WARN_FRAC, 0.05, float("nan")):
        if frac == 0.05:
            with pytest.warns(RuntimeWarning) as got:
                assert maybe_warn_overflow(frac, cfg)
            with pytest.warns(RuntimeWarning) as want:
                assert rrec.maybe_warn_overflow(frac, rcfg)
            assert str(got[0].message) == str(want[0].message)
            assert "hist_max=256" in str(got[0].message)
        else:
            assert not maybe_warn_overflow(frac, cfg)
            assert not rrec.maybe_warn_overflow(frac, rcfg)
