"""The port's scenario subsystem (`repro_torch.workloads`) against the JAX
reference's (`repro.workloads`): the registry, every builtin's compiled
schedule element for element, the per-slot gather (duplicate knots
included), the Little's-law window mean, the host playback and the
arrival plan, the trace reader and compiler on both bundled traces, and
the cluster-trace ingest adapters.  Everything here is exact: the
schedules are numpy computations copied from the reference, moved to
torch tensors."""

import csv

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import workloads as rwl
from repro.core import locality as rloc
from repro_torch import workloads as wl
from repro_torch.core import locality as loc
from repro_torch.workloads import ingest
from _torch_port import single_torch_thread  # noqa: F401

BUILTINS = ("static", "diurnal", "flash_crowd", "mmpp", "hot_shift",
            "stragglers", "server_loss", "rack_loss", "rack_congestion",
            "trace")
TOPOS = {"k3": (24, 6), "k4": (24, (6, 12))}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weighted(mod):
    """A scenario with per-rack weights on one segment, built from either
    package's declarative classes."""
    return mod.Scenario("weighted", (
        mod.Segment(0.0),
        mod.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                    tier_mult=(1.0, 0.7, 0.5)),
        mod.Segment(0.7, hot_rack=2, p_hot=0.6, slow_servers={3: 0.5})))


def test_registry_matches_reference():
    assert wl.available_scenarios() == rwl.available_scenarios()
    assert set(BUILTINS) == set(wl.available_scenarios())
    assert wl.scenario_descriptions() == rwl.scenario_descriptions()
    assert wl.make_scenario(None) == wl.make_scenario("static")
    cfg = wl.ScenarioConfig("stragglers", {"factor": 0.2})
    assert wl.make_scenario(cfg).segments[1].slow_servers == {0: 0.2, 1: 0.2}
    with pytest.raises(ValueError, match="unknown scenario"):
        wl.make_scenario("no_such_scenario")
    with pytest.raises(ValueError, match="options only apply"):
        wl.make_scenario(wl.make_scenario("static"), factor=0.5)


@pytest.mark.parametrize("topo_id", sorted(TOPOS))
@pytest.mark.parametrize("name", BUILTINS + ("weighted",))
def test_compiled_schedule_equals_reference(name, topo_id):
    m, groups = TOPOS[topo_id]
    ours = _weighted(wl) if name == "weighted" else wl.make_scenario(name)
    theirs = _weighted(rwl) if name == "weighted" else rwl.make_scenario(name)
    horizon = 1000
    got = wl.compile_schedule(ours, loc.Topology(m, groups), horizon, 0.5,
                              device="cpu")
    want = rwl.compile_schedule(theirs, rloc.Topology(m, groups), horizon,
                                0.5)
    for field in want._fields:
        w = getattr(want, field)
        if w is None:
            assert getattr(got, field) is None, field
            continue
        g = _np(getattr(got, field))
        assert g.dtype == np.asarray(w).dtype, field
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=field)
    assert isinstance(got.knots, np.ndarray)  # the host copy
    assert got.seg.shape == (horizon,) and got.seg.dtype == torch.int64
    assert got.num_segments == len(ours.segments)


@pytest.mark.parametrize("name,horizon", [("diurnal", 10), ("mmpp", 7),
                                          ("weighted", 3), ("flash_crowd",
                                                            40)])
def test_slot_knobs_every_slot_with_duplicate_knots(name, horizon):
    """At small horizons several segments start in the same slot; the
    last of them wins, as the reference's searchsorted(side="right")."""
    ours = _weighted(wl) if name == "weighted" else wl.make_scenario(name)
    theirs = _weighted(rwl) if name == "weighted" else rwl.make_scenario(name)
    got = wl.compile_schedule(ours, loc.Topology(24, 6), horizon, 0.5,
                              device="cpu")
    want = rwl.compile_schedule(theirs, rloc.Topology(24, 6), horizon, 0.5)
    if name != "flash_crowd":
        assert len(np.unique(got.knots)) < len(got.knots)  # duplicates
    for t in range(horizon):
        w, g = rwl.slot_knobs(want, jnp.int32(t)), wl.slot_knobs(got, t)
        for field in w._fields:
            if getattr(w, field) is None:
                assert getattr(g, field) is None
                continue
            np.testing.assert_array_equal(
                _np(getattr(g, field)), np.asarray(getattr(w, field)),
                err_msg=f"{field} at slot {t}")


def test_mean_lam_mult_over_window_edge_cases():
    """The reference's regressions: zero-length, inverted and negative
    windows raise; windows that start or end mid-segment weigh the
    truncated segment exactly; and every window equals the reference."""
    scn = wl.make_scenario("flash_crowd", peak=2.0, start=0.4, width=0.2)
    sched = wl.compile_schedule(scn, loc.Topology(24, 6), 1000, 0.5,
                                device="cpu")
    rsched = rwl.compile_schedule(
        rwl.make_scenario("flash_crowd", peak=2.0, start=0.4, width=0.2),
        rloc.Topology(24, 6), 1000, 0.5)
    base = 1.0 / (1.0 - 0.2 + 2.0 * 0.2)
    for bad in ((1000, 1000), (800, 400), (-5, 1000)):
        with pytest.raises(ValueError):
            wl.mean_lam_mult_over(sched, *bad)
    assert wl.mean_lam_mult_over(sched, 999, 1000) == pytest.approx(base)
    want = (100 * 2.0 * base + 300 * base) / 400
    assert wl.mean_lam_mult_over(sched, 500, 900) == pytest.approx(want)
    assert wl.mean_lam_mult_over(sched, 0, 1000) == pytest.approx(1.0)
    per_slot = np.asarray([float(wl.slot_knobs(sched, t).lam_mult)
                           for t in range(250, 700)]).mean()
    assert wl.mean_lam_mult_over(sched, 250, 700) == pytest.approx(per_slot)
    for window in ((0, 1000), (250, 1000), (999, 1000), (500, 900),
                   (10, 30), (0, 1200)):
        assert wl.mean_lam_mult_over(sched, *window) == \
            rwl.mean_lam_mult_over(rsched, *window)


@pytest.mark.parametrize("name", BUILTINS)
def test_host_playback_and_arrival_steps_equal_reference(name):
    rack_of = np.repeat(np.arange(3), 2)   # 6 workers in 3 racks
    got = wl.host_playback(wl.make_scenario(name), 6, 50.0, num_tiers=3,
                           rack_of=rack_of)
    want = rwl.host_playback(rwl.make_scenario(name), 6, 50.0, num_tiers=3,
                             rack_of=rack_of)
    for field in ("horizon", "starts", "lam_mult", "tier_mult",
                  "server_mult", "alive", "users_mult"):
        w = getattr(want, field)
        if w is None:
            assert getattr(got, field) is None, field
        else:
            np.testing.assert_array_equal(getattr(got, field), w, field)
    for t in np.arange(0.0, 120.0, 0.75):
        for worker in range(6):
            for tier in (None, 0, 1, 2):
                assert got.slowdown(t, worker, tier) == \
                    want.slowdown(t, worker, tier)
            assert got.alive_at(t, worker) == want.alive_at(t, worker)
        assert got.lam_mult_at(t) == want.lam_mult_at(t)
        assert got.users_mult_at(t) == want.users_mult_at(t)
        np.testing.assert_array_equal(got.alive_mask_at(t),
                                      want.alive_mask_at(t))
    for n, base in ((0, 0.5), (16, 16 / 50.0), (40, 1.3)):
        np.testing.assert_array_equal(wl.arrival_steps(got, n, base),
                                      rwl.arrival_steps(want, n, base))
    with pytest.raises(ValueError):
        wl.arrival_steps(got, -1, 0.5)
    with pytest.raises(ValueError):
        wl.arrival_steps(got, 4, 0.0)


def test_host_playback_straggler_slowdown():
    scn = wl.make_scenario("stragglers", servers=(1,), factor=0.25,
                           start=0.25, width=0.5)
    pb = wl.host_playback(scn, num_workers=4, horizon=100.0)
    assert pb.slowdown(50.0, 1) == 4.0
    assert pb.slowdown(50.0, 0) == 1.0
    assert pb.slowdown(10.0, 1) == 1.0
    assert pb.slowdown(150.0, 1) == 4.0  # wraps
    with pytest.raises(ValueError, match="horizon"):
        wl.host_playback(scn, 4, 0.0)


@pytest.mark.parametrize("name", ("diurnal_week", "flash_day"))
def test_bundled_files_are_the_ports_own_copies(tmp_path, name):
    """The port ships its own bundled files: they lie inside
    `repro_torch`, equal the reference package's byte for byte, and are
    what `save_trace(synthesize_trace(name, 0))` writes."""
    from pathlib import Path

    import repro_torch
    from repro.workloads import trace as rtrace
    from repro_torch.workloads import trace as ttrace
    fname = ttrace._BUNDLED_FILES[name]
    ours = ttrace._TRACE_DIR / fname
    assert ours.resolve().is_relative_to(
        Path(repro_torch.__file__).resolve().parent)
    assert ours.read_bytes() == (rtrace._TRACE_DIR / fname).read_bytes()
    wl.save_trace(wl.synthesize_trace(name, seed=0), tmp_path / fname)
    assert (tmp_path / fname).read_bytes() == ours.read_bytes()


@pytest.mark.parametrize("name", ("diurnal_week", "flash_day"))
def test_bundled_traces_load_save_and_compile_as_reference(tmp_path, name):
    """The port's bundled files equal its own generator's output and the
    reference's traces, round-trip losslessly, and compile to the
    reference's scenario."""
    assert wl.bundled_traces() == rwl.bundled_traces()
    got, want = wl.load_bundled(name), rwl.load_bundled(name)
    assert got == wl.synthesize_trace(name)
    for field in ("name", "interval"):
        assert getattr(got, field) == getattr(want, field)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    suffix = ".jsonl" if name == "diurnal_week" else ".csv"
    wl.save_trace(got, tmp_path / f"t{suffix}")
    back = wl.load_trace(tmp_path / f"t{suffix}")
    assert back == got
    assert rwl.load_trace(tmp_path / f"t{suffix}") == want
    for kw in ({}, {"max_segments": 8}, {"max_segments": 24},
               {"max_segments": 32, "tol": 0.1}, {"normalize": False}):
        try:
            theirs = rwl.trace_to_scenario(want, **kw)
        except ValueError as e:   # too few segments for the annotations
            with pytest.raises(ValueError) as ours:
                wl.trace_to_scenario(got, **kw)
            assert str(ours.value) == str(e)
            continue
        ours = wl.trace_to_scenario(got, **kw)
        assert ours.name == theirs.name
        assert [dataclass_tuple(s) for s in ours.segments] == \
            [dataclass_tuple(s) for s in theirs.segments]
    ours = wl.make_scenario("trace", name=name, max_segments=24)
    theirs = rwl.make_scenario("trace", name=name, max_segments=24)
    assert [dataclass_tuple(s) for s in ours.segments] == \
        [dataclass_tuple(s) for s in theirs.segments]


def dataclass_tuple(seg):
    return (seg.start, seg.lam_mult, seg.p_hot, seg.hot_rack, seg.tier_mult,
            dict(seg.slow_servers), seg.rack_weights, seg.down_servers,
            seg.down_racks, seg.users_mult)


def test_trace_from_arrivals_and_validation():
    steps = [0, 0, 3, 7, 7, 7, 9]
    got = wl.trace_from_arrivals(steps, 5, horizon=10.0)
    want = rwl.trace_from_arrivals(steps, 5, horizon=10.0)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    assert got.interval == want.interval
    with pytest.raises(ValueError):
        wl.Trace("bad", 60.0, np.array([1.0, -2.0]))
    with pytest.raises(ValueError):
        wl.Incident("straggler", 4, 4, servers=(0,))


# -- ingest (mirrors tests/test_ingest.py) --------------------------------

def _write_rows(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(r)


def _event(t_us, event_type=0, machine=""):
    row = [t_us, 0, 1, 0, machine, event_type, "u", 0, 0, "", "", "", ""]
    assert len(row) == len(ingest.GOOGLE_V2_TASK_EVENT_COLUMNS)
    return row


def test_ingest_google_bins_and_weights_as_reference(tmp_path):
    from repro.workloads import ingest as ring
    assert ingest.GOOGLE_V2_TASK_EVENT_COLUMNS == \
        ring.GOOGLE_V2_TASK_EVENT_COLUMNS
    assert ingest.ALIBABA_BATCH_TASK_COLUMNS == \
        ring.ALIBABA_BATCH_TASK_COLUMNS
    assert ingest.ALIBABA_CONTAINER_COLUMNS == ring.ALIBABA_CONTAINER_COLUMNS
    s = 1_000_000
    p = tmp_path / "events.csv"
    _write_rows(p, [_event(0, machine="m-a"), _event(10 * s, machine="m-b"),
                    _event(59 * s), _event(60 * s), _event(61 * s),
                    _event(130 * s, machine="m-a"),
                    _event(65 * s, event_type=1)])
    for kw in ({"interval": 60.0}, {"interval": 60.0, "num_racks": 4}):
        got = ingest.load_google_cluster_csv(p, **kw)
        want = ring.load_google_cluster_csv(p, **kw)
        np.testing.assert_array_equal(got.arrivals, [3, 2, 1])
        np.testing.assert_array_equal(got.arrivals, want.arrivals)
        if want.rack_weights is None:
            assert got.rack_weights is None
        else:
            np.testing.assert_array_equal(got.rack_weights,
                                          want.rack_weights)
    _write_rows(p, [[123, 0, 1]])
    with pytest.raises(ValueError, match="columns"):
        ingest.load_google_cluster_csv(p)
    with pytest.raises(FileNotFoundError):
        ingest.load_google_cluster_csv(tmp_path / "missing.csv")


def test_ingest_roundtrips_as_reference(tmp_path):
    from repro.workloads import ingest as ring
    arr = np.array([4.0, 0.0, 8.0, 2.0])
    rw = np.array([[0.25, 0.75], [0.5, 0.5], [0.5, 0.5], [1.0, 0.0]])
    tr = wl.Trace("g", interval=300.0, arrivals=arr, rack_weights=rw)
    ingest.save_google_cluster_csv(tr, tmp_path / "g.csv")
    ring.save_google_cluster_csv(
        rwl.Trace("g", interval=300.0, arrivals=arr, rack_weights=rw),
        tmp_path / "g_ref.csv")
    assert (tmp_path / "g.csv").read_bytes() == \
        (tmp_path / "g_ref.csv").read_bytes()
    back = ingest.load_google_cluster_csv(tmp_path / "g.csv", interval=300.0,
                                          num_racks=2, num_intervals=4)
    np.testing.assert_array_equal(back.arrivals, arr)
    np.testing.assert_allclose(back.rack_weights[0], rw[0])
    with pytest.raises(ValueError, match="container_path"):
        ingest.save_alibaba_cluster_csv(tr, tmp_path / "a.csv")
    ingest.save_alibaba_cluster_csv(tr, tmp_path / "a.csv",
                                    container_path=tmp_path / "c.csv")
    ring.save_alibaba_cluster_csv(
        rwl.Trace("g", interval=300.0, arrivals=arr, rack_weights=rw),
        tmp_path / "a_ref.csv", container_path=tmp_path / "c_ref.csv")
    for ours, theirs in (("a.csv", "a_ref.csv"), ("c.csv", "c_ref.csv")):
        assert (tmp_path / ours).read_bytes() == \
            (tmp_path / theirs).read_bytes()
    kw = dict(interval=300.0, num_racks=2, num_intervals=4)
    got = ingest.load_alibaba_cluster_csv(
        tmp_path / "a.csv", container_path=tmp_path / "c.csv", **kw)
    want = ring.load_alibaba_cluster_csv(
        tmp_path / "a_ref.csv", container_path=tmp_path / "c_ref.csv", **kw)
    np.testing.assert_array_equal(got.arrivals, arr)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    np.testing.assert_array_equal(got.rack_weights, want.rack_weights)
