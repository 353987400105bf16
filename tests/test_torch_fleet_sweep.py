"""The port's fleet study path (`fleet_sweep`, the power-of-d fleet arm)
against `repro.sharding.sim`.

(a) The plain `fleet_route` with a cell axis equals the reference oracle
    `repro.kernels.ref.fleet_route` cell by cell, exactly.
(b) Under the batched replay of the reference's draws
    (`_torch_port.JaxReplay` over the sweep's cells), the port's
    `fleet_sweep` equals the reference's `fleet_sweep` on every metric
    key, exactly, for both fleet policies (the reference test's grid).
(c) With the port's own draws, a sweep cell equals `fleet_simulate` of
    that cell bit for bit.
(d) Under replay, the power-of-d fleet carry equals the reference's
    after every slot.
(e) The power-of-d fleet path stays inside the reference's 15% delay
    band of the dense simulator (`test_fleet_delay_band_vs_dense_
    pandas_po2`'s cell).
(f) `run_study(..., fleet=True)` returns (L, E, S) arrays for both arms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import locality as rloc, simulator as rsim
from repro.kernels import ref as rref
from repro.sharding import sim as rfs
from repro_torch.core import locality as loc, robustness as rb
from repro_torch.core import simulator as sim
from repro_torch.kernels import ref
from repro_torch.sharding import sim as fs
from _torch_port import JaxReplay, single_torch_thread  # noqa: F401

FLEET = ("balanced_pandas", "pandas_po2")
TOPOS = (
    (24, (), (0.5, 0.25)),
    (24, 4, (0.5, 0.45, 0.25)),
    (36, (3, 6), (0.5, 0.45, 0.35, 0.25)),
)
IDS = ["depth0", "depth1", "depth2"]


def _fuzz_cells(rng, n, m, k, batch=17):
    """n tie-heavy cells: half of each batch piles onto servers 0..5."""
    q = rng.integers(0, 60, (n, m, k)).astype(np.int32)
    serving = rng.integers(0, 8, (n, m)).astype(np.int32)
    locs = np.stack([np.concatenate([
        np.stack([np.sort(rng.choice(6, 3, replace=False))
                  for _ in range(batch // 2)]),
        np.stack([np.sort(rng.choice(m, 3, replace=False))
                  for _ in range(batch - batch // 2)])]) for _ in range(n)])
    return q, serving, locs.astype(np.int32)


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_batched_plain_fleet_route_matches_reference(m, groups, rates):
    rng = np.random.default_rng(0)
    anc = np.array(loc.Topology(m, groups).ancestors)
    for n in (1, 3):
        q, serving, locs = _fuzz_cells(rng, n, m, len(rates))
        est = rng.uniform(0.2, 1.0, (n, m, len(rates))).astype(np.float32)
        est = -np.sort(-est, axis=-1)   # rates decrease in the tier
        got = ref.fleet_route(*(torch.from_numpy(x) for x in
                                (q, serving, est, anc, locs)))
        for out in got:
            assert out.shape == (n, locs.shape[1])
        for c in range(n):
            want = rref.fleet_route(q[c], serving[c], est[c], anc, locs[c])
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[c].numpy(), np.asarray(b))


def _grid():
    """The reference test's grid (`test_fleet_sweep_matches_simulate_
    bitwise`): Topology(24, 4), horizon 200, two loads x two error arms x
    two seeds."""
    rtopo, rr = rloc.Topology(24, 4), rloc.Rates()
    cap = rloc.capacity_hot_rack(rtopo, rr, 0.5)
    kw = dict(horizon=200, warmup=50, p_hot=0.5, max_arrivals=16)
    rcfg = rsim.SimConfig(topo=rtopo, true_rates=rr, **kw)
    cfg = sim.SimConfig(topo=loc.Topology(24, 4), true_rates=loc.Rates(),
                        **kw)
    lam_grid = np.array([0.6, 0.75], np.float32) * cap
    ests = np.stack([np.asarray(rloc.per_server_rates(rr.as_array(), 24))]
                    * 2)
    ests[1, :, 1:] *= 0.9  # second error arm
    return rcfg, cfg, lam_grid, ests, np.arange(2)


@pytest.mark.parametrize("name", FLEET)
def test_replayed_sweep_equals_reference_sweep(name):
    rcfg, cfg, lam_grid, ests, seeds = _grid()
    # results are chunk-invariant (tests/test_fleet_scale.py); a small
    # chunk keeps the reference's compile short
    want = rfs.fleet_sweep(name, rcfg, lam_grid, ests, seeds,
                           fleet=rfs.FleetConfig(chunk=50, unroll=1))
    cells = [(int(s), lam) for lam in lam_grid for _ in ests for s in seeds]
    src = JaxReplay(cells, cfg.max_arrivals, 24,
                    d=fs.candidates(name))
    got = fs.fleet_sweep(name, cfg, lam_grid, ests, seeds, device="cpu",
                         rng=src)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == (2, 2, 2)
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isfinite(got["mean_delay"]).all()


@pytest.mark.parametrize("name", FLEET)
def test_sweep_cell_equals_fleet_simulate(name):
    _, cfg, lam_grid, ests, seeds = _grid()
    out = sim.sweep(name, cfg, lam_grid, ests, seeds, fleet=True,
                    device="cpu")
    single = fs.fleet_simulate(name, cfg, float(lam_grid[1]), ests[0],
                               seed=1, device="cpu")
    assert set(single) == set(out)
    for key, val in single.items():
        assert float(out[key][1, 0, 1]) == val, key
    # a seed's arrivals are shared across loads and errors: the two error
    # arms of one seed differ only through routing
    assert not np.array_equal(out["mean_n"][:, 0], out["mean_n"][:, 1])


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_po2_replay_carry_identical_every_slot(m, groups, rates):
    seed, horizon = 3, 150
    rtopo, rr = rloc.Topology(m, groups), rloc.Rates(rates)
    lam = 0.75 * rloc.capacity_hot_rack(rtopo, rr, 0.5)
    kw = dict(horizon=horizon, warmup=50, p_hot=0.5,
              max_arrivals=max(8, int(2.2 * lam)))
    rcfg = rsim.SimConfig(topo=rtopo, true_rates=rr, **kw)
    cfg = sim.SimConfig(topo=loc.Topology(m, groups),
                        true_rates=loc.Rates(rates), **kw)
    est = np.asarray(rloc.per_server_rates(rr.as_array(), m))
    init, chunk = rfs._build_fleet_chunk(
        "pandas_po2", rcfg, rfs.FleetConfig(chunk=1, unroll=1))
    chunk = jax.jit(chunk)
    pinit, step = fs._build_fleet_step("pandas_po2", cfg, fs.FleetConfig(),
                                       "cpu")
    src = JaxReplay([(seed, lam)], cfg.max_arrivals, m, d=2)
    est_t = torch.from_numpy(est.copy())[None]
    rc, pc = init(), pinit()
    for t in range(horizon):
        rc = chunk(rc, jnp.int32(t), jnp.float32(lam), jnp.asarray(est),
                   jnp.uint32(seed))
        pc = step(pc, t, est_t, src.slot(t))
        for i, (a, b) in enumerate(zip(pc, rc)):
            a, b = a[0].numpy(), np.asarray(b)
            assert a.dtype == b.dtype, (t, i)
            if not np.array_equal(a, b):
                raise AssertionError(f"slot {t}: carry field {i} differs")
    assert int(np.asarray(rc[4])) > 0  # completions


def test_po2_delay_band_vs_dense():
    """The reference's band cell: Topology(240, 6), rho 0.8, horizon
    2000.  The port's dense po2 gave mean_delay 5.419 and its fleet arm
    5.823 (+7.4%; seeds 1-3: 5.790-5.873), the reference measured +6%."""
    topo, rates = loc.Topology(240, 6), loc.Rates()
    lam = 0.8 * loc.capacity_hot_rack(topo, rates, 0.5)
    cfg = sim.SimConfig(topo=topo, true_rates=rates, horizon=2000,
                        warmup=600, p_hot=0.5, max_arrivals=int(2.05 * lam))
    est = loc.per_server_rates(rates.as_array(), 240).numpy()
    dense = sim.simulate("pandas_po2", cfg, lam, est, seed=0, fleet=False,
                         device="cpu")
    fleet = fs.fleet_simulate("pandas_po2", cfg, lam, est, seed=0,
                              device="cpu")
    assert dense["throughput"] == pytest.approx(lam, rel=0.02)
    assert fleet["throughput"] == pytest.approx(dense["throughput"],
                                                rel=0.02)
    assert fleet["mean_delay"] == pytest.approx(dense["mean_delay"],
                                                rel=0.15)


def test_run_study_fleet_arms():
    cfg = rb.StudyConfig(
        sim=sim.SimConfig(topo=loc.Topology(36, 6), true_rates=loc.Rates(),
                          p_hot=0.5, max_arrivals=24, horizon=120,
                          warmup=30),
        loads=(0.6, 0.8), eps_grid=(0.2,), seeds=(0, 1))
    out = rb.run_study(cfg, algos=FLEET, fleet=True, device="cpu")
    for algo in FLEET:
        for key in ("delay", "throughput", "final_n"):
            assert out[key][algo].shape == (2, 3, 2), (algo, key)
        assert np.isfinite(out["delay"][algo]).all()
        thru = out["throughput"][algo][0]       # rho 0.6, every cell
        np.testing.assert_allclose(thru, out["lam"][0], rtol=0.1)
