"""The port's fleet path against `repro.sharding.sim`, slot by slot.

A replay `DrawSource` (`_torch_port.JaxReplay`) recomputes the
reference's per-slot draws from its key schedule
(``fold_in(PRNGKey(seed), t)`` -> split -> ...), so the port
runs the reference's exact sample path: the whole carry (queues, service
classes, Little's-law accumulators, completions) must be identical after
every slot, with the private phase as the segment-min form and as the
plain `fleet_route`.  Both sides draw in one process, so no RNG-layout
scope is needed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import locality as rloc, simulator as rsim
from repro.sharding import sim as rfs
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.sharding import sim as fs
from _torch_port import JaxReplay, single_torch_thread  # noqa: F401

TOPOS = (
    (24, (), (0.5, 0.25)),
    (24, 4, (0.5, 0.45, 0.25)),
    (36, (3, 6), (0.5, 0.45, 0.35, 0.25)),
)
IDS = ["depth0", "depth1", "depth2"]


def _configs(m, groups, rates, horizon=300, warmup=100, rho=0.75):
    rtopo, rr = rloc.Topology(m, groups), rloc.Rates(rates)
    lam = rho * rloc.capacity_hot_rack(rtopo, rr, 0.5)
    batch = max(8, int(2.2 * lam))
    rcfg = rsim.SimConfig(topo=rtopo, true_rates=rr, horizon=horizon,
                          warmup=warmup, p_hot=0.5, max_arrivals=batch)
    cfg = sim.SimConfig(topo=loc.Topology(m, groups),
                        true_rates=loc.Rates(rates), horizon=horizon,
                        warmup=warmup, p_hot=0.5, max_arrivals=batch)
    est = np.asarray(rloc.per_server_rates(rr.as_array(), m))
    return rcfg, cfg, lam, est


def _np(carry):
    return [np.asarray(x) for x in carry]


def _assert_carry_equal(port, ref, t, arm):
    """The port's one-cell carry against the reference's carry."""
    for i, (a, b) in enumerate(zip(_np(port), ref)):
        a = a[0]
        assert a.dtype == b.dtype, (t, arm, i, a.dtype, b.dtype)
        if not np.array_equal(a, b):
            raise AssertionError(f"slot {t}, {arm}: carry field {i} differs")


@pytest.mark.parametrize("m,groups,rates", TOPOS, ids=IDS)
def test_replay_carry_identical_every_slot(m, groups, rates):
    seed = 3
    rcfg, cfg, lam, est = _configs(m, groups, rates)
    init, chunk = rfs._build_fleet_chunk(
        "balanced_pandas", rcfg, rfs.FleetConfig(chunk=1, unroll=1))
    chunk = jax.jit(chunk)
    arms = {}
    for use_kernel in (False, True):
        pinit, step = fs._build_fleet_step(
            "balanced_pandas", cfg, fs.FleetConfig(use_kernel=use_kernel),
            "cpu")
        arms[use_kernel] = [step, pinit()]
    src = JaxReplay([(seed, lam)], cfg.max_arrivals, m)
    est_j, est_t = jnp.asarray(est), torch.from_numpy(est.copy())[None]
    rc = init()
    for t in range(cfg.horizon):
        rc = chunk(rc, jnp.int32(t), jnp.float32(lam), est_j,
                   jnp.uint32(seed))
        ref = _np(rc)
        draws = src.slot(t)
        for use_kernel, arm in arms.items():
            arm[1] = arm[0](arm[1], t, est_t, draws)
            _assert_carry_equal(arm[1], ref, t,
                                "fleet_route" if use_kernel else "segmin")
    assert float(ref[3]) == cfg.horizon - cfg.warmup      # n_meas
    assert int(ref[4]) > 0                                 # completions


def test_carry_from_reference_resumes_mid_run():
    """Both implementations continue identically from one mid-run state."""
    seed = 7
    rcfg, cfg, lam, est = _configs(36, (3, 6), (0.5, 0.45, 0.35, 0.25),
                                   horizon=120, warmup=20)
    init, chunk = rfs._build_fleet_chunk(
        "balanced_pandas", rcfg, rfs.FleetConfig(chunk=1, unroll=1))
    chunk = jax.jit(chunk)
    args = (jnp.float32(lam), jnp.asarray(est), jnp.uint32(seed))
    rc = init()
    for t in range(60):
        rc = chunk(rc, jnp.int32(t), *args)
    _, step = fs._build_fleet_step("balanced_pandas", cfg, fs.FleetConfig(),
                                   "cpu")
    pc = fs.carry_from_reference(_np(rc), device="cpu")
    _assert_carry_equal(pc, _np(rc), 60, "converted")
    src = JaxReplay([(seed, lam)], cfg.max_arrivals, 36)
    est_t = torch.from_numpy(est.copy())[None]
    for t in range(60, 120):
        rc = chunk(rc, jnp.int32(t), *args)
        pc = step(pc, t, est_t, src.slot(t))
        _assert_carry_equal(pc, _np(rc), t, "resumed")
