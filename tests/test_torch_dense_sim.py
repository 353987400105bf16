"""The port's dense simulator against the JAX reference.

(a) Under the replayed draws (`_torch_port.JaxDenseReplay`), the port's
    state equals the reference `slot_step` state after every slot, for
    every dense policy at K = 3 and for BP and JSQ-MW at K = 2 and 4.
(b) The replayed `simulate` reproduces the reference's recorded dense
    pins (tests/test_fleet_scale.py) exactly, with the key layout they
    were recorded under (`jax.threefry_partitionable(False)`).
(c) With the port's own draws, `sweep` equals `simulate` cell by cell.
(d) With the port's own draws, a seed's arrivals are the same for every
    policy and every error setting (common random numbers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import locality as rloc, simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.core.policy import make_policy as rmake_policy
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.policy import PolicyConfig, make_policy
from repro_torch.core.rng import DenseDeviceSource
from _torch_port import JaxDenseReplay, single_torch_thread  # noqa: F401
from test_fleet_scale import _DENSE_PINS

DENSE = ("balanced_pandas", "jsq_maxweight", "priority", "fifo",
         "pandas_po2")
K3 = ((24, 6), (0.5, 0.45, 0.25), 24)
K2 = ((24, ()), (0.5, 0.25), 24)
K4 = ((24, (4, 12)), (0.5, 0.45, 0.35, 0.25), 16)  # CFG4, test_topology.py

# (policy, options, (topology, rates, max_arrivals), load)
REPLAY_CASES = ([(p, {}, K3, 0.9) for p in DENSE]
                + [("fifo", {"cap": 40}, K3, 1.3)]  # ring wraps, drops
                + [(p, {}, k, 0.9) for k in (K2, K4)
                   for p in ("balanced_pandas", "jsq_maxweight")])
REPLAY_IDS = ([f"{p}-k3" for p in DENSE] + ["fifo_cap40-k3"]
              + [f"{p}-{k}" for k in ("k2", "k4")
                 for p in ("balanced_pandas", "jsq_maxweight")])
SLOTS = 150


@pytest.mark.parametrize("name,opts,topo_spec,rho", REPLAY_CASES,
                         ids=REPLAY_IDS)
def test_state_equals_reference_after_every_slot(name, opts, topo_spec, rho):
    (m, groups), rates, batch = topo_spec
    rtopo, topo = rloc.Topology(m, groups), loc.Topology(m, groups)
    lam = np.float32(rho * rloc.capacity_hot_rack(rtopo, rloc.Rates(rates),
                                                  0.5))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(rates), max_arrivals=batch,
                          horizon=SLOTS, warmup=1)
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    rpol = rmake_policy(RPolicyConfig(name, opts))
    pol = make_policy(PolicyConfig(name, opts))
    r_anc, r_rack = jnp.asarray(rtopo.ancestors), jnp.asarray(rtopo.rack_of)
    true_mk = jnp.broadcast_to(rloc.Rates(rates).as_array(), (m, len(rates)))
    seed = 3
    base = jax.random.PRNGKey(jnp.uint32(seed))

    def r_slot(r_state, t):  # the reference simulator's scan body
        k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
        types, active = rloc.sample_arrivals_at(
            k_arr, r_rack, lam, jnp.float32(0.5), jnp.int32(0), batch)
        r_state, compl = rpol.slot_step(r_state, k_algo, types, active,
                                        jnp.asarray(est), true_mk, r_anc)
        return r_state, (r_state, compl, types, active)

    _, (r_states, r_compl, r_types, r_active) = jax.jit(
        lambda: jax.lax.scan(r_slot, rpol.init_state(rtopo),
                             jnp.arange(SLOTS)))()

    src = JaxDenseReplay(name, [(seed, lam)], batch, m, SLOTS)
    anc = torch.as_tensor(np.array(topo.ancestors))
    rack = torch.as_tensor(np.array(topo.rack_of))
    est_t, true_k = torch.as_tensor(est)[None], loc.Rates(rates).as_array()
    state = pol.init_state(topo, batch=(1,))
    for t in range(SLOTS):
        d = src.slot(t)
        types, active = loc.sample_arrivals_at(d.n, d.u_hot, d.g_type, rack,
                                               torch.tensor(0.5))
        np.testing.assert_array_equal(types[0].numpy(), np.asarray(r_types[t]))
        np.testing.assert_array_equal(active[0].numpy(),
                                      np.asarray(r_active[t]))
        with torch.inference_mode():
            state, compl = pol.slot_step(state, d, types, active, est_t,
                                         true_k, anc)
        for field, got, want in zip(state._fields, state, r_states):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[t]),
                                          err_msg=f"{field} at slot {t}")
        assert int(compl[0]) == int(r_compl[t])
    if opts:
        assert int(state.drops[0]) > 0  # the small ring really overflowed


_PIN_CFG = sim.SimConfig(topo=loc.Topology(24, 6), true_rates=loc.Rates(),
                         p_hot=0.5, max_arrivals=24, horizon=1200,
                         warmup=300)


@pytest.mark.parametrize("name", DENSE)
def test_replayed_simulate_gives_reference_pins(name):
    lam = 0.8 * loc.capacity_hot_rack(_PIN_CFG.topo, _PIN_CFG.true_rates, 0.5)
    est = sim.make_estimates(_PIN_CFG, "network", 0.0, -1)
    with jax.threefry_partitionable(False):
        src = JaxDenseReplay(name, [(0, np.float32(lam))], 24, 24,
                             _PIN_CFG.horizon)
    out = sim.simulate(name, _PIN_CFG, lam, est, seed=0, device="cpu",
                       rng=src)
    assert out == _DENSE_PINS[name]


_SMALL = sim.SimConfig(topo=loc.Topology(12, 4), true_rates=loc.Rates(),
                       p_hot=0.5, max_arrivals=12, horizon=120, warmup=30)


@pytest.mark.parametrize("name", ("balanced_pandas", "jsq_maxweight",
                                  "fifo", "pandas_po2"))
def test_sweep_equals_simulate_cell_by_cell(name):
    cap = loc.capacity_hot_rack(_SMALL.topo, _SMALL.true_rates, 0.5)
    lams = np.asarray([0.5, 0.9], np.float32) * cap
    est = np.stack([sim.make_estimates(_SMALL, "network", 0.0, -1),
                    sim.make_estimates(_SMALL, "per_server", 0.3, 1)])
    seeds = np.asarray([4, 1])
    grid = sim.sweep(name, _SMALL, lams, est, seeds, device="cpu")
    assert grid["mean_delay"].shape == (2, 2, 2)
    for li, lam in enumerate(lams):
        for ei in range(2):
            for si, seed in enumerate(seeds):
                one = sim.simulate(name, _SMALL, float(lam), est[ei],
                                   seed=int(seed), device="cpu")
                assert set(one) == set(grid)
                for key, v in one.items():
                    assert v == grid[key][li, ei, si], (key, li, ei, si)


def test_arrivals_are_common_across_policies_and_errors():
    m, batch = 12, 12
    lam = 0.8 * loc.capacity_hot_rack(_SMALL.topo, _SMALL.true_rates, 0.5)
    # cells (seed, lam): seed 7 at one load under two error settings, and
    # seed 7 at a higher load
    cells = [(7, lam), (7, lam), (2, lam), (7, 1.2 * lam)]
    plans = {p: make_policy(p).draw_plan(m) for p in DENSE}
    srcs = {p: DenseDeviceSource(cells, plan, batch, m, "cpu")
            for p, plan in plans.items()}
    for t in range(20):
        draws = {p: s.slot(t) for p, s in srcs.items()}
        ref = draws["balanced_pandas"]
        for p, d in draws.items():
            for field in ("n", "u_hot", "g_type"):
                assert torch.equal(getattr(d, field), getattr(ref, field)), p
        # same seed, same load: identical arrivals and policy draws
        for field in ("n", "u_hot", "g_type", "u_serve", "route"):
            assert torch.equal(getattr(ref, field)[0],
                               getattr(ref, field)[1])
        # another seed draws other numbers; a higher load only more tasks
        assert not torch.equal(ref.u_hot[0], ref.u_hot[2])
        assert torch.equal(ref.u_hot[0], ref.u_hot[3])
        assert int(ref.n[3]) >= int(ref.n[0])
    perm = draws["jsq_maxweight"].perm
    assert torch.equal(torch.sort(perm, dim=1).values,
                       torch.arange(m).expand(len(cells), m))
    cand = draws["pandas_po2"].cand
    assert cand.shape == (len(cells), batch, 2)
    assert (cand[..., 0] != cand[..., 1]).all()


def test_single_step_pieces_match_reference():
    """route_one, push_task, jsq_route_one and the claim policies'
    telemetry gauges, one call at a time, on the reference's draws."""
    from repro.core import balanced_pandas as rbp, claiming as rcl
    from repro_torch.core import balanced_pandas as bp, claiming as cl
    rng = np.random.default_rng(6)
    rtopo, topo = rloc.Topology(24, 6), loc.Topology(24, 6)
    r_anc = jnp.asarray(rtopo.ancestors)
    anc = torch.as_tensor(np.array(topo.ancestors))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(), horizon=10, warmup=1)
    est = rsim.make_estimates(rcfg, "per_server", 0.3, 1, seed=2)
    for i in range(20):
        q = rng.integers(0, 3, (24, 3)).astype(np.int32)
        serving = rng.integers(0, 4, 24).astype(np.int32)
        task = np.sort(rng.choice(24, 3, replace=False)).astype(np.int32)
        key = jax.random.PRNGKey(i)
        want = rbp.route_one(rbp.PandasState(jnp.asarray(q),
                                             jnp.asarray(serving)),
                             key, jnp.asarray(task), jnp.bool_(True),
                             jnp.asarray(est), r_anc)
        got = bp.route_one(bp.PandasState(torch.as_tensor(q)[None],
                                          torch.as_tensor(serving)[None]),
                           torch.as_tensor(np.array(
                               jax.random.gumbel(key, (24,))))[None],
                           torch.as_tensor(task)[None],
                           torch.tensor([True]), torch.as_tensor(est)[None],
                           anc)
        np.testing.assert_array_equal(got.q[0].numpy(), np.asarray(want.q))
        tiers = np.asarray(rloc.server_tiers(task, r_anc))
        m_star = int(rng.integers(0, 24))
        pushed = bp.push_task(bp.PandasState(torch.as_tensor(q),
                                             torch.as_tensor(serving)),
                              torch.tensor(m_star), torch.as_tensor(tiers),
                              torch.tensor(True))
        want = rbp.push_task(rbp.PandasState(jnp.asarray(q),
                                             jnp.asarray(serving)),
                             m_star, jnp.asarray(tiers), jnp.bool_(True))
        np.testing.assert_array_equal(pushed.q.numpy(), np.asarray(want.q))
        ql = q[:, 0]
        got = cl.jsq_route_one(torch.as_tensor(ql)[None], torch.as_tensor(
            np.array(jax.random.gumbel(key, (3,))))[None],
            torch.as_tensor(task)[None], torch.tensor([True]))
        want = rcl.jsq_route_one(jnp.asarray(ql), key, jnp.asarray(task),
                                 jnp.bool_(True))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        gauges = cl.telemetry_gauges(torch.as_tensor(ql),
                                     torch.as_tensor(serving))
        for k, v in rcl.telemetry_gauges(jnp.asarray(ql),
                                         jnp.asarray(serving)).items():
            assert float(gauges[k]) == float(v)


def test_route_one_po_d_priority_count_and_gauges_match_reference():
    """pandas_po2.route_one_po_d on the reference's candidate and tie
    draws, priority.num_in_system, and the PANDAS-structure and FIFO
    telemetry gauges, one call at a time."""
    from repro.core import balanced_pandas as rbp, fifo as rfifo
    from repro.core import pandas_po2 as rpo2, priority as rprio
    from repro_torch.core import balanced_pandas as bp, fifo
    from repro_torch.core import pandas_po2 as po2, priority
    rng = np.random.default_rng(8)
    rtopo, topo = rloc.Topology(24, 6), loc.Topology(24, 6)
    r_anc = jnp.asarray(rtopo.ancestors)
    anc = torch.as_tensor(np.array(topo.ancestors))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(), horizon=10, warmup=1)
    est = rsim.make_estimates(rcfg, "per_server", 0.3, 1, seed=2)
    for i in range(20):
        q = rng.integers(0, 3, (24, 3)).astype(np.int32)
        serving = rng.integers(0, 4, 24).astype(np.int32)
        task = np.sort(rng.choice(24, 3, replace=False)).astype(np.int32)
        key, d = jax.random.PRNGKey(100 + i), 1 + i % 3
        k_cand, k_tie = jax.random.split(key)
        want = rpo2.route_one_po_d(
            rbp.PandasState(jnp.asarray(q), jnp.asarray(serving)), key,
            jnp.asarray(task), jnp.bool_(True), jnp.asarray(est), r_anc, d)
        sampled = jax.random.choice(k_cand, 24, (d,), replace=False)
        state = bp.PandasState(torch.as_tensor(q)[None],
                               torch.as_tensor(serving)[None])
        got = po2.route_one_po_d(
            state, torch.as_tensor(np.array(jax.random.gumbel(
                k_tie, (24,))))[None],
            torch.as_tensor(np.array(sampled))[None],
            torch.as_tensor(task)[None], torch.tensor([True]),
            torch.as_tensor(est)[None], anc)
        np.testing.assert_array_equal(got.q[0].numpy(), np.asarray(want.q))
        gauges = bp.telemetry_gauges(state)
        for k, v in rbp.telemetry_gauges(rbp.PandasState(
                jnp.asarray(q), jnp.asarray(serving))).items():
            assert float(gauges[k][0]) == float(v), k
        ql = q[:, 0]
        assert int(priority.num_in_system(priority.PriorityState(
            torch.as_tensor(ql)[None], torch.as_tensor(serving)[None]))[0]) \
            == int(rprio.num_in_system(rprio.PriorityState(
                jnp.asarray(ql), jnp.asarray(serving))))
        fstate = fifo.init_state(topo, cap=8, batch=(1,))._replace(
            count=torch.tensor([int(ql.sum())], dtype=torch.int32),
            serving_tier=torch.as_tensor(serving)[None])
        rstate = rfifo.init_state(rtopo, cap=8)._replace(
            count=jnp.int32(int(ql.sum())), serving_tier=jnp.asarray(serving))
        got = fifo.FifoPolicy(8).telemetry_gauges(fstate)
        for k, v in rfifo.FifoPolicy(8).telemetry_gauges(rstate).items():
            assert float(got[k][0]) == float(v), k
