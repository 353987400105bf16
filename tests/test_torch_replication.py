"""The port's replication subsystem (`repro_torch.replication`) against
the JAX reference's on the CPU: the registry surface and its option
checks, the migration cost model, each controller's targets on both
substrates (the popularity threshold against the compiled
``jnp.quantile``, ties and zeros included), the host lifecycle observe by
observe, the registries' descriptions, per-cell true rates through every
policy's slot step, and ``"fixed"`` without failures as the run without
replication for the reference's six test policies.  Zero tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import locality as rloc
from repro.core import policy as rpolicy
from repro.placement import make_placement as rmake_placement
from repro.replication import ReplicationConfig as RReplicationConfig
from repro.replication import MigrationModel as RMigrationModel
from repro.replication import lifecycle as rlife
from repro.replication import make_replication as rmake_replication
from repro.replication import replication_descriptions as rdescriptions
from repro.telemetry import EventRecorder as REventRecorder
from repro_torch.core import locality as loc, policy, simulator as sim
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.rng import DenseDeviceSource
from repro_torch.placement import make_placement
from repro_torch.telemetry import EventRecorder
from repro_torch.replication import (MigrationModel, ReplicationConfig,
                                     ReplicationController,
                                     available_replications,
                                     get_replication_cls, make_replication,
                                     replication_descriptions)
from repro_torch.replication.controllers import (FixedReplication,
                                                 quantile_linear)
from _torch_port import single_torch_thread  # noqa: F401

RATES = (0.5, 0.45, 0.25)
ALGOS = ("balanced_pandas", "jsq_maxweight", "priority", "fifo",
         "pandas_po2", "blind_pandas")


def _policy(name):
    return PolicyConfig(name, {"prior": RATES}) \
        if name == "blind_pandas" else name


# ------------------------------------------------------------- registry --

BAD_OPTIONS = (("popularity", {"r_hot": 1, "r_cold": 3}),
               ("popularity", {"r_cold": 0}),
               ("popularity", {"hot_frac": 0.0}),
               ("popularity", {"hot_frac": 1.0}),
               ("popularity", {"decay": 1.0}),
               ("repair", {"lanes": 0}),
               ("repair", {"num_chunks": 0}),
               ("repair", {"moves_per_slot": 0}),
               ("fixed", {"read_skew": -0.5}),
               ("fixed", {"chunk_size": 0.0}),
               ("fixed", {"contention": 1.5}),
               ("fixed", {"bogus": 1}))


def test_registry_surface_matches_reference():
    assert available_replications() == rlife.available_replications()
    assert replication_descriptions() == rdescriptions()
    assert policy.policy_descriptions() == rpolicy.policy_descriptions()
    assert policy.router_descriptions() == rpolicy.router_descriptions()
    ctrl = make_replication(None)
    assert ctrl.name == "fixed" and ctrl.is_static
    assert make_replication(ctrl) is ctrl
    for name in available_replications():
        mine, ref = make_replication(name), rmake_replication(name)
        assert type(mine).__name__ == type(ref).__name__
        assert mine.is_static == ref.is_static
        assert get_replication_cls(name) is type(mine)
        for attr in ("num_chunks", "lanes", "moves_per_slot", "read_skew",
                     "catalogue_seed"):
            assert getattr(mine, attr) == getattr(ref, attr), (name, attr)
        for base in (1, 3, 7):
            assert mine.max_target(base) == ref.max_target(base)
    c = make_replication(ReplicationConfig("popularity", {"r_hot": 6}))
    assert (c.r_hot, c.max_target(3)) == (6, 6)
    for name, opts in BAD_OPTIONS:
        with pytest.raises((ValueError, TypeError)) as want:
            rmake_replication(RReplicationConfig(name, opts))
        with pytest.raises(want.type) as got:
            make_replication(ReplicationConfig(name, opts))
        assert str(got.value) == str(want.value)
    for bad in (lambda mk: mk("nope"), lambda mk: mk(mk("repair"), lanes=2),
                lambda mk: mk(ReplicationConfig("repair"), lanes=2)):
        with pytest.raises(ValueError):
            bad(make_replication)
    with pytest.raises(ValueError) as want:
        rmake_replication("nope")
    with pytest.raises(ValueError) as got:
        make_replication("nope")
    assert str(got.value) == str(want.value)
    assert issubclass(FixedReplication, ReplicationController)


def test_migration_model_matches_reference():
    for kw in ({}, {"chunk_size": 3.0, "contention": 0.25}):
        for rates in (RATES, (0.5, 0.45, 0.35, 0.25), (1.0,)):
            mine, ref = MigrationModel(**kw), RMigrationModel(**kw)
            np.testing.assert_array_equal(mine.cost_table(rates),
                                          ref.cost_table(rates))
            assert mine.cost_table(rates).dtype == np.float32
            assert mine.cost(rates, 0) == ref.cost(rates, 0)
    np.testing.assert_array_equal(MigrationModel().cost_table(RATES),
                                  [16.0, 18.0, 32.0])
    for bad in ({"chunk_size": 0.0}, {"contention": 0.0}):
        with pytest.raises(ValueError):
            MigrationModel(**bad)
    for rates in ((), (0.5, 0.0), ((0.5,),)):
        with pytest.raises(ValueError):
            MigrationModel().cost_table(rates)


# -------------------------------------------------------------- targets --

def _pop_rows(rng, n, c):
    """Popularity rows with ties, zeros and spread-out magnitudes."""
    x = rng.random((n, c)).astype(np.float32) \
        * rng.choice([1.0, 10.0, 1000.0], (n, 1)).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4])               # ties
    x[n // 4: n // 3, : c // 2] = 0.0                 # half zeros
    x[n // 3: n // 3 + 4] = 0.0                       # all zeros
    x[n // 3 + 4: n // 3 + 8] = 2.5                   # all equal
    return x


@pytest.mark.parametrize("c,hot_frac", [(64, 0.125), (16, 0.125),
                                         (64, 0.3), (37, 0.2)])
def test_popularity_threshold_equals_compiled_quantile(c, hot_frac):
    """The reference takes the threshold inside its compiled scan, where
    XLA fuses one interpolation product into the sum; `quantile_linear`
    forms it the same way (an eager one-row call can round otherwise)."""
    x = _pop_rows(np.random.default_rng(c), 2000, c)
    q = 1.0 - hot_frac
    want = np.asarray(jax.jit(jax.vmap(lambda r: jnp.quantile(r, q)))(x))
    got = quantile_linear(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(got, want)


def test_sim_targets_match_reference():
    rng = np.random.default_rng(5)
    live = rng.integers(0, 6, (300, 64)).astype(np.int32)
    base = rng.integers(1, 4, 64).astype(np.int32)
    pop = _pop_rows(rng, 300, 64)
    for name, opts in (("fixed", {}), ("repair", {}), ("popularity", {}),
                       ("popularity", {"r_hot": 7, "r_cold": 2,
                                       "hot_frac": 0.3})):
        ref = rmake_replication(RReplicationConfig(name, opts))
        want = np.asarray(jax.jit(jax.vmap(
            lambda p, lv: ref.sim_targets(p, lv, jnp.asarray(base))))(
                pop, live))
        got = make_replication(ReplicationConfig(name, opts)).sim_targets(
            torch.from_numpy(pop), torch.from_numpy(live),
            torch.from_numpy(base))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_host_targets_match_reference():
    rng = np.random.default_rng(9)
    live = rng.integers(0, 5, 40)
    base = rng.integers(1, 4, 40)
    for counts in ({}, {3: 5, 1: 5, 7: 2, 50: 9},
                   {int(c): int(rng.integers(1, 4)) for c in range(40)}):
        for name in available_replications():
            want = rmake_replication(name).host_targets(counts, live, base)
            got = make_replication(name).host_targets(counts, live, base)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


# ---------------------------------------------------------- host mirror --

HOST_CASES = (("repair", (8, 4)), ("fixed", (8, 4)), ("popularity", (8, 4)),
              ("repair", (24, (4, 12))), ("popularity", (12, 4)))


@pytest.mark.parametrize("name,topo", HOST_CASES)
def test_host_lifecycle_matches_reference_observe_by_observe(name, topo):
    m, groups = topo
    rtopo, ptopo = rloc.Topology(m, groups), loc.Topology(m, groups)
    rates = np.asarray((0.5, 0.45, 0.35, 0.25)[:ptopo.num_tiers]
                       if ptopo.num_tiers == 4 else RATES)
    opts = {"lanes": 3} if name == "repair" else {}
    ref = rmake_replication(RReplicationConfig(name, opts)).build_host(
        rtopo, rmake_placement(None), 20, 3, 1, rates)
    mine = make_replication(ReplicationConfig(name, opts)).build_host(
        ptopo, make_placement(None), 20, 3, 1, rates)
    assert mine.tracer is None
    ref.tracer, mine.tracer = REventRecorder(), EventRecorder()
    rng = np.random.default_rng(m)
    alive = np.ones(m, bool)
    for t in range(120):
        if t in (10, 70):            # a failure window, then a second one
            alive = np.ones(m, bool)
            alive[rng.choice(m, 3, replace=False)] = False
        if t in (50, 100):
            alive = np.ones(m, bool)
        for _ in range(int(rng.integers(0, 4))):
            c = int(rng.integers(0, 30))
            assert mine.replicas_for(c) == ref.replicas_for(c)
            mine.note_read(c)
            ref.note_read(c)
        mine.observe(float(t), alive)
        ref.observe(float(t), alive)
        np.testing.assert_array_equal(mine.ids, ref.ids)
        np.testing.assert_array_equal(mine.mask, ref.mask)
        assert mine.lanes == ref.lanes
        assert (mine.moves, mine.dropped, mine.lost_reads) == \
            (ref.moves, ref.dropped, ref.lost_reads)
        assert mine.state_dict() == ref.state_dict()
        for h in range(m):
            assert mine.contention_mult(h) == ref.contention_mult(h)
            assert mine.is_alive(h) == ref.is_alive(h)
        assert (mine.availability(), mine.mean_replication(),
                mine.data_loss_frac()) == (ref.availability(),
                                           ref.mean_replication(),
                                           ref.data_loss_frac())
    # the lifecycle's events: the reference's, event for event
    assert mine.tracer.events() == ref.tracer.events()
    assert mine.tracer.emitted == ref.tracer.emitted > 0
    state = json.loads(json.dumps(mine.state_dict()))
    again = make_replication(ReplicationConfig(name, opts)).build_host(
        ptopo, make_placement(None), 20, 3, 1, rates)
    again.load_state_dict(state)
    assert again.state_dict() == mine.state_dict()
    for t in range(120, 200):     # the lanes survive the round trip
        again.observe(float(t), alive)
        mine.observe(float(t), alive)
    assert again.state_dict() == mine.state_dict()
    with pytest.raises(ValueError):
        make_replication(name).build_host(ptopo, make_placement(None), 7, 3,
                                          1, rates).load_state_dict(state)


def test_host_all_dead_loses_reads():
    host = make_replication("fixed").build_host(
        loc.Topology(4, 2), make_placement(None), 4, 3, 0, RATES)
    locs = host.replicas_for(1)
    assert locs == sorted(locs) and len(locs) == 3
    host.observe(0.0, np.zeros(4, bool))
    assert host.replicas_for(1) == [] and host.lost_reads == 1
    assert host.availability() == 0.0 and host.data_loss_frac() == 1.0


# ------------------------------------------------------ per-cell rates --

@pytest.mark.parametrize("name", sorted(policy.available_policies()))
def test_per_cell_true_rates_equal_shared_rates(name):
    """(N, M, K) true rates equal across cells give every policy's slot
    step the (M, K) result bit for bit, slot after slot."""
    topo = loc.Topology(12, 4)
    m, n_cells, batch = 12, 3, 12
    pol = policy.make_policy(PolicyConfig(name, {"prior": RATES})
                             if name == "blind_pandas"
                             else name)
    cells = [(s, np.float32(5.0)) for s in (0, 1, 2)]
    src = DenseDeviceSource(cells, pol.draw_plan(m), batch, m, "cpu")
    est = torch.as_tensor(sim.make_estimates(
        sim.default_config(), "per_server", 0.2, -1)[:m])[None].expand(
            n_cells, -1, -1).contiguous()
    anc = torch.as_tensor(np.array(topo.ancestors))
    rack_of = torch.as_tensor(np.array(topo.rack_of))
    tmk = loc.Rates(RATES).as_array("cpu")[None, :] \
        * torch.linspace(0.5, 1.0, m)[:, None]
    assert loc.per_server_rates(tmk[None].expand(n_cells, -1, -1),
                                m).shape == (n_cells, m, 3)
    assert loc.per_server_rates(tmk[0], m).shape == (m, 3)
    a = pol.init_state(topo, device="cpu", batch=(n_cells,))
    b = pol.init_state(topo, device="cpu", batch=(n_cells,))
    with torch.inference_mode():
        for t in range(30):
            d = src.slot(t)
            types, active = loc.sample_arrivals_at(
                d.n, d.u_hot, d.g_type, rack_of, 0.5, 0)
            a, ca = pol.slot_step(a, d, types, active, est, tmk, anc)
            b, cb = pol.slot_step(b, d, types, active, est,
                                  tmk[None].expand(n_cells, -1, -1), anc)
            assert torch.equal(ca, cb)
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b)):
                assert torch.equal(x, y), t


# ----------------------------------------------------- fixed: bitwise --

@pytest.mark.parametrize("name", ALGOS)
def test_fixed_without_failures_is_the_run_without_replication(name):
    cfg = sim.SimConfig(loc.Topology(12, 4), loc.Rates(RATES), p_hot=0.5,
                        max_arrivals=16, horizon=240, warmup=60)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    pol = _policy(name)
    base = sim.simulate(pol, cfg, 3.0, est, seed=3, device="cpu")
    for spec in ("fixed", ReplicationConfig("fixed"), FixedReplication()):
        got = sim.simulate(pol, cfg, 3.0, est, seed=3, replication=spec,
                           scenario="static", device="cpu")
        assert got == base and set(got) == set(base)
    # nothing is built: the carry and the draws are the run's without it
    _, init, _, rep, _ = sim._build_dense_step(
        pol, cfg, torch.as_tensor(est)[None], "cpu", replication="fixed")
    assert rep is None and len(init()) == 4
