"""The port's dense simulator under a replica placement against the JAX
reference's.

(a) Under the replayed draws (`_torch_port.JaxDenseReplay` with the
    placement's key splits), the state of Balanced-PANDAS, Blind-PANDAS
    and JSQ-MaxWeight equals the reference scan body's after every slot,
    for hdfs, spread and hot_aware, static and under a schedule with
    per-rack weights.  Exact: the tolerance is zero.
(b) The replayed `simulate(..., placement=p)` returns the reference's
    metrics exactly.
(c) ``placement="uniform"`` (a name, a `PlacementConfig` or an instance)
    is the run without a placement, bit for bit, on the port's own draws.
The placement study is held in tests/test_torch_placement_study.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import workloads as rwl
from repro.core import locality as rloc
from repro.core import simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.core.policy import make_policy as rmake_policy
from repro.placement import make_placement as rmake_placement
from repro_torch import workloads as wl
from repro_torch.core import locality as loc
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PolicyConfig
from repro_torch.placement import PlacementConfig, make_placement
from _torch_port import JaxDenseReplay, single_torch_thread  # noqa: F401

SLOTS = 70
RATES = (0.5, 0.45, 0.25)
NONDEFAULT = ("hdfs", "spread", "hot_aware")


def _weighted(mod):
    """Per-rack arrival weights on one segment (rack 2 gets none) with a
    surge and congested tiers, then a moved hot rack."""
    return mod.Scenario("weighted", (
        mod.Segment(0.0),
        mod.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                    tier_mult=(1.0, 0.7, 0.5)),
        mod.Segment(0.7, hot_rack=2, p_hot=0.6, slow_servers={3: 0.5})))


def _policies(name):
    if name == "blind_pandas":
        return (PolicyConfig(name, {"prior": RATES}),
                RPolicyConfig(name, {"prior": RATES}))
    return name, name


def _leaves(x):
    """A (nested) state's tensors in field order."""
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in _leaves(part)]
    return [x]


def _replay(name, spec, placement, topo, horizon, cells, batch):
    """The replay source for `cells` under the port's schedule of `spec`."""
    sched = wl.compile_schedule(wl.make_scenario(spec), topo, horizon, 0.5,
                                device="cpu")
    racks = 0 if sched.rack_weights is None else sched.rack_weights.shape[-1]
    track = sched.lam_mult[sched.seg].numpy()
    return sched, JaxDenseReplay(name, cells, batch, topo.num_servers,
                                 horizon, lam_mult=track, racks=racks,
                                 placement=placement)


STATE_CASES = [(p, plc, w) for p in ("balanced_pandas", "blind_pandas",
                                     "jsq_maxweight")
               for plc in NONDEFAULT for w in (False, True)]
STATE_IDS = [f"{p}-{plc}-{'weighted' if w else 'static'}"
             for p, plc, w in STATE_CASES]


@pytest.mark.parametrize("name,placement,weighted", STATE_CASES,
                         ids=STATE_IDS)
def test_state_equals_reference_after_every_slot(name, placement, weighted):
    batch = 24
    rtopo, topo = rloc.Topology(24, 6), loc.Topology(24, 6)
    lam = np.float32(0.85 * rloc.capacity_hot_rack(
        rtopo, rloc.Rates(RATES), 0.5))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(RATES), max_arrivals=batch,
                          horizon=SLOTS, warmup=1)
    cfg = sim.SimConfig(topo, loc.Rates(RATES), max_arrivals=batch,
                        horizon=SLOTS, warmup=1)
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol_cfg = _policies(name)
    rpol = rmake_policy(rpol_cfg)
    spec, rspec = ((_weighted(wl), _weighted(rwl)) if weighted
                   else ("static", "static"))
    rsched = rwl.compile_schedule(rwl.make_scenario(rspec), rtopo, SLOTS, 0.5)
    r_anc, r_rack = jnp.asarray(rtopo.ancestors), jnp.asarray(rtopo.rack_of)
    r_types = rmake_placement(placement).build_sampler(rtopo)
    true_k = rloc.Rates(RATES).as_array()
    seed = 3
    base = jax.random.PRNGKey(jnp.uint32(seed))

    def r_slot(r_state, t):  # the reference simulator's scan body
        knobs = rwl.slot_knobs(rsched, t)
        k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
        types, active = rloc.sample_arrivals_at(
            k_arr, r_rack, lam * knobs.lam_mult, knobs.p_hot,
            knobs.hot_rack, batch, knobs.rack_weights, type_sampler=r_types)
        true_mk = true_k[None, :] * knobs.rate_mult
        r_state, compl = rpol.slot_step(r_state, k_algo, types, active,
                                        jnp.asarray(est), true_mk, r_anc)
        return r_state, (r_state, compl, types)

    _, (r_states, r_compl, r_tl) = jax.jit(lambda: jax.lax.scan(
        r_slot, rpol.init_state(rtopo), jnp.arange(SLOTS)))()
    r_leaves = jax.tree_util.tree_leaves(r_states)

    sched, src = _replay(name, spec, placement, topo, SLOTS, [(seed, lam)],
                         batch)
    _, init, step, _, _ = sim._build_dense_step(
        pol, cfg, torch.as_tensor(est)[None], "cpu", sched, placement)
    sample = make_placement(placement).build_sampler(topo, "cpu")
    carry = init()
    for t in range(SLOTS):
        draws = src.slot(t)
        knobs = wl.slot_knobs(sched, t)
        types = sample(draws.u_hot, draws.g_type, knobs.p_hot,
                       knobs.hot_rack, knobs.rack_weights, draws.g_rack,
                       draws.g_place)
        np.testing.assert_array_equal(types[0].numpy(), np.asarray(r_tl[t]),
                                      err_msg=f"types at slot {t}")
        done_before = int(carry[3][0])
        carry = step(carry, t, draws)
        for i, (got, want) in enumerate(zip(_leaves(carry[0]), r_leaves)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[t]),
                                          err_msg=f"leaf {i} at slot {t}")
        assert int(carry[3][0]) - done_before == int(r_compl[t])


@pytest.mark.parametrize("placement", NONDEFAULT)
def test_replayed_simulate_equals_reference_metrics(placement):
    horizon, warmup = 200, 50
    rcfg = rsim.SimConfig(rloc.Topology(24, 6), rloc.Rates(RATES),
                          horizon=horizon, warmup=warmup)
    cfg = sim.SimConfig(loc.Topology(24, 6), loc.Rates(RATES),
                        horizon=horizon, warmup=warmup)
    lam = np.float32(0.8 * rloc.capacity_hot_rack(rcfg.topo, rcfg.true_rates,
                                                  0.5))
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    want = rsim.simulate("balanced_pandas", rcfg, lam, est, seed=5,
                         placement=placement)
    _, src = _replay("balanced_pandas", "static", placement, cfg.topo,
                     horizon, [(5, lam)], 24)
    got = sim.simulate("balanced_pandas", cfg, lam, est, seed=5,
                       placement=placement, device="cpu", rng=src)
    assert got == want


@pytest.mark.parametrize("name", ("balanced_pandas", "jsq_maxweight",
                                  "pandas_po2", "blind_pandas"))
def test_uniform_placement_is_the_run_without_one(name):
    cfg = sim.SimConfig(loc.Topology(12, 4), loc.Rates(RATES),
                        max_arrivals=16, horizon=160, warmup=40)
    pol = PolicyConfig(name, {"prior": RATES}) if name == "blind_pandas" \
        else name
    cap = loc.capacity_hot_rack(cfg.topo, cfg.true_rates, cfg.p_hot)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    base = sim.simulate(pol, cfg, 0.8 * cap, est, seed=3, device="cpu")
    for spec in ("uniform", PlacementConfig("uniform"),
                 make_placement("uniform")):
        assert sim.simulate(pol, cfg, 0.8 * cap, est, seed=3, device="cpu",
                            placement=spec) == base
    lams = np.asarray([0.5, 0.8], np.float32) * cap
    want = sim.sweep(pol, cfg, lams, est[None], [0, 1], device="cpu")
    got = sim.sweep(pol, cfg, lams, est[None], [0, 1], device="cpu",
                    placement="uniform")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_sweep_cell_equals_simulate_under_a_placement():
    cfg = sim.SimConfig(loc.Topology(12, 4), loc.Rates(RATES),
                        max_arrivals=16, horizon=120, warmup=30)
    cap = loc.capacity_hot_rack(cfg.topo, cfg.true_rates, cfg.p_hot)
    est = sim.make_estimates(cfg, "network", 0.0, -1)
    lams = np.asarray([0.5, 0.8], np.float32) * cap
    plc = PlacementConfig("hot_aware", {"r_hot": 5})
    out = sim.sweep("jsq_maxweight", cfg, lams, est[None], [0, 2],
                    placement=plc, device="cpu")
    one = sim.simulate("jsq_maxweight", cfg, lams[1], est, seed=2,
                       placement=plc, device="cpu")
    assert {k: float(v[1, 0, 1]) for k, v in out.items()} == one
