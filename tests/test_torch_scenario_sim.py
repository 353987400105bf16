"""The port's dense simulator under a scenario against the JAX reference's.

(a) Under the replayed draws (`_torch_port.JaxDenseReplay` with the
    slot's arrival multiplier and, for per-rack weights, the reference's
    three-way split of the type key), each policy's state equals the
    reference scan body's state after every slot: Balanced-PANDAS under
    each of the 7 drift scenarios, Blind-PANDAS (the drift study's other
    arm), JSQ-MaxWeight and FIFO under several, a schedule with per-rack
    weights, and a 4-tier topology.  Exact, as tests/test_torch_dense_sim.py
    holds the dense path: the tolerance is zero.
(b) The replayed `simulate(..., scenario=s)` returns the reference's
    metrics exactly (Little's law over the window's mean ``lam_mult``).

The port's own draws under a scenario are held in
tests/test_torch_scenario_draws.py, the drift study in
tests/test_torch_drift_study.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import workloads as rwl
from repro.core import locality as rloc, simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.core.policy import make_policy as rmake_policy
from repro_torch import workloads as wl
from repro_torch.core import locality as loc, simulator as sim
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.robustness import DRIFT_SCENARIOS
from _torch_port import JaxDenseReplay, single_torch_thread  # noqa: F401

SLOTS = 150
K3 = ((24, 6), (0.5, 0.45, 0.25))
K4 = ((24, (6, 12)), (0.5, 0.45, 0.35, 0.25))


def _weighted(mod):
    """Per-rack arrival weights on one segment (rack 2 gets none), a
    surge and congested tiers with them, then a moved hot rack."""
    return mod.Scenario("weighted", (
        mod.Segment(0.0),
        mod.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                    tier_mult=(1.0, 0.7, 0.5)),
        mod.Segment(0.7, hot_rack=2, p_hot=0.6, slow_servers={3: 0.5})))


def _scenarios(name):
    """(port spec, reference spec) of a scenario name."""
    if name == "weighted":
        return _weighted(wl), _weighted(rwl)
    return name, name


def _policies(name, rates):
    if name == "blind_pandas":
        return (PolicyConfig(name, {"prior": rates}),
                RPolicyConfig(name, {"prior": rates}))
    return name, name


def _leaves(x):
    """A (nested) state's tensors in field order."""
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in _leaves(part)]
    return [x]


def _replay(name, spec, topo, horizon, cells, batch):
    """The replay source for `cells` under the port's schedule of `spec`."""
    sched = wl.compile_schedule(wl.make_scenario(spec), topo, horizon, 0.5,
                                device="cpu")
    racks = 0 if sched.rack_weights is None else sched.rack_weights.shape[-1]
    track = sched.lam_mult[sched.seg].numpy()
    return sched, JaxDenseReplay(name, cells, batch, topo.num_servers,
                                 horizon, lam_mult=track, racks=racks)


STATE_CASES = ([("balanced_pandas", s, K3) for s in DRIFT_SCENARIOS]
               + [("blind_pandas", s, K3) for s in
                  ("diurnal", "hot_shift", "stragglers", "rack_congestion")]
               + [("jsq_maxweight", s, K3) for s in
                  ("flash_crowd", "stragglers")]
               + [("fifo", s, K3) for s in ("mmpp", "rack_congestion")]
               + [(p, "weighted", K3) for p in
                  ("balanced_pandas", "jsq_maxweight")]
               + [("balanced_pandas", "rack_congestion", K4),
                  ("blind_pandas", "stragglers", K4)])
STATE_IDS = [f"{p}-{s}-k{len(k[1])}" for p, s, k in STATE_CASES]


@pytest.mark.parametrize("name,scenario,topo_spec", STATE_CASES,
                         ids=STATE_IDS)
def test_state_equals_reference_after_every_slot(name, scenario, topo_spec):
    (m, groups), rates = topo_spec
    batch = 24
    rtopo, topo = rloc.Topology(m, groups), loc.Topology(m, groups)
    lam = np.float32(0.85 * rloc.capacity_hot_rack(
        rtopo, rloc.Rates(rates), 0.5))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(rates), max_arrivals=batch,
                          horizon=SLOTS, warmup=1)
    cfg = sim.SimConfig(topo, loc.Rates(rates), max_arrivals=batch,
                        horizon=SLOTS, warmup=1)
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol_cfg = _policies(name, rates)
    rpol = rmake_policy(rpol_cfg)
    spec, rspec = _scenarios(scenario)
    rsched = rwl.compile_schedule(rwl.make_scenario(rspec), rtopo, SLOTS, 0.5)
    r_anc, r_rack = jnp.asarray(rtopo.ancestors), jnp.asarray(rtopo.rack_of)
    true_k = rloc.Rates(rates).as_array()
    seed = 3
    base = jax.random.PRNGKey(jnp.uint32(seed))

    def r_slot(r_state, t):  # the reference simulator's scan body
        knobs = rwl.slot_knobs(rsched, t)
        k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
        types, active = rloc.sample_arrivals_at(
            k_arr, r_rack, lam * knobs.lam_mult, knobs.p_hot,
            knobs.hot_rack, batch, knobs.rack_weights)
        true_mk = true_k[None, :] * knobs.rate_mult
        r_state, compl = rpol.slot_step(r_state, k_algo, types, active,
                                        jnp.asarray(est), true_mk, r_anc)
        return r_state, (r_state, compl)

    _, (r_states, r_compl) = jax.jit(lambda: jax.lax.scan(
        r_slot, rpol.init_state(rtopo), jnp.arange(SLOTS)))()
    r_leaves = jax.tree_util.tree_leaves(r_states)

    sched, src = _replay(name, spec, topo, SLOTS, [(seed, lam)], batch)
    _, init, step, _, _ = sim._build_dense_step(
        pol, cfg, torch.as_tensor(est)[None], "cpu", sched)
    carry = init()
    for t in range(SLOTS):
        done_before = int(carry[3][0])
        carry = step(carry, t, src.slot(t))
        for i, (got, want) in enumerate(zip(_leaves(carry[0]), r_leaves)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[t]),
                                          err_msg=f"leaf {i} at slot {t}")
        assert int(carry[3][0]) - done_before == int(r_compl[t])


SIM_CASES = ([(p, s) for p in ("balanced_pandas", "blind_pandas")
              for s in ("flash_crowd", "mmpp", "stragglers")]
             + [("jsq_maxweight", "diurnal"), ("fifo", "hot_shift"),
                ("balanced_pandas", "weighted")])


@pytest.mark.parametrize("name,scenario", SIM_CASES)
def test_replayed_simulate_equals_reference_metrics(name, scenario):
    (m, groups), rates = K3
    horizon, warmup = 240, 60
    rcfg = rsim.SimConfig(rloc.Topology(m, groups), rloc.Rates(rates),
                          horizon=horizon, warmup=warmup)
    cfg = sim.SimConfig(loc.Topology(m, groups), loc.Rates(rates),
                        horizon=horizon, warmup=warmup)
    lam = np.float32(0.8 * rloc.capacity_hot_rack(rcfg.topo, rcfg.true_rates,
                                                  0.5))
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol = _policies(name, rates)
    spec, rspec = _scenarios(scenario)
    want = rsim.simulate(rpol, rcfg, lam, est, seed=5, scenario=rspec)
    _, src = _replay(name, spec, cfg.topo, horizon, [(5, lam)], 24)
    got = sim.simulate(pol, cfg, lam, est, seed=5, scenario=spec,
                       device="cpu", rng=src)
    assert got == want
