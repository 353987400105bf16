"""The port's Blind-PANDAS, signal-free SLO-PANDAS and the functional
EWMA updates against the JAX reference.

(a) `ewma_update` / `ewma_time_update` equal the reference's bit for bit.
(b) Under the replayed draws (`_torch_port.JaxDenseReplay`), each
    policy's state equals the reference `slot_step` state after every
    slot.
(c) The replayed `simulate` reproduces the reference's recorded dense
    pins (tests/test_fleet_scale.py) exactly, with the key layout they
    were recorded under (`jax.threefry_partitionable(False)`).
(d) With the port's own draws, `sweep` equals `simulate` cell by cell.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import estimator as rest, locality as rloc
from repro.core import simulator as rsim
from repro.core.policy import PolicyConfig as RPolicyConfig
from repro.core.policy import make_policy as rmake_policy
from repro_torch.core import estimator as est_mod, locality as loc
from repro_torch.core import simulator as sim
from repro_torch.core.policy import PolicyConfig, make_policy
from repro_torch.core.rng import DenseDeviceSource
from _torch_port import JaxDenseReplay, single_torch_thread  # noqa: F401
from test_fleet_scale import _DENSE_PINS

POLICIES = ("blind_pandas", "slo_pandas")
SLOTS = 150


def test_ewma_updates_match_reference():
    """Against the reference as its simulator runs it, compiled: XLA fuses
    ``decay * old`` into the sum (one rounding), and so does the port."""
    rng = np.random.default_rng(0)
    m, k = 24, 3
    upd = jax.jit(rest.ewma_update, static_argnums=(1, 2, 4))
    tupd = jax.jit(rest.ewma_time_update, static_argnums=4)
    for i in range(30):
        est = rng.uniform(0.1, 1.0, (m, k)).astype(np.float32)
        server, tier = int(rng.integers(m)), int(rng.integers(k))
        slots = np.int32(rng.integers(0, 9))
        decay = (0.98, 0.9, 0.5)[i % 3]
        want = upd(jnp.asarray(est), server, tier, jnp.asarray(slots),
                   decay)
        got = est_mod.ewma_update(torch.from_numpy(est), server, tier,
                                  torch.tensor(slots), decay)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tbar = rng.uniform(1.0, 8.0, (m, k)).astype(np.float32)
        done = rng.random(m) < 0.6
        served = rng.integers(0, k, m).astype(np.int32)
        times = rng.integers(1, 12, m).astype(np.float32)
        want = tupd(jnp.asarray(tbar), jnp.asarray(done), jnp.asarray(served),
                    jnp.asarray(times), decay)
        got = est_mod.ewma_time_update(
            torch.from_numpy(tbar)[None], torch.from_numpy(done)[None],
            torch.from_numpy(served)[None], torch.from_numpy(times)[None],
            decay)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def _flat(state):
    """The state's tensors in field order, nested states flattened."""
    out = []
    for x in state:
        out.extend(_flat(x) if isinstance(x, tuple) else [x])
    return out


@pytest.mark.parametrize("name", POLICIES)
def test_state_equals_reference_after_every_slot(name):
    m, batch = 24, 24
    rtopo, topo = rloc.Topology(m, 6), loc.Topology(m, 6)
    lam = np.float32(0.9 * rloc.capacity_hot_rack(rtopo, rloc.Rates(), 0.5))
    rcfg = rsim.SimConfig(rtopo, rloc.Rates(), max_arrivals=batch,
                          horizon=SLOTS, warmup=1)
    # estimates off by up to 20%: ignored by the blind policy, used by SLO
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    opts = {"decay": 0.9} if name == "blind_pandas" else {}
    rpol = rmake_policy(RPolicyConfig(name, opts))
    pol = make_policy(PolicyConfig(name, opts))
    r_anc, r_rack = jnp.asarray(rtopo.ancestors), jnp.asarray(rtopo.rack_of)
    true_mk = jnp.broadcast_to(rloc.Rates().as_array(), (m, 3))
    seed = 4
    base = jax.random.PRNGKey(jnp.uint32(seed))

    def r_slot(r_state, t):  # the reference simulator's scan body
        k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
        types, active = rloc.sample_arrivals_at(
            k_arr, r_rack, lam, jnp.float32(0.5), jnp.int32(0), batch)
        r_state, compl = rpol.slot_step(r_state, k_algo, types, active,
                                        jnp.asarray(est), true_mk, r_anc)
        return r_state, (r_state, compl)

    _, (r_states, r_compl) = jax.jit(
        lambda: jax.lax.scan(r_slot, rpol.init_state(rtopo),
                             jnp.arange(SLOTS)))()
    r_fields = jax.tree_util.tree_leaves(r_states)

    src = JaxDenseReplay(name, [(seed, lam)], batch, m, SLOTS)
    anc = torch.as_tensor(np.array(topo.ancestors))
    rack = torch.as_tensor(np.array(topo.rack_of))
    est_t, true_k = torch.as_tensor(est)[None], loc.Rates().as_array()
    state = pol.init_state(topo, batch=(1,))
    for t in range(SLOTS):
        d = src.slot(t)
        types, active = loc.sample_arrivals_at(d.n, d.u_hot, d.g_type, rack,
                                               torch.tensor(0.5))
        with torch.inference_mode():
            state, compl = pol.slot_step(state, d, types, active, est_t,
                                         true_k, anc)
        fields = _flat(state)
        assert len(fields) == len(r_fields)
        for i, (got, want) in enumerate(zip(fields, r_fields)):
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[t]),
                                          err_msg=f"field {i} at slot {t}")
        assert int(compl[0]) == int(r_compl[t])
    if name == "blind_pandas":  # the estimates really moved off the prior
        tbar = state.tbar[0].numpy()
        assert not np.allclose(tbar, 1.0 / np.asarray(pol.prior))


_PIN_CFG = sim.SimConfig(topo=loc.Topology(24, 6), true_rates=loc.Rates(),
                         p_hot=0.5, max_arrivals=24, horizon=1200,
                         warmup=300)


@pytest.mark.parametrize("name", POLICIES)
def test_replayed_simulate_gives_reference_pins(name):
    lam = 0.8 * loc.capacity_hot_rack(_PIN_CFG.topo, _PIN_CFG.true_rates, 0.5)
    est = sim.make_estimates(_PIN_CFG, "network", 0.0, -1)
    pol = PolicyConfig(name, {"prior": _PIN_CFG.true_rates.values}) \
        if name == "blind_pandas" else name
    with jax.threefry_partitionable(False):
        src = JaxDenseReplay(name, [(0, np.float32(lam))], 24, 24,
                             _PIN_CFG.horizon)
    out = sim.simulate(pol, _PIN_CFG, lam, est, seed=0, device="cpu",
                       rng=src)
    assert out == _DENSE_PINS[name]


_SMALL = sim.SimConfig(topo=loc.Topology(12, 4), true_rates=loc.Rates(),
                       p_hot=0.5, max_arrivals=12, horizon=120, warmup=30)


@pytest.mark.parametrize("name", POLICIES)
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
    if name == "blind_pandas":
        assert set(grid) > {"est_alpha_mean"}


def test_options_and_refusals():
    with pytest.raises(ValueError, match="tiers"):
        make_policy(PolicyConfig("blind_pandas", {"prior": (0.5, 0.25)})
                    ).init_state(loc.Topology(24, 6))
    for bad in ({"prior": (0.5,)}, {"prior": (0.5, 1.5)}, {"decay": 1.0}):
        with pytest.raises(ValueError):
            make_policy(PolicyConfig("blind_pandas", bad))
    for bad in ({"slo_target": 0.0}, {"drain_bias": -1.0}):
        with pytest.raises(ValueError):
            make_policy(PolicyConfig("slo_pandas", bad))
    # with signals that read no breach (NaN: nothing binned yet; a p99
    # at the target) SLO-PANDAS is Balanced-PANDAS bit for bit, per cell
    pol, bp_pol = make_policy("slo_pandas"), make_policy("balanced_pandas")
    assert pol.uses_signals and not bp_pol.uses_signals
    topo = loc.Topology(12, 4)
    lam = 0.9 * loc.capacity_hot_rack(topo, loc.Rates(), 0.5)
    src = DenseDeviceSource([(0, lam), (1, lam)], pol.draw_plan(12), 16, 12,
                            "cpu")
    anc = torch.as_tensor(np.array(topo.ancestors))
    rack = torch.as_tensor(np.array(topo.rack_of))
    est = torch.as_tensor(sim.make_estimates(_SMALL, "network", 0.0, -1)
                          ).expand(2, 12, 3)
    p99 = torch.tensor([float("nan"), pol.slo_target])
    s, s_bp = pol.init_state(topo, batch=(2,)), bp_pol.init_state(
        topo, batch=(2,))
    for t in range(40):
        d = src.slot(t)
        types, active = loc.sample_arrivals_at(d.n, d.u_hot, d.g_type, rack,
                                               torch.tensor(0.5))
        s, c = pol.slot_step(s, d, types, active, est,
                             loc.Rates().as_array(), anc,
                             signals={"delay_p99": p99})
        s_bp, c_bp = bp_pol.slot_step(s_bp, d, types, active, est,
                                      loc.Rates().as_array(), anc)
        assert torch.equal(c, c_bp)
        for a, b in zip(s, s_bp):
            assert torch.equal(a, b)
