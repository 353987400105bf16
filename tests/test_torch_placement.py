"""The port's replica placement (`repro_torch.placement`) against the JAX
reference's (`repro.placement`) on the CPU.

* The registry and `placement_descriptions` equal the reference's.
* The host rules: `replicas` and `placement_map` of every placement equal
  the reference's on five topologies, chunks 0-63, replication 3 and 4;
  a `hot_aware` sequence of reads, rebalances and state round trips too.
* The simulator samplers, fed the draws the reference's samplers make from
  their keys (`_torch_port.type_draws`), give the reference's types bit
  for bit at K=3 and K=4: a traced hot rack, per-rack weights, hdfs's
  fall-back to uniform, and a leading cell dimension.
* The capacity LP on the reference's own sampled types equals the
  reference's to 1e-6 relative; on the port's own draws uniform's is
  within 5% of the water-filling closed form, and hdfs and spread are at
  or above it.
* Placement-sampled types through the scheduling kernels' plain versions
  and the plain models of their two CUDA passes, against the reference's
  oracles.
* The serving engine under each non-uniform placement drains with the
  reference engine's routes, tiers and tokens (a stubbed clock on both
  sides), and runs `hot_aware`'s rebalance at its cadence.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as rregistry
from repro.core import locality as rloc
from repro.kernels import ref as rref
from repro.models import params as RP
from repro.placement import (PlacementConfig as RPlacementConfig,
                             available_placements as ravailable,
                             make_placement as rmake,
                             placement_capacity as rcapacity,
                             placement_descriptions as rdescriptions,
                             sample_placement_types as rsample_types)
from repro.serve import engine as rengine
from repro_torch.configs import registry
from repro_torch.core import locality as loc
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.placement import (PlacementConfig, available_placements,
                                   make_placement, placement_capacity,
                                   placement_descriptions)
from repro_torch.placement.capacity import _fluid_lp
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
from _torch_port import place_blocks, single_torch_thread  # noqa: F401
from _torch_port import type_draws
from test_torch_maxweight import _two_pass as mw_two_pass
from test_torch_wwl_route import _two_pass as wwl_two_pass

ALL = ("uniform", "hdfs", "spread", "hot_aware")
NONDEFAULT = ("hdfs", "spread", "hot_aware")
HOST_TOPOS = {"4x2": (4, 2), "16x8": (16, 8), "24x6": (24, 6),
              "8x2x4": (8, (2, 4)), "24x4x12": (24, (4, 12))}


def _specs(name):
    """(port spec, reference spec): hot_aware with its widest options."""
    if name == "hot_aware5":
        return (PlacementConfig("hot_aware", {"r_hot": 5, "hot_frac": 0.5}),
                RPlacementConfig("hot_aware", {"r_hot": 5, "hot_frac": 0.5}))
    return name, name


def test_registry_matches_reference():
    assert available_placements() == ravailable()
    assert placement_descriptions() == rdescriptions()
    for bad in ("nope", PlacementConfig("hot_aware", {"r_hot": 2}),
                PlacementConfig("hot_aware", {"hot_frac": 0.0})):
        with pytest.raises(ValueError) as got:
            make_placement(bad)
        rbad = RPlacementConfig(bad.name, bad.options) \
            if isinstance(bad, PlacementConfig) else bad
        with pytest.raises(ValueError) as want:
            rmake(rbad)
        assert str(got.value) == str(want.value)
    assert make_placement(PlacementConfig("hot_aware", {"r_hot": 5})).r_hot \
        == 5
    p = make_placement("spread")
    assert make_placement(p) is p and make_placement(None).name == "uniform"
    with pytest.raises(ValueError, match="options"):
        make_placement(p, r_hot=4)


@pytest.mark.parametrize("topo", sorted(HOST_TOPOS))
@pytest.mark.parametrize("name", ALL + ("hot_aware5",))
def test_host_rules_match_reference(name, topo):
    m, groups = HOST_TOPOS[topo]
    t, rt = loc.Topology(m, groups), rloc.Topology(m, groups)
    spec, rspec = _specs(name)
    port, want = make_placement(spec), rmake(rspec)
    for replication in (3, 4):
        for seed in (0, 5):
            for c in range(64):
                assert port.replicas(t, c, replication, seed) == \
                    want.replicas(rt, c, replication, seed), (c, replication)
            ids, mask = port.placement_map(t, 64, replication, seed)
            rids, rmask = want.placement_map(rt, 64, replication, seed)
            assert ids.dtype == rids.dtype and mask.dtype == rmask.dtype
            np.testing.assert_array_equal(ids, rids)
            np.testing.assert_array_equal(mask, rmask)
        assert port.max_replication(replication) == \
            want.max_replication(replication)


def test_hot_aware_state_sequence_matches_reference():
    spec, rspec = _specs("hot_aware5")
    port, want = make_placement(spec), rmake(rspec)
    t, rt = loc.Topology(16, 8), rloc.Topology(16, 8)
    rng = np.random.default_rng(4)
    assert port.rebalance() == want.rebalance() == 0
    for step in range(6):
        for c in rng.zipf(1.6, 25) % 40:   # numpy ints, as callers give
            port.note_read(c)
            want.note_read(c)
        assert port.rebalance() == want.rebalance()
        state = port.state_dict()
        assert state == want.state_dict()
        assert json.loads(json.dumps(state)) == state
        for c in range(40):
            assert port.replicas(t, c, 3, 1) == want.replicas(rt, c, 3, 1)
    fresh = make_placement(spec)
    fresh.load_state_dict(json.loads(json.dumps(port.state_dict())))
    assert fresh.state_dict() == port.state_dict()
    np.testing.assert_array_equal(fresh.placement_map(t, 40, 3, 1)[0],
                                  want.placement_map(rt, 40, 3, 1)[0])
    u = make_placement("uniform")
    assert u.state_dict() == {}
    u.load_state_dict({})
    with pytest.raises(ValueError):
        u.load_state_dict({"counts": [1]})


def test_hot_aware_log_weights_agree_with_xla():
    """`hot_aware`'s logits are the float32 log of 3 / n_hot and
    (r_hot - 3) / n_cold.  XLA's CPU log and torch's disagree by one ulp
    at some float32 inputs; at every weight of the sampler tests below
    they agree, so those tests are exact."""
    logs = jax.jit(jnp.log)
    for m, groups in ((24, 6), (24, (4, 12)), (12, 4)):
        t = loc.Topology(m, groups)
        sizes = np.bincount(np.asarray(t.rack_of))
        for r_hot in (5, 6):
            for n_hot in sizes:
                for num, den in ((3, n_hot), (r_hot - 3, max(m - n_hot, 1))):
                    w = torch.tensor(float(num)) / torch.tensor(float(den))
                    rw = jnp.float32(num) / jnp.float32(den)
                    assert w.numpy() == np.asarray(rw)
                    assert torch.log(w).numpy() == np.asarray(logs(rw)), \
                        (m, groups, num, den)


def _draws(key, b, m, racks, place):
    return {k: torch.from_numpy(np.array(v))
            for k, v in type_draws(key, b, m, racks, place).items()}


SAMPLER_TOPOS = {"k3": (24, 6), "k4": (24, (4, 12)), "k2": (24, ()),
                 "k3x12": (12, 4)}


@pytest.mark.parametrize("topo", sorted(SAMPLER_TOPOS))
@pytest.mark.parametrize("name", ALL + ("hot_aware5",))
def test_samplers_match_reference(name, topo):
    m, groups = SAMPLER_TOPOS[topo]
    t, rt = loc.Topology(m, groups), rloc.Topology(m, groups)
    spec, rspec = _specs(name)
    port, want = make_placement(spec), rmake(rspec)
    sample = port.build_sampler(t, "cpu")
    rsample = jax.jit(want.build_sampler(rt), static_argnums=3)
    place = place_blocks(rspec)
    assert port.gumbel_blocks(t) == (0 if name == "hdfs" and topo == "k2"
                                     else place)
    b = 64
    hot_rack = min(2, t.num_racks - 1)
    weights = [None]
    if t.num_racks == 4:
        weights.append((0.2, 0.5, 0.3, 0.0))
    elif t.num_racks == 6:
        weights.append((1.0, 0.0, 2.0, 1.0, 4.0, 0.5))
    for w in weights:
        racks = 0 if w is None else len(w)
        rw = None if w is None else jnp.asarray(w, jnp.float32)
        tw = None if w is None else torch.tensor(w, dtype=torch.float32)
        cells = []
        for seed, p_hot in ((0, 0.5), (1, 0.9), (2, 0.0)):
            key = jax.random.PRNGKey(seed)
            types = np.asarray(rsample(key, jnp.float32(p_hot),
                                       jnp.int32(hot_rack), b, rw))
            d = _draws(key, b, m, racks, place)
            got = sample(d["u_hot"], d["g_type"], p_hot,
                         torch.tensor(hot_rack), tw, d.get("g_rack"),
                         d.get("g_place"))
            assert got.dtype == torch.int32 and got.shape == (b, 3)
            np.testing.assert_array_equal(got.numpy(), types,
                                          err_msg=f"seed {seed} w {w}")
            cells.append((d, types))
        # a leading cell dimension: the cells at one p_hot, stacked
        stack = {k: torch.stack([d[k] for d, _ in cells]) for k in cells[0][0]}
        got = sample(stack["u_hot"], stack["g_type"], 0.5, hot_rack, tw,
                     stack.get("g_rack"), stack.get("g_place"))
        np.testing.assert_array_equal(got[0].numpy(), cells[0][1])


@pytest.mark.parametrize("name", ALL)
def test_capacity_lp_on_reference_types(name):
    rt, t = rloc.Topology(24, 6), loc.Topology(24, 6)
    rates = rloc.Rates()
    types = rsample_types(rt, name, 0.5, n_samples=400, seed=2)
    want = rcapacity(rt, rates, 0.5, name, n_samples=400, seed=2)
    got = _fluid_lp(t, np.asarray(rates.values, np.float64), types)
    assert got == pytest.approx(want, rel=1e-6)


def test_own_draw_capacity():
    t = loc.Topology(24, 6)
    rates = loc.Rates()
    closed = loc.capacity_hot_rack(t, rates, 0.5)
    caps = {name: placement_capacity(t, rates, 0.5, name, n_samples=2000,
                                     device="cpu", strict=False)
            for name in ("uniform", "hdfs", "spread")}
    assert caps["uniform"] == pytest.approx(closed, rel=0.05)
    assert caps["hdfs"] >= closed and caps["spread"] >= closed
    with pytest.raises(ValueError, match="tiers"):
        placement_capacity(t, (1.0, 0.5), 0.5, "uniform", device="cpu")


@pytest.mark.parametrize("name", NONDEFAULT)
def test_placement_types_through_the_scheduling_kernels(name):
    """tests/test_placement.py::test_placement_types_feed_both_kernels on
    the port: the sampled types (the reference's, bit for bit) through
    `ops.wwl_route` and `ops.maxweight_claim` (their plain versions here)
    and the plain models of the two CUDA passes, against the reference's
    oracles; the claims' queues are the types' replica counts."""
    t = loc.Topology(24, (4, 12))
    anc = np.asarray(t.ancestors, np.int32)
    m, b = 24, 9
    d = _draws(jax.random.PRNGKey(0), b, m, 0, place_blocks(name))
    tl = make_placement(name).build_sampler(t, "cpu")(
        d["u_hot"], d["g_type"], 0.5, 0, g_place=d.get("g_place")).numpy()
    racks = {len(set(anc[0, row])) for row in tl}
    assert racks - {1}, "the types span more than one rack"
    rng = np.random.default_rng(3)
    rates = (0.5, 0.45, 0.35, 0.25)
    wl = rng.uniform(0, 50, m).astype(np.float32)
    er = np.tile(rates, (m, 1)).astype(np.float32)
    want = [np.asarray(x) for x in rref.wwl_route(
        jnp.asarray(wl), jnp.asarray(er), jnp.asarray(anc), jnp.asarray(tl))]
    got = [x.numpy() for x in ops.wwl_route(*(torch.as_tensor(x) for x in
                                             (wl, er, anc, tl)))]
    out, path = wwl_two_pass(wl, er, anc, tl)
    assert path == "group"   # the kernel's group-restricted pass 2
    model = [np.asarray(x) for x in out]
    for g, mo, w in zip(got, model, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(mo, w)
    q = np.bincount(tl.ravel(), minlength=m).astype(np.float32)
    ids = rng.choice(m, b, replace=False).astype(np.int32)
    er2 = np.tile(rates, (b, 1)).astype(np.float32)
    args = (q, anc, ids, anc[:, ids], er2)
    want = [np.asarray(x) for x in rref.maxweight_claim(
        *(jnp.asarray(x) for x in args))]
    got = [x.numpy() for x in ops.maxweight_claim(*(torch.as_tensor(x)
                                                   for x in args))]
    out, path = mw_two_pass(*args)
    assert path == "group"
    model = [np.asarray(x) for x in out]
    for g, mo, w in zip(got, model, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(mo, w)


# ----------------------------------------------------------------- engine --

ARCH = "chatglm3_6b"
ECFG = dict(num_replicas=4, replicas_per_pod=2, slots_per_replica=2,
            max_len=64, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def model():
    """The chatglm3-6b smoke config with PRNGKey(0) weights, both sides."""
    rcfg = rregistry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(0))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    return rcfg, rprm, registry.get_smoke_config(ARCH), prm


def _requests(cls, cfg, n):
    rng = np.random.default_rng(6)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           8).astype(np.int32),
                max_new_tokens=2, prefix_id=i % 5) for i in range(n)]


def _clock():
    ticks = iter(range(1 << 30))

    class Clock:   # each read half a second after the last
        @staticmethod
        def monotonic():
            return 0.5 * next(ticks)
    return Clock


@pytest.mark.parametrize("name", NONDEFAULT + ("hot_aware5",))
def test_engine_routes_as_the_reference(model, monkeypatch, name):
    """With a stubbed clock on both sides the observed prefill times are
    equal, so the routers see the same estimates: every request gets the
    reference's replica, tier and tokens under each placement."""
    rcfg, rprm, cfg, prm = model
    spec, rspec = _specs(name)
    monkeypatch.setattr(engine_mod, "time", _clock())
    monkeypatch.setattr(rengine, "time", _clock())
    ref_eng = rengine.ServingEngine(rcfg, rprm, rengine.EngineConfig(
        **ECFG, placement=rspec, rebalance_every=3))
    want = ref_eng.run_until_drained(_requests(rengine.Request, rcfg, 10),
                                     max_steps=200)
    eng = ServingEngine(cfg, prm, EngineConfig(
        **ECFG, placement=spec, rebalance_every=3), device="cpu")
    got = eng.run_until_drained(_requests(Request, cfg, 10), max_steps=200)
    for r, w in zip(got, want):
        assert (r.replica, r.tier, r.generated) == \
            (w.replica, w.tier, w.generated), f"request {r.rid}"
        assert r._locs == w._locs
        assert len(r.generated) == 3
    assert eng.assign_tiers == ref_eng.assign_tiers
    assert (eng.routed, eng.rebalanced) == (ref_eng.routed,
                                            ref_eng.rebalanced)
    assert eng.routed == 10
    assert eng.placement.state_dict() == ref_eng.placement.state_dict()


def test_engine_rebalance_cadence(model):
    _, _, cfg, prm = model
    ecfg = EngineConfig(**ECFG, placement=PlacementConfig(
        "hot_aware", {"hot_frac": 0.5}), rebalance_every=2)
    eng = ServingEngine(cfg, prm, ecfg, device="cpu")
    calls = []
    rebalance = eng.placement.rebalance

    def counted():
        calls.append(eng.routed)
        return rebalance()

    eng.placement.rebalance = counted
    reqs = _requests(Request, cfg, 4)
    for r in reqs:
        r.prefix_id = r.rid % 2
    eng.run_until_drained(reqs, max_steps=100)
    assert eng.routed == 4 and calls == [2, 4]
    assert eng.placement._hot is not None and eng.rebalanced > 0
    for every in (-1, -5):
        with pytest.raises(ValueError, match="rebalance_every"):
            ServingEngine(cfg, prm, EngineConfig(**ECFG,
                                                 rebalance_every=every),
                          device="cpu")
