"""The port's locality model and estimates equal the reference's."""

import numpy as np
import pytest
import torch

from repro.core import locality as rloc, simulator as rsim
from repro_torch.core import locality as loc, simulator as sim
from _torch_port import single_torch_thread  # noqa: F401

# (num_servers, group spec, rates): K = 2, 3, 4 and heterogeneous racks
CASES = (
    (24, (), (0.5, 0.25)),
    (24, 6, (0.5, 0.45, 0.25)),
    (36, (3, 6), (0.5, 0.45, 0.35, 0.25)),
    (24, ((6, 6, 4, 4, 4),), (0.5, 0.45, 0.25)),
    (24, ((4, 4, 4, 6, 6), (12, 12)), (0.5, 0.45, 0.35, 0.25)),
)
IDS = ["k2", "k3", "k4", "hetero_k3", "hetero_k4"]


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_topology_matches_reference(m, groups, rates):
    ref, port = rloc.Topology(m, groups), loc.Topology(m, groups)
    assert port.group_sizes == ref.group_sizes
    assert (port.depth, port.num_tiers, port.num_racks, port.min_rack_size) \
        == (ref.depth, ref.num_tiers, ref.num_racks, ref.min_rack_size)
    np.testing.assert_array_equal(port.ancestors, ref.ancestors)
    np.testing.assert_array_equal(port.rack_of, ref.rack_of)
    np.testing.assert_array_equal(loc.as_ancestors(port.ancestors).numpy(),
                                  np.asarray(rloc.as_ancestors(ref.ancestors)))


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_capacity_matches_reference(m, groups, rates):
    ref, port = rloc.Topology(m, groups), loc.Topology(m, groups)
    for p_hot in (0.0, 0.3, 0.5, 0.9):
        for hot_rack in range(ref.num_racks):
            assert loc.capacity_hot_rack(port, loc.Rates(rates), p_hot,
                                         hot_rack) == \
                rloc.capacity_hot_rack(ref, rloc.Rates(rates), p_hot,
                                       hot_rack)
            np.testing.assert_array_equal(
                loc.hot_rack_tiers(port, hot_rack),
                rloc.hot_rack_tiers(ref, hot_rack))


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_estimates_match_reference(m, groups, rates):
    rcfg = rsim.SimConfig(rloc.Topology(m, groups), rloc.Rates(rates),
                          horizon=10, warmup=2)
    pcfg = sim.SimConfig(loc.Topology(m, groups), loc.Rates(rates),
                         horizon=10, warmup=2)
    for mode in ("uniform", "network", "per_server"):
        for eps, sign in ((0.0, -1), (0.2, -1), (0.3, 1)):
            a = sim.make_estimates(pcfg, mode, eps, sign, seed=4)
            b = rsim.make_estimates(rcfg, mode, eps, sign, seed=4)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    r = loc.Rates(rates)
    np.testing.assert_array_equal(
        loc.per_server_rates(r.as_array(), m).numpy(),
        np.asarray(rloc.per_server_rates(rloc.Rates(rates).as_array(), m)))


def test_validation_matches_reference():
    for bad in ((24, ((6, 6, 6),)), (24, ((4, 8, 12), (8, 16))), (24, 5)):
        with pytest.raises(ValueError):
            rloc.Topology(*bad)
        with pytest.raises(ValueError):
            loc.Topology(*bad)
    with pytest.raises(ValueError):
        loc.Rates(0.5, 0.5)
    with pytest.raises(ValueError):
        sim.SimConfig(loc.Topology(24, 6), loc.Rates(0.5, 0.25))
    with pytest.raises(ValueError):
        sim.SimConfig(loc.Topology(24, 2), loc.Rates())
    assert loc.Rates() == loc.Rates(0.5, 0.45, 0.25)
    assert loc.Rates().as_array().dtype == torch.float32


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_tier_seam_matches_reference(m, groups, rates):
    """server_tiers / tier_masks / class_of / pair_tiers / pair_rate on a
    batch of tasks, against the reference's per-task functions."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(m)
    rtopo, topo = rloc.Topology(m, groups), loc.Topology(m, groups)
    r_anc = jnp.asarray(rtopo.ancestors)
    anc = torch.as_tensor(np.array(topo.ancestors))
    tasks = np.sort(np.stack([rng.choice(m, 3, replace=False)
                              for _ in range(12)]), axis=1).astype(np.int32)
    batch = torch.as_tensor(tasks).view(3, 4, 3)        # two lead dims
    tiers = loc.server_tiers(batch, anc).view(12, m)
    masks = loc.tier_masks(batch, anc).view(12, len(rates), m)
    srv = torch.as_tensor(rng.integers(0, m, 12))
    cls = loc.class_of(torch.as_tensor(tasks), anc, srv)
    for i, task in enumerate(tasks):
        np.testing.assert_array_equal(
            tiers[i].numpy(), np.asarray(rloc.server_tiers(task, r_anc)))
        np.testing.assert_array_equal(
            masks[i].numpy(), np.asarray(rloc.tier_masks(task, r_anc)))
        assert int(cls[i]) == int(rloc.class_of(task, r_anc, int(srv[i])))
    a, b = rng.integers(0, m, 40), rng.integers(0, m, 40)
    np.testing.assert_array_equal(
        loc.pair_tiers(torch.as_tensor(a), torch.as_tensor(b), anc).numpy(),
        np.asarray(rloc.pair_tiers(jnp.asarray(a), jnp.asarray(b), r_anc)))
    est = rng.uniform(0.1, 1.0, (40, len(rates))).astype(np.float32)
    got = loc.pair_rate(torch.as_tensor(a)[:, None], torch.arange(m), anc,
                        torch.as_tensor(est))
    for i in range(40):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(
            rloc.pair_rate(int(a[i]), jnp.arange(m), r_anc,
                           jnp.asarray(est[i]))))
    # random tie-breaks: the reference's Gumbels, handed over, decide alike
    score = rng.integers(0, 3, (40, m)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(m), 40)
    g = np.stack([np.asarray(jax.random.gumbel(k, (m,))) for k in keys])
    lo = loc.random_argmin(torch.as_tensor(g), torch.as_tensor(score))
    hi = loc.random_argmax(torch.as_tensor(g), torch.as_tensor(score))
    for i in range(40):
        assert int(lo[i]) == int(rloc.random_argmin(keys[i], score[i]))
        assert int(hi[i]) == int(rloc.random_argmax(keys[i], score[i]))


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_named_views_match_reference(m, groups, rates):
    """`Topology.groups_at`/`pod_of`/`servers_per_rack` (its error on
    heterogeneous racks included), `Rates.heavy_traffic_optimal` and
    `Rates.scaled` (clamped, re-validated)."""
    ref, port = rloc.Topology(m, groups), loc.Topology(m, groups)
    for lvl in range(ref.depth):
        assert port.groups_at(lvl) == ref.groups_at(lvl)
    np.testing.assert_array_equal(port.pod_of, ref.pod_of)
    try:
        want = ref.servers_per_rack
    except ValueError as e:
        with pytest.raises(ValueError, match="heterogeneous"):
            port.servers_per_rack
        assert "heterogeneous" in str(e)
    else:
        assert port.servers_per_rack == want
    for vals in (rates, (0.5, 0.3, 0.2), (0.9, 0.5, 0.3, 0.25)):
        r, p = rloc.Rates(vals), loc.Rates(vals)
        assert p.heavy_traffic_optimal == r.heavy_traffic_optimal
        for mult in (0.5, 1.0, 1.3, 3.0):
            try:
                want = r.scaled(mult).values
            except ValueError:
                with pytest.raises(ValueError):
                    p.scaled(mult)
            else:
                assert p.scaled(mult).values == want


@pytest.mark.parametrize("m,groups,rates", CASES, ids=IDS)
def test_locality_masks_and_rate_vector_match_reference(m, groups, rates):
    ref = rloc.Topology(m, groups)
    locs = np.random.default_rng(m).integers(0, m, (16, 3)).astype(np.int32)
    anc = loc.Topology(m, groups).ancestors
    rk = loc.Rates(rates).values
    got_v = loc.rate_vector(torch.tensor(locs), anc, rk)
    got_l, got_r = loc.locality_masks(torch.tensor(locs),
                                      torch.tensor(ref.rack_of))
    assert got_v.dtype == torch.float32
    for i, row in enumerate(locs):
        want_v = rloc.rate_vector(row, ref.ancestors,
                                  rloc.Rates(rates).as_array())
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        want_l, want_r = rloc.locality_masks(row, ref.rack_of)
        np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_r[i].numpy(), np.asarray(want_r))
