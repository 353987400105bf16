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
