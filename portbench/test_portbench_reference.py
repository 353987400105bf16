"""The plain reference against the port at a cut size on the CPU: equal
bit for bit in every cell, for Balanced-PANDAS at depths 1 and 2 and for
power-of-d, and unequal when computed in bfloat16 (the control)."""

import numpy as np
import pytest
import torch

from portbench import spec
from portbench._cut import cut
from portbench.drivers import fleet_study
from portbench.reference import fleet as ref

CELLS = ("rack10k-bp-study", "rack10k-po2-study", "fattree8k-bp-study")
SEED = 2**31 + 7   # past 32 signed bits, as a run's --seed may be


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(cell, seed):
    return fleet_study.prepare(cell, seed, "cpu").call()


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port(name):
    cell = cut(name)
    got = _program(cell, SEED)
    want = ref.study(cell.config, cell.traffic,
                     fleet_study.seeds(cell, SEED), "cpu")
    assert got["delay"].shape == (2, 3, 2)
    assert ref.compare(got, want) == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_unequal(name):
    cell = cut(name, horizon=80, warmup=20)
    got = _program(cell, SEED)
    control = ref.study(cell.config, cell.traffic,
                        fleet_study.seeds(cell, SEED), "cpu",
                        dtype=torch.bfloat16)
    assert ref.compare(control, got) > 0


@pytest.mark.parametrize("name", ("rack10k", "fattree8k"))
def test_capacity_and_estimates_equal_the_programs(name):
    from repro_torch.core import locality as loc
    from repro_torch.core import simulator as sim

    cell = cut(f"{name}-bp-study")
    c, t = cell.config, cell.traffic
    full = spec.cell(f"{name}-bp-study").config
    for cfg in (c, full):
        topo = loc.Topology(cfg["num_servers"], tuple(cfg["group_sizes"]))
        rates = loc.Rates(tuple(cfg["rates"]))
        assert ref.hot_rack_capacity(cfg["num_servers"], cfg["group_sizes"],
                                     cfg["rates"], cfg["p_hot"]) == \
            loc.capacity_hot_rack(topo, rates, cfg["p_hot"])
    sim_cfg = sim.SimConfig(topo=loc.Topology(c["num_servers"],
                                              tuple(c["group_sizes"])),
                            true_rates=loc.Rates(tuple(c["rates"])))
    ests = ref.estimate_grid(c["num_servers"], c["rates"], t["eps_grid"],
                             t["signs"])
    want = [sim.make_estimates(sim_cfg, "network", 0.0, -1)]
    want += [sim.make_estimates(sim_cfg, "per_server", e, s)
             for s in t["signs"] for e in t["eps_grid"]]
    np.testing.assert_array_equal(ests, np.stack(want))


def test_compare_counts_cells():
    a = {"delay": np.array([1.0, np.nan, 3.0], np.float32),
         "throughput": np.array([1.0, 2.0, 3.0]),
         "final_n": np.array([1, 2, 3], np.float32)}
    b = {k: v.copy() for k, v in a.items()}
    assert ref.compare(a, b) == 0
    b["delay"][0] = np.nextafter(np.float32(1.0), np.float32(2.0))
    b["final_n"][2] = 4
    assert ref.compare(a, b) == 2
