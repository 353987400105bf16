"""The cost counts of fleet_route, from shapes alone."""

import pytest

from portbench import peaks
from portbench.costs import fleet_route as cost


@pytest.mark.parametrize("cells,servers,tiers,depth,batch,want", [
    # chip_smoke.py's three shapes: one cell at M 10,008, D 1, B 5,474;
    # the same at N 30; one cell at D 2
    (1, 10008, 3, 1, 5474, 451_632),
    (30, 10008, 3, 1, 5474, 12_388_032),
    (1, 10008, 4, 2, 5474, 571_728),
    # the two Balanced-PANDAS cells: 624 cells of rack10k and fattree8k
    (624, 10008, 3, 1, 5474, 256_878_432),
    # (624 x 403,848 + 4 x 2 x 8,192)
    (624, 8192, 4, 2, 4539, 252_066_688),
])
def test_bytes_moved(cells, servers, tiers, depth, batch, want):
    assert cost.bytes_moved(cells, servers, tiers, depth, batch) == want


@pytest.mark.parametrize("servers,tiers,depth,batch,top", [
    (10008, 3, 1, 5474, 6), (8192, 4, 2, 4539, 256)])
def test_bound_is_set_by_bytes_at_the_cells(servers, tiers, depth, batch,
                                            top):
    seconds, by = cost.bound_seconds(624, servers, tiers, depth, batch, top)
    assert by == "bytes"
    assert seconds == pytest.approx(
        cost.bytes_moved(624, servers, tiers, depth, batch)
        / peaks.HBM_BYTES_PER_S)


def test_operations_count_the_workload_and_one_top_group_a_task():
    # 2 cells of 12 servers, 3 tiers, 5 tasks, top groups of 4
    assert cost.operations(2, 12, 3, 5, 4) == 2 * (12 * 7 + 3 * 5 * 4)
