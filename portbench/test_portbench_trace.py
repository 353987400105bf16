"""The per-layer readers and the breakdown, on a trace made by hand."""

import pytest

from portbench import harness
from portbench.costs import fleet_route as cost
from portbench.trace import SPAN, Op, Trace, breakdown, device_kind

MS = 1_000_000  # ns


def _trace(kernels, copies=(), host=(), slots=2):
    shape = {"cells": 3, "servers": 12, "tiers": 3, "depth": 1, "batch": 5,
             "top_group": 6}
    ops = list(kernels) + list(copies)
    return Trace(list(kernels), ops, list(host), (0, 100 * MS), slots, shape)


def test_device_kind():
    assert device_kind("void at::native::reduce_kernel<512>(...)") == "kernel"
    assert device_kind("void (anonymous namespace)::fleet_route_kernel<1>("
                       "int const*)") == "kernel"
    assert device_kind("Memcpy DtoH (Device -> Pageable)") == "copy"
    assert device_kind("Memset (Device)") == "copy"
    assert device_kind(SPAN) == "other"
    assert device_kind("Context Sync") == "other"


def test_readers():
    k = [Op("void a_kernel", 0, 10 * MS), Op("void a_kernel", 5 * MS, 20 * MS),
         Op(f"void {cost.KERNEL}<1>", 50 * MS, 60 * MS)]
    t = _trace(k, copies=[Op("Memcpy HtoD", 90 * MS, 95 * MS)])
    assert harness.read_metric("launches_per_slot", t) == 1.5
    assert harness.read_metric("device_ms_per_slot", t) == pytest.approx(
        (10 + 15 + 10) / 2)
    # busy: [0, 20] + [50, 60] + [90, 95] = 35 of 100 ms
    assert t.busy_s == pytest.approx(0.035)
    assert harness.read_metric("device_idle_share", t) == pytest.approx(65.0)
    bound, _ = cost.bound_seconds(3, 12, 3, 1, 5, 6)
    assert harness.read_metric("fleet_route_roofline", t) == pytest.approx(
        100 * bound / 0.010)


def test_readers_find_nothing_in_an_empty_trace():
    t = _trace([])
    for name in ("launches_per_slot", "device_ms_per_slot",
                 "device_idle_share", "fleet_route_roofline"):
        assert harness.read_metric(name, t) is None


def test_no_roofline_without_its_kernel():
    t = _trace([Op("void other_kernel", 0, MS)])
    assert harness.read_metric("fleet_route_roofline", t) is None


def test_breakdown_labels_gaps_with_the_innermost_host_op():
    k = [Op("void a_kernel", 0, 10 * MS), Op("void b_kernel", 40 * MS,
                                              45 * MS)]
    host = [Op("aten::sum", 5 * MS, 30 * MS), Op("aten::item", 20 * MS,
                                                 30 * MS)]
    out = breakdown(_trace(k, host=host))
    assert out["device_ops"] == [["void a_kernel", pytest.approx(0.010)],
                                 ["void b_kernel", pytest.approx(0.005)]]
    # gaps: [10, 40] (middle 25: inside aten::item) and [45, 100]
    assert out["idle_gaps"] == [[f"{SPAN}:python", pytest.approx(0.055)],
                                ["aten::item", pytest.approx(0.030)]]
