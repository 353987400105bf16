"""The readers of the program's spans and counters (`portbench.spans`,
``metrics/<phase>.py``), on traces made by hand."""

import pytest

from portbench import harness, spans
from portbench.trace import Op, Trace

MS = 1_000_000  # ns
SHAPE = {"cells": 3, "servers": 12, "tiers": 3, "depth": 1, "batch": 5,
         "top_group": 6}
PHASES = ("study_setup_s", "loop_idle_share", "arrivals_ms_per_slot",
          "route_ms_per_slot", "water_level_ms_per_slot", "serve_ms_per_slot",
          "fleet_route_scans_per_task")

# one study of two slots: host spans and launch calls (ms)
SPANS = [("study", 0, 100), ("study.estimates", 1, 5),
         ("fleet.setup", 6, 30), ("fleet.setup.estimates", 6, 10),
         ("fleet.setup.cdf", 12, 28), ("fleet.loop", 30, 90),
         ("fleet.draws", 31, 34),
         ("fleet.arrivals", 34, 36), ("fleet.route", 36, 55),
         ("fleet.route.private", 37, 39),
         ("fleet.route.water_level", 40, 45),
         ("fleet.route.rank_clamp", 46, 50), ("fleet.serve", 55, 59),
         ("fleet.draws", 61, 64),
         ("fleet.route", 64, 80), ("fleet.route.pool_fill", 70, 80),
         ("fleet.route.water_level", 71, 75), ("fleet.serve", 80, 89),
         ("fleet.finalize", 91, 99)]
# (call at ms, device op, device start ms, device end ms)
LAUNCHED = [(9, "cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)", 9, 10),
            (29, "cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)", 29, 30),
            (32, "cudaLaunchKernel", "void draw_kernel", 32, 33),
            (35, "cudaLaunchKernel", "void sort_kernel", 35, 37),
            (38, "cudaLaunchKernel", "void fleet_route_kernel<1>", 38, 44),
            (41, "cudaLaunchKernel", "void bisect_kernel", 44, 45),
            (46, "cudaLaunchKernelExC", "void argsort_kernel", 46, 48),
            (57, "cudaLaunchKernel", "void serve_kernel", 57, 58),
            (62, "cudaLaunchKernel", "void draw_kernel", 62, 63),
            (72, "cudaLaunchKernel", "void bisect_kernel", 72, 76),
            (78, "cudaMemsetAsync", "Memset (Device)", 78, 79),
            (85, "cudaLaunchKernel", "void serve_kernel", 85, 86),
            (95, "cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)", 95, 96)]


def _trace(launched=LAUNCHED, program=SPANS, extra_device=()):
    host = [Op(n, a * MS, b * MS) for n, a, b in program]
    host += [Op(call, t * MS, t * MS + MS // 10)
             for t, call, _, _, _ in launched]
    host.append(Op("aten::sum", 2 * MS, 3 * MS))   # not a span, not a call
    device = [Op(name, a * MS, b * MS) for _, _, name, a, b in launched]
    device += list(extra_device)
    kernels = [d for d in device if d.name.startswith("void ")]
    return Trace(kernels, device, host, (0, 100 * MS), 2, SHAPE)


def test_launch_order_attribution():
    t = _trace()
    found = spans.attribution(t)
    assert spans.attribution(t) is found            # worked out once
    assert sorted(found.spans) == sorted({n for n, _, _ in SPANS})
    by_inner = {}
    for stack, s in found.kernel_s.items():
        by_inner[stack[-1]] = by_inner.get(stack[-1], 0) + s
    # kernels only, as device_ms_per_slot counts: the copies at 9, 29
    # and 95 ms and the set at 78 ms stay out
    assert by_inner == pytest.approx({
        "fleet.draws": 0.002, "fleet.arrivals": 0.002,
        "fleet.route.private": 0.006, "fleet.route.water_level": 0.005,
        "fleet.route.rank_clamp": 0.002, "fleet.serve": 0.002})
    # every kernel once: the phases, set-up and finalize add up to
    # device_ms_per_slot
    assert sum(found.kernel_s.values()) * 1e3 / t.slots == pytest.approx(
        harness.read_metric("device_ms_per_slot", t))
    read = {n: harness.read_metric(n, t) for n in PHASES[2:6]}
    assert read == pytest.approx({"arrivals_ms_per_slot": (1 + 2 + 1) / 2,
                                  "route_ms_per_slot": (6 + 1 + 2 + 4) / 2,
                                  "water_level_ms_per_slot": (1 + 4) / 2,
                                  "serve_ms_per_slot": (1 + 1) / 2})


def test_study_setup_is_the_union_of_nested_set_up_spans():
    # study.estimates 1-5, fleet.setup 6-30 holding its parts: 4 + 24 ms
    assert harness.read_metric("study_setup_s", _trace()) == pytest.approx(
        0.028)
    overlapping = SPANS + [("study.estimates", 3, 8)]
    assert harness.read_metric("study_setup_s", _trace(program=overlapping)
                               ) == pytest.approx(0.029)


def test_loop_idle_share():
    # fleet.loop 30-90 ms; device busy in it 32-33, 35-37, 38-45, 46-48,
    # 57-58, 62-63, 72-76, 78-79, 85-86: 20 of 60 ms
    assert harness.read_metric("loop_idle_share", _trace()) == \
        pytest.approx(100 * (1 - 20 / 60))


def test_every_reader_finds_nothing_without_program_spans():
    t = _trace(program=[])
    for name in PHASES:
        assert harness.read_metric(name, t) is None
    assert spans.attribution(t).kernel_s is None


def test_a_mismatched_launch_count_reads_no_phase(capsys):
    t = _trace(extra_device=[Op("void stray_kernel", 97 * MS, 98 * MS)])
    for name in PHASES[2:6]:
        assert harness.read_metric(name, t) is None
    assert "13 launch calls against 14 device operations" in \
        capsys.readouterr().err
    # the span readers need no matching
    assert harness.read_metric("study_setup_s", t) == pytest.approx(0.028)


def test_a_launch_of_another_kind_reads_no_phase(capsys):
    swapped = list(LAUNCHED)
    swapped[0] = (9, "cudaLaunchKernel", "Memcpy HtoD (Pageable -> Device)",
                  9, 10)
    assert harness.read_metric("route_ms_per_slot", _trace(swapped)) is None
    assert "1 of 13 launch calls are not of the kind" in \
        capsys.readouterr().err


def test_a_few_operations_out_of_launch_order_are_taken(capsys):
    """The device's timestamps may put an operation before the one
    launched ahead of it: a few such pairs are read, and reported."""
    n = 4000
    program = [("study", 0, 10 * n), ("fleet.loop", 0, 10 * n),
               ("fleet.serve", 0, 5 * n), ("fleet.route", 5 * n, 10 * n)]
    launched = [(10 * i, "cudaLaunchKernel", "void k_kernel", 10 * i + 2,
                 10 * i + 3) for i in range(n)]
    # launch 2000 is a set, stamped on the device before kernel 1999
    launched[n // 2] = (5 * n, "cudaMemsetAsync", "Memset (Device)",
                        5 * n - 9, 5 * n - 8)
    t = _trace(launched, program=program)
    # kernel 1999 moves to the route; the set it swapped with is no kernel
    assert harness.read_metric("serve_ms_per_slot", t) == pytest.approx(
        (n / 2 - 1) / 2)
    assert "2 pairs of other kinds" in capsys.readouterr().err


def test_library_launches_without_a_runtime_record():
    """The nvcc-built library's launches may leave no runtime record:
    its kernels go to fleet.route.private, the rest match in order."""
    unrecorded = [x for x in LAUNCHED if "fleet_route" not in x[2]]
    t = _trace(unrecorded, extra_device=[Op("void fleet_route_kernel<1>",
                                            38 * MS, 44 * MS)])
    assert harness.read_metric("route_ms_per_slot", t) == pytest.approx(6.5)
    assert harness.read_metric("arrivals_ms_per_slot", t) == \
        pytest.approx(2.0)


def test_no_water_level_without_its_span():
    po2 = [s for s in SPANS if not s[0].startswith("fleet.route.")]
    t = _trace(program=po2)
    assert harness.read_metric("water_level_ms_per_slot", t) is None
    assert harness.read_metric("route_ms_per_slot", t) == pytest.approx(
        (6 + 1 + 2 + 4) / 2)


def test_scans_per_task_reads_the_program_counters(monkeypatch):
    from repro_torch import telemetry

    t = _trace()
    monkeypatch.setattr(telemetry, "COUNTS", {})
    assert harness.read_metric("fleet_route_scans_per_task", t) is None
    monkeypatch.setattr(telemetry, "COUNTS",
                        {"fleet_route.tasks_scanned": 2 * 512 * 624 * 5474,
                         "fleet.tasks_arrived": 1_545_000})
    assert harness.read_metric("fleet_route_scans_per_task", t) == \
        pytest.approx(2 * 512 * 624 * 5474 / 1_545_000)
    monkeypatch.delattr(telemetry, "COUNTS")   # a program without counters
    assert harness.read_metric("fleet_route_scans_per_task", t) is None
