#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and nvcc.  Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel source under src/repro_torch/kernels/csrc/ with
   nvcc, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (M = 10008 servers, B = 5474 tasks, depths 0,
   1 and 2, fuzzed tie-heavy states): outputs must be equal exactly;
   kernel and plain times by CUDA events, and the bound;
4. the slice: `simulate("balanced_pandas", ...)` at M = 10008, rho = 0.8
   (auto-engages the fleet path), with every launch count set to 0 just
   before and read just after; then 128 slots with the kernel on and off
   must leave an identical carry;
5. profile: steady-state slots/s, and the device's busy share and time by
   kernel over a window of slots under `torch.profiler`.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when there is no card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
M_FLEET, B_FLEET = 10008, 5474
KERNEL_REPS, PLAIN_REPS = 50, 5


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _fuzz_state(rng, m, k, batch):
    """Tie-heavy state: half the tasks pile onto servers 0..5."""
    q = rng.integers(0, 60, (m, k)).astype("int32")
    serving = rng.integers(0, 8, (m,)).astype("int32")
    hot = [sorted(rng.choice(6, 3, replace=False))
           for _ in range(batch // 2)]
    cold = [sorted(rng.choice(m, 3, replace=False))
            for _ in range(batch - batch // 2)]
    return q, serving, np.asarray(hot + cold, np.int32)


def _fleet_route_bound(topo, est, locs):
    """(bound_ms, bound_by) of fleet_route on these inputs: bytes moved
    once (inputs read, outputs written) over the HBM rate against the
    operations these inputs need over the f32 rate — the workload (K
    divides, K-1 adds, the residual's divide and add per server) plus
    one divide, multiply and subtract for every private (task, server)
    pair, i.e. the union of the locals' coarsest-level groups."""
    m, k = est.shape
    d = topo.depth
    b = locs.shape[0]
    nbytes = 4 * (m * k + m + m * k + d * m + 3 * b) + 12 * b
    if d == 0:
        private = sum(len(set(row)) for row in locs.tolist())
    else:
        top = topo.ancestors[d - 1]
        sizes = np.bincount(top)
        g = np.sort(top[locs], axis=1)
        private = int((sizes[g[:, 0]] + sizes[g[:, 1]] * (g[:, 1] != g[:, 0])
                       + sizes[g[:, 2]] * (g[:, 2] != g[:, 1])).sum())
    ops = m * (2 * k + 1) + 3 * private
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_kernels(dev):
    """fleet_route against its plain version at M = 10008, B = 5474."""
    from repro_torch.core import locality as loc
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0)
    rows = {}
    for topo, rates in ((loc.Topology(M_FLEET), loc.Rates(0.5, 0.25)),
                        (loc.Topology(M_FLEET, 6), loc.Rates()),
                        (loc.Topology(M_FLEET, (6, 72)),
                         loc.Rates(0.5, 0.45, 0.35, 0.25))):
        k, d = topo.num_tiers, topo.depth
        est = loc.per_server_rates(rates.as_array(dev), M_FLEET).contiguous()
        anc = torch.as_tensor(np.array(topo.ancestors), device=dev)
        mismatches, max_err = 0, 0.0
        for _ in range(3):
            q, serving, locs = _fuzz_state(rng, M_FLEET, k, B_FLEET)
            args = (torch.as_tensor(q, device=dev),
                    torch.as_tensor(serving, device=dev), est, anc,
                    torch.as_tensor(locs, device=dev))
            sk, tk, vk = ops.fleet_route(*args)
            sp, tp, vp = ref.fleet_route(*args)
            torch.cuda.synchronize()
            bad = ((sk != sp) | (tk != tp)
                   | (vk.view(torch.int32) != vp.view(torch.int32)))
            mismatches += int(bad.sum())
            max_err = max(max_err, float((vk - vp).abs().max()))
        ms = _time_ms(lambda: ops.fleet_route(*args), KERNEL_REPS)
        plain_ms = _time_ms(lambda: ref.fleet_route(*args), PLAIN_REPS)
        bound_ms, bound_by, nbytes, nops = _fleet_route_bound(topo,
                                                              est.cpu(), locs)
        rows[d] = dict(depth=d, mismatches=mismatches, max_abs_err=max_err,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=nops)
        print(f"fleet_route D={d}: {json.dumps(rows[d])}", flush=True)
        if mismatches:
            raise AssertionError(f"fleet_route kernel disagrees with its "
                                 f"plain version at depth {d}: "
                                 f"{mismatches} tasks")
    return rows


def phase_slice(dev):
    """The fleet path at M = 10008 through `simulate`, and kernel on/off."""
    from repro_torch.core import locality as loc, simulator as sim
    from repro_torch.core.rng import DeviceSource
    from repro_torch.kernels import ops
    from repro_torch.sharding import sim as fleet

    topo, rates = loc.Topology(M_FLEET, 6), loc.Rates()
    lam = 0.8 * loc.capacity_hot_rack(topo, rates, 0.5)
    cfg = sim.SimConfig(topo, rates, p_hot=0.5,
                        max_arrivals=int(2.05 * lam), horizon=512,
                        warmup=128)
    if cfg.max_arrivals != B_FLEET:
        raise AssertionError(f"batch {cfg.max_arrivals} != {B_FLEET}")
    est = sim.make_estimates(cfg, "network", 0.2, -1)
    rounds = fleet.FleetConfig().rounds

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out = sim.simulate("balanced_pandas", cfg, lam, est, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    res = dict(out, lam=lam, wall_s=wall, slots_per_s=cfg.horizon / wall,
               launches=launches)
    print(f"slice M={M_FLEET} B={cfg.max_arrivals}: {json.dumps(res)}",
          flush=True)
    want = rounds * cfg.horizon
    if launches["fleet_route"] != want:
        raise AssertionError(f"fleet_route launched {launches} times on the "
                             f"main path, want {want}")
    if abs(out["throughput"] - lam) > 0.02 * lam:
        raise AssertionError(f"throughput {out['throughput']} not within 2% "
                             f"of lam {lam}")
    if not math.isfinite(out["mean_delay"]):
        raise AssertionError(f"mean_delay {out['mean_delay']} not finite")

    # kernel on/off: same seed, 128 slots, identical carry
    est_t = torch.as_tensor(est, device=dev)
    carries = []
    for use_kernel in (True, False):
        init, step = fleet._build_fleet_step(
            "balanced_pandas", cfg, fleet.FleetConfig(use_kernel=use_kernel),
            dev)
        src = DeviceSource(0, lam, cfg.max_arrivals, M_FLEET, dev)
        carry = init()
        for t in range(128):
            carry = step(carry, t, est_t, src.slot(t))
        carries.append([x.cpu() for x in carry])
    for a, b in zip(*carries):
        if not torch.equal(a, b):
            raise AssertionError("kernel on/off carries differ after 128 "
                                 "slots")
    print("kernel on/off: identical carry after 128 slots", flush=True)
    return launches, res, (cfg, lam, est_t)


def phase_profile(dev, cfg, lam, est_t, slots: int = 32):
    """Where a slot's time goes: steady-state slots/s without the
    profiler, then one profiled window — the device's busy share (kernel
    time over wall time) and the device time of the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.rng import DeviceSource
    from repro_torch.sharding import sim as fleet

    init, step = fleet._build_fleet_step("balanced_pandas", cfg,
                                         fleet.FleetConfig(), dev)
    src = DeviceSource(1, lam, cfg.max_arrivals, M_FLEET, dev)
    carry, t = init(), 0

    def run(n):
        nonlocal carry, t
        for _ in range(n):
            carry = step(carry, t, est_t, src.slot(t))
            t += 1
        torch.cuda.synchronize()

    run(16)  # warm up
    t0 = time.perf_counter()
    run(slots)
    steady = slots / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(slots)
        window_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kern)
    out = {"slots_per_s_steady": steady, "window_slots": slots,
           "window_ms_per_slot": window_us / slots / 1e3,
           "device_busy_share": busy_us / window_us if kern else None,
           "device_launches_per_slot": sum(k[1] for k in kern) / slots,
           "top_kernels_us_per_slot": [[k[2][:60], k[0] / slots]
                                       for k in kern[:6]]}
    print(f"profile M={M_FLEET}: {json.dumps(out)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import _build

    print(_device_line(), flush=True)  # "name, power limit" as nvidia-smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = phase_kernels(dev)
    launches, _, (cfg, lam, est_t) = phase_slice(dev)
    phase_profile(dev, cfg, lam, est_t)

    main_row = rows[1]  # the slice's Topology(10008, 6)
    print(json.dumps({"kernels": [{
        "name": "fleet_route", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_route.cu",
        "replaces": "src/repro/kernels/slot_step.py:46",
        "launches": launches["fleet_route"],
        "mismatches": sum(r["mismatches"] for r in rows.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
