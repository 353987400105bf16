"""One run of a cell: set-up, the measured window, the trace, and the
comparison with the plain reference that decides ``correct``.

The cell's driver (``drivers/<driver>.py``, named by its traffic mix)
builds its work and warms it up; that is set-up.  The window then makes
the driver's calls back to back until the window's seconds are spent;
the last call finishes and counts in full, and the driver turns the
calls and the time into its end-to-end metrics.  A traced run
(``trace=True``) makes one call under the profiler instead and reports
the per-layer metrics.  After the window (the peak memory read, the
program's state freed) the driver compares every call's outputs with
the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import time
from pathlib import Path
from typing import Any, Dict, List

import torch

from portbench import trace as tr
from portbench.spec import Cell

METRICS = Path(__file__).resolve().parent / "metrics"


def read_metric(name: str, trace) -> Any:
    """The per-layer metric `name` from its reader ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(trace)


def _metric(bench: Dict[str, Any], name: str, value: float):
    unit = [m["unit"] for group in ("end_to_end", "per_layer")
            for m in bench[group] if m["name"] == name][0]
    return {"value": value, "unit": unit}


def _window(work, seconds: float):
    """The driver's calls back to back until `seconds` are spent: their
    outputs and the window's clock at the end of each."""
    outputs: List[Any] = []
    ends: List[float] = []
    t0 = time.perf_counter()
    while not ends or ends[-1] < seconds:
        outputs.append(work.call())
        ends.append(time.perf_counter() - t0)
    return outputs, ends


def run(cell: Cell, bench: Dict[str, Any], seed: int, seconds: float,
        trace: bool, device, t_start: float) -> Dict[str, Any]:
    """One run; the result line as a dict.  On a device other than the
    card it runs everything but reports no metric: a number from the
    CPU is never written under a metric's name."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if trace and not on_card:
        raise ValueError("a traced run reads the card's profiler; it needs "
                         "a CUDA device")
    work = cell.driver.prepare(cell, seed, dev)
    work.warm()
    setup_s = time.perf_counter() - t_start

    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1}
    metrics: Dict[str, Any] = {}
    if trace:
        out, traced = tr.capture(work.call, work.slots, work.shape)
        outputs = [out]
        for name in cell.per_layer:
            value = read_metric(name, traced)
            if value is not None:
                metrics[name] = _metric(bench, name, value)
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        notes = {"breakdown": tr.breakdown(traced)}
        del traced
    else:
        outputs, ends = _window(work, seconds)
        if on_card:
            values = dict(work.end_to_end(len(outputs), ends[-1]),
                          setup_s=setup_s)
            metrics = {k: _metric(bench, k, v) for k, v in values.items()
                       if k in cell.end_to_end}
        notes = {"window_s": ends[-1],
                 "call_s": [b - a for a, b in zip([0.0] + ends, ends)]}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                        if on_card else 0)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, failed = work.check(outputs)
    return {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": work.attempted(len(outputs)), "failed": failed,
            "metrics": metrics, "device": device_info,
            "calls": len(outputs), "setup_s": setup_s, **notes,
            "checks": checks}
