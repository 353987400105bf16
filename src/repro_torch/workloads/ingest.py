"""Ingest adapters: map external cluster-trace formats onto the `Trace`
schema (ROADMAP follow-on to trace-driven replay).

The first adapter covers the Google cluster-usage **v2** ``task_events``
table (Reiss & Wilkes, "Google cluster-usage traces: format + schema",
2011-2014 releases): headerless CSV shards whose rows are per-task
scheduling events with microsecond timestamps.  The adapter bins SUBMIT
events into uniform wall-clock intervals — exactly the per-interval
arrival counts our `Trace` carries — and, optionally, derives per-rack
arrival-weight annotations from the ``machine_id`` column (machines are
hashed onto racks, so key skew in the recorded placement becomes the
`rack_weights` knob the simulator replays).

The second adapter covers the Alibaba **cluster-trace-v2018** release:
``batch_task`` rows (second-granularity ``start_time`` stamps, one row
per task with an instance count) supply the arrival counts, and the
``container`` table's ``machine_id`` column supplies the per-rack weight
annotations on the same interval grid — two files because Alibaba splits
the workload across tables where Google uses one.  Both adapters share
the machine -> rack hashing and the deterministic-exporter round-trip
discipline described below.

Everything downstream is free: ``trace_to_scenario`` compiles the result
into the same piecewise schedule every synthetic scenario uses, so a
recorded Google trace replays through the simulator, both Pallas kernels,
the serving engine and the data pipeline with zero new branching.

A deterministic exporter (`save_google_cluster_csv`) writes a trace back
out in the same column layout (one synthetic SUBMIT row per counted
arrival, evenly spaced inside its interval), which is what makes the
round-trip property testable: export -> ingest reproduces the original
per-interval counts bit-for-bit *given the interval count* — an event
stream cannot represent trailing empty intervals, so round-tripping a
trace that ends in zero-arrival intervals needs ``num_intervals=``
passed explicitly at load time (the loader's default covers only up to
the last event).
"""

from __future__ import annotations

import csv
import hashlib
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.workloads.trace import Trace

# Google cluster-usage v2 task_events column order (no header row in the
# published shards).
GOOGLE_V2_TASK_EVENT_COLUMNS = (
    "time", "missing_info", "job_id", "task_index", "machine_id",
    "event_type", "user", "scheduling_class", "priority",
    "cpu_request", "memory_request", "disk_request", "different_machines",
)
_TIME, _MACHINE, _EVENT = 0, 4, 5
GOOGLE_V2_SUBMIT = 0  # event_type of a task submission
GOOGLE_V2_TIME_UNIT = 1e-6  # timestamps are microseconds


def _rack_of_machine(machine: str, num_racks: int) -> int:
    """Stable machine -> rack assignment (the trace does not publish the
    physical topology, so machines are hashed onto racks)."""
    digest = hashlib.blake2s(machine.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "big") % num_racks


def load_google_cluster_csv(path: Union[str, Path], *,
                            interval: float = 300.0,
                            name: Optional[str] = None,
                            event_types: Sequence[int] = (GOOGLE_V2_SUBMIT,),
                            time_unit: float = GOOGLE_V2_TIME_UNIT,
                            num_intervals: Optional[int] = None,
                            num_racks: Optional[int] = None) -> Trace:
    """Read a Google cluster-usage v2 ``task_events`` CSV shard into a
    `Trace` of per-interval arrival counts.

    interval      -- seconds per trace interval (default 5 minutes)
    event_types   -- which event codes count as arrivals (default SUBMIT)
    time_unit     -- seconds per timestamp unit (v2 uses microseconds)
    num_intervals -- force the interval count (default: cover the last
                     event — pass it explicitly to keep trailing
                     zero-arrival intervals, which no event stream can
                     encode); events past the end are rejected
    num_racks     -- when set, annotate each interval with per-rack
                     arrival weights derived from the machine_id column
                     (machines hashed onto `num_racks` racks; intervals
                     with no machine-attributed events fall back to
                     uniform weights)

    Rows shorter than the event-type column, and rows whose timestamp or
    event code does not parse, are rejected with their line number — a
    mis-delimited shard should fail loudly, not bin garbage.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no trace file at {path}")
    if interval <= 0:
        raise ValueError(f"interval must be > 0, got {interval}")
    if time_unit <= 0:
        raise ValueError(f"time_unit must be > 0, got {time_unit}")
    wanted = {int(e) for e in event_types}
    times: list = []
    machines: list = []
    with open(path, newline="") as f:
        for ln, row in enumerate(csv.reader(f), 1):
            if not row:
                continue
            if ln == 1 and not row[_TIME].strip().lstrip("-").isdigit():
                continue  # tolerate a header row on hand-built shards
            if len(row) <= _EVENT:
                raise ValueError(
                    f"{path}:{ln}: row has {len(row)} columns, need at "
                    f"least {_EVENT + 1} (google v2 task_events layout)")
            try:
                t = int(row[_TIME])
                ev = int(row[_EVENT])
            except ValueError:
                raise ValueError(f"{path}:{ln}: unparseable time/event "
                                 f"{row[_TIME]!r}/{row[_EVENT]!r}") from None
            if ev not in wanted:
                continue
            if t < 0:
                raise ValueError(f"{path}:{ln}: negative timestamp {t}")
            times.append(t * time_unit)
            machines.append(row[_MACHINE].strip()
                            if len(row) > _MACHINE else "")
    if not times:
        raise ValueError(f"{path}: no events with type in {sorted(wanted)}")
    times_arr = np.asarray(times, np.float64)
    n = num_intervals if num_intervals is not None \
        else int(np.floor(times_arr.max() / interval)) + 1
    if n < 1:
        raise ValueError(f"num_intervals must be >= 1, got {n}")
    horizon = n * interval
    if times_arr.max() >= horizon:
        raise ValueError(f"{path}: event at {times_arr.max():.0f}s falls "
                         f"outside the {n} x {interval:.0f}s horizon")
    bins = np.minimum((times_arr / interval).astype(np.int64), n - 1)
    arrivals = np.bincount(bins, minlength=n).astype(np.float64)

    rack_weights = None
    if num_racks is not None:
        if num_racks < 1:
            raise ValueError(f"num_racks must be >= 1, got {num_racks}")
        rack_weights = np.zeros((n, num_racks), np.float64)
        for b, machine in zip(bins, machines):
            if machine:
                rack_weights[b, _rack_of_machine(machine, num_racks)] += 1.0
        empty = rack_weights.sum(axis=1) == 0
        rack_weights[empty] = 1.0  # uniform where placement is unknown
        rack_weights /= rack_weights.sum(axis=1, keepdims=True)

    return Trace(name=name or path.stem, interval=float(interval),
                 arrivals=arrivals, rack_weights=rack_weights)


def save_google_cluster_csv(trace: Trace, path: Union[str, Path], *,
                            time_unit: float = GOOGLE_V2_TIME_UNIT) -> Path:
    """Write a trace as a Google cluster-usage v2 ``task_events`` shard:
    one SUBMIT row per counted arrival, spaced evenly inside its interval.

    When the trace carries `rack_weights` (N, R), each row's machine_id is
    drawn from a per-rack machine pool (largest-remainder apportionment of
    the interval's weights over its rows), so
    ``load_google_cluster_csv(..., num_racks=R)`` recovers the annotation.
    The export is deterministic — the round-trip test relies on it.
    Trailing zero-arrival intervals produce no rows (an event stream has
    no way to mark them); reload with ``num_intervals=trace.num_intervals``
    to preserve them.
    """
    path = Path(path)
    num_racks = (None if trace.rack_weights is None
                 else int(trace.rack_weights.shape[1]))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        job = 0
        for i, count in enumerate(np.asarray(trace.arrivals)):
            count = int(round(float(count)))
            if count <= 0:
                continue
            t0 = i * trace.interval
            step = trace.interval / count
            if num_racks is None:
                racks = [None] * count
            else:
                weights = np.asarray(trace.rack_weights[i], np.float64)
                frac = weights / weights.sum() * count
                quota = np.floor(frac).astype(int)
                for j in np.argsort(-(frac - quota))[: count - quota.sum()]:
                    quota[j] += 1  # largest-remainder top-up to `count`
                racks = [r for r, q in enumerate(quota) for _ in range(q)]
            for j in range(count):
                t = int(round((t0 + j * step) / time_unit))
                rack = racks[j]
                machine = "" if rack is None else \
                    _machine_in_rack(rack, num_racks)
                job += 1
                w.writerow([t, 0, job, 0, machine, GOOGLE_V2_SUBMIT,
                            "user", 0, 0, "", "", "", ""])
    return path


@lru_cache(maxsize=4096)
def _machine_in_rack(rack: int, num_racks: int) -> str:
    """A machine id that `_rack_of_machine` maps back onto `rack`, found by
    deterministic search over candidate names (a handful of hash probes)."""
    i = 0
    while True:
        cand = f"m{rack}-{i}"
        if _rack_of_machine(cand, num_racks) == rack:
            return cand
        i += 1


# ---------------------------------------------------------------------------
# Alibaba cluster-trace-v2018
# ---------------------------------------------------------------------------

# Alibaba cluster-trace-v2018 column orders (headerless CSVs).
ALIBABA_BATCH_TASK_COLUMNS = (
    "task_name", "instance_num", "job_name", "task_type", "status",
    "start_time", "end_time", "plan_cpu", "plan_mem",
)
_AB_INSTANCES, _AB_STATUS, _AB_START = 1, 4, 5
ALIBABA_CONTAINER_COLUMNS = (
    "container_id", "machine_id", "time_stamp", "app_du", "status",
    "cpu_request", "cpu_limit", "mem_size",
)
_AC_MACHINE, _AC_TIME = 1, 2


def _read_rows(path: Path, min_cols: int, time_col: int, what: str):
    """Headerless-CSV row iterator shared by the Alibaba tables: yields
    (line_number, row), tolerating a header row on hand-built shards
    (probed on the *time* column — the id columns are non-numeric in
    genuine rows too) and rejecting short rows loudly (a mis-delimited
    shard must not bin garbage)."""
    with open(path, newline="") as f:
        for ln, row in enumerate(csv.reader(f), 1):
            if not row:
                continue
            if ln == 1 and len(row) > time_col and row[time_col].strip() \
                    and not _is_number(row[time_col]):
                continue  # header row
            if len(row) < min_cols:
                raise ValueError(
                    f"{path}:{ln}: row has {len(row)} columns, need at "
                    f"least {min_cols} ({what} layout)")
            yield ln, row


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def load_alibaba_cluster_csv(batch_task_path: Union[str, Path], *,
                             container_path: Optional[Union[str, Path]]
                             = None,
                             interval: float = 300.0,
                             name: Optional[str] = None,
                             use_instances: bool = False,
                             num_intervals: Optional[int] = None,
                             num_racks: Optional[int] = None) -> Trace:
    """Read Alibaba cluster-trace-v2018 shards into a `Trace`.

    batch_task_path -- ``batch_task`` CSV: each row's ``start_time``
                       (seconds) is one arrival (or ``instance_num``
                       arrivals with ``use_instances=True``); rows whose
                       start_time is empty or 0 (tasks that never
                       started) are skipped
    container_path  -- optional ``container`` table: its ``machine_id``
                       column, binned by ``time_stamp`` onto the same
                       interval grid, yields per-rack arrival weights
                       (requires ``num_racks``; intervals with no
                       container events fall back to uniform)
    num_intervals   -- as in `load_google_cluster_csv`: pass explicitly
                       to keep trailing zero-arrival intervals

    The two tables are one recorded cluster: the horizon covers the last
    event of either, and events past a forced ``num_intervals`` horizon
    are rejected.
    """
    batch_task_path = Path(batch_task_path)
    if not batch_task_path.exists():
        raise FileNotFoundError(f"no trace file at {batch_task_path}")
    if interval <= 0:
        raise ValueError(f"interval must be > 0, got {interval}")
    if container_path is not None and num_racks is None:
        raise ValueError("container_path needs num_racks to derive "
                         "rack weights")
    times: list = []
    weights_n: list = []
    for ln, row in _read_rows(batch_task_path, _AB_START + 1, _AB_START,
                              "alibaba batch_task"):
        raw = row[_AB_START].strip()
        if raw in ("", "0"):
            continue  # task never started
        try:
            t = float(raw)
            n = int(float(row[_AB_INSTANCES])) if use_instances and \
                row[_AB_INSTANCES].strip() else 1
        except ValueError:
            raise ValueError(
                f"{batch_task_path}:{ln}: unparseable start_time/"
                f"instance_num {row[_AB_START]!r}/"
                f"{row[_AB_INSTANCES]!r}") from None
        if t < 0:
            raise ValueError(f"{batch_task_path}:{ln}: negative "
                             f"start_time {t}")
        times.append(t)
        weights_n.append(max(n, 1))
    if not times:
        raise ValueError(f"{batch_task_path}: no started batch tasks")
    times_arr = np.asarray(times, np.float64)
    counts_arr = np.asarray(weights_n, np.int64)

    c_times: list = []
    c_machines: list = []
    if container_path is not None:
        container_path = Path(container_path)
        if not container_path.exists():
            raise FileNotFoundError(f"no trace file at {container_path}")
        for ln, row in _read_rows(container_path, _AC_TIME + 1, _AC_TIME,
                                  "alibaba container"):
            raw = row[_AC_TIME].strip()
            if not raw:
                continue
            try:
                t = float(raw)
            except ValueError:
                raise ValueError(f"{container_path}:{ln}: unparseable "
                                 f"time_stamp {row[_AC_TIME]!r}") from None
            if t < 0:
                raise ValueError(f"{container_path}:{ln}: negative "
                                 f"time_stamp {t}")
            machine = row[_AC_MACHINE].strip()
            if machine:
                c_times.append(t)
                c_machines.append(machine)

    t_max = max([times_arr.max()] + (c_times or []))
    n = num_intervals if num_intervals is not None \
        else int(np.floor(t_max / interval)) + 1
    if n < 1:
        raise ValueError(f"num_intervals must be >= 1, got {n}")
    horizon = n * interval
    if t_max >= horizon:
        raise ValueError(f"{batch_task_path}: event at {t_max:.0f}s falls "
                         f"outside the {n} x {interval:.0f}s horizon")
    bins = np.minimum((times_arr / interval).astype(np.int64), n - 1)
    arrivals = np.zeros(n, np.float64)
    np.add.at(arrivals, bins, counts_arr.astype(np.float64))

    rack_weights = None
    if container_path is not None:
        if num_racks < 1:
            raise ValueError(f"num_racks must be >= 1, got {num_racks}")
        rack_weights = np.zeros((n, num_racks), np.float64)
        for t, machine in zip(c_times, c_machines):
            b = min(int(t / interval), n - 1)
            rack_weights[b, _rack_of_machine(machine, num_racks)] += 1.0
        empty = rack_weights.sum(axis=1) == 0
        rack_weights[empty] = 1.0  # uniform where placement is unknown
        rack_weights /= rack_weights.sum(axis=1, keepdims=True)

    return Trace(name=name or batch_task_path.stem,
                 interval=float(interval), arrivals=arrivals,
                 rack_weights=rack_weights)


def save_alibaba_cluster_csv(trace: Trace,
                             batch_task_path: Union[str, Path], *,
                             container_path: Optional[Union[str, Path]]
                             = None) -> Path:
    """Write a trace as Alibaba cluster-trace-v2018 shards: one
    ``batch_task`` row per counted arrival (``instance_num = 1``, evenly
    spaced inside its interval) and — when the trace carries
    `rack_weights` and a ``container_path`` is given — one container row
    per arrival whose machine_id is drawn from a per-rack pool
    (largest-remainder apportionment, mirroring the Google exporter), so
    ``load_alibaba_cluster_csv(..., container_path=..., num_racks=R)``
    recovers the annotation.  Deterministic; trailing zero-arrival
    intervals need ``num_intervals=`` at reload, as with Google.

    The single event that would land exactly on ``start_time == 0`` (the
    loader skips never-started tasks) is shifted to half its interval
    sub-step instead — still inside interval 0 at any interval length.
    """
    batch_task_path = Path(batch_task_path)
    if trace.rack_weights is not None and container_path is None:
        raise ValueError("trace carries rack_weights: pass container_path "
                         "to preserve them (or strip the weights)")
    num_racks = (None if trace.rack_weights is None
                 else int(trace.rack_weights.shape[1]))
    rows_c = []
    with open(batch_task_path, "w", newline="") as f:
        w = csv.writer(f)
        task = 0
        for i, count in enumerate(np.asarray(trace.arrivals)):
            count = int(round(float(count)))
            if count <= 0:
                continue
            t0 = i * trace.interval
            step = trace.interval / count
            if num_racks is None:
                racks = [None] * count
            else:
                weights = np.asarray(trace.rack_weights[i], np.float64)
                frac = weights / weights.sum() * count
                quota = np.floor(frac).astype(int)
                for j in np.argsort(-(frac - quota))[: count - quota.sum()]:
                    quota[j] += 1
                racks = [r for r, q in enumerate(quota) for _ in range(q)]
            for j in range(count):
                t = t0 + j * step
                if t <= 0.0:
                    t = 0.5 * step  # 0 would read back as never-started
                task += 1
                w.writerow([f"task_{task}", 1, f"j_{task}", 1, "Terminated",
                            f"{t:.6f}", f"{t + step:.6f}", 100, 0.5])
                if racks[j] is not None:
                    rows_c.append((f"c_{task}",
                                   _machine_in_rack(racks[j], num_racks),
                                   f"{t:.6f}", "du_1", "started",
                                   4, 4, 1.0))
    if container_path is not None:
        with open(container_path, "w", newline="") as f:
            w = csv.writer(f)
            for row in rows_c:
                w.writerow(row)
    return batch_task_path
