"""In-loop telemetry recorders (counterpart of `repro.telemetry.recorder`).

The simulator's metrics are end-of-run means, but the paper's
heavy-traffic claims are statements about *distributions*, of task delay
and of queue length.  This module records both inside the dense slot
loop without breaking any of its invariants:

  * every buffer is fixed-shape with a leading cell dimension N, one row
    per (load, error, seed) cell, so `sweep()` runs the whole grid as one
    batch as it does without telemetry;
  * recording consumes NO random draws and reads no device value on the
    host, so enabling telemetry cannot perturb a sample path (pure
    observation) nor stall the loop;
  * with ``telemetry=None`` the simulator builds none of this.

Sojourn times without per-task identity: every policy stores anonymous
queue *counts*, so the recorder pairs the i-th admitted task with the
i-th completion, a FIFO coupling over a ring buffer of arrival slots.
The histogram MEAN is pairing-invariant, so it matches the simulator's
Little's-law `mean_delay`; quantiles are reported under the FIFO
coupling, which is exact for FIFO and the standard virtual-delay proxy
for the others.  Admissions are inferred from the policy state itself
(``n_after - n_before + completions``), so FIFO's dropped arrivals never
enter the ring.

Percentile estimates come from a fixed-bin histogram: the reported
quantile is the UPPER EDGE of the bin containing it, so the estimate
exceeds the exact order statistic by at most one bin width
(``hist_max / hist_bins`` slots).  Sojourns beyond ``hist_max`` land in
an overflow bin; a quantile falling there reports ``inf``.

Every cell's recorder state equals the reference's per-configuration
state exactly: the same int32 counters, the same float32 products with
the reciprocals of the bin widths, the same first-bin argmax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Recorder shapes (all fixed: they size the carry's buffers).

    stride        -- time-series downsample stride in slots (1 = dense)
    hist_bins     -- sojourn-histogram regular bins (+1 overflow bin)
    hist_max      -- sojourn (slots) where the overflow bin starts
    qhist_bins    -- queue-length-histogram regular bins (+1 overflow)
    qhist_max     -- queue length where the overflow bin starts
    ring_capacity -- FIFO arrival-slot ring size; admissions beyond a
                     full ring are dropped from pairing (and counted in
                     ``telemetry_dropped`` — no silent truncation)

    The defaults give a sojourn bin width of exactly 1 slot; sojourns are
    integer slot counts, so up to ``hist_max`` the percentile estimate is
    the exact order statistic plus one bin width.
    """

    stride: int = 16
    hist_bins: int = 256
    hist_max: float = 256.0
    qhist_bins: int = 128
    qhist_max: float = 512.0
    ring_capacity: int = 4096

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.hist_bins < 1 or self.qhist_bins < 1:
            raise ValueError("hist_bins/qhist_bins must be >= 1")
        if self.hist_max <= 0 or self.qhist_max <= 0:
            raise ValueError("hist_max/qhist_max must be > 0")
        if self.ring_capacity < 1:
            raise ValueError(
                f"ring_capacity must be >= 1, got {self.ring_capacity}")

    @property
    def bin_width(self) -> float:
        """Sojourn-histogram bin width (slots) == the percentile error
        bound."""
        return float(self.hist_max) / self.hist_bins

    @property
    def qbin_width(self) -> float:
        return float(self.qhist_max) / self.qhist_bins


TelemetryLike = Union[None, bool, TelemetryConfig]

#: metric keys `SimTelemetry.metrics` adds to the simulator output dict
TELEMETRY_METRIC_KEYS = (
    "delay_p50", "delay_p95", "delay_p99", "delay_hist", "delay_overflow_frac",
    "queue_len_hist", "series", "telemetry_dropped", "telemetry_unmatched",
)

#: overflow fraction past which the summary warns (sojourn tails beyond
#: ``hist_max`` clamp any quantile landing there to inf)
OVERFLOW_WARN_FRAC = 0.01


def as_telemetry_config(spec: TelemetryLike) -> TelemetryConfig:
    """None/False -> disabled is handled by the caller; True -> defaults."""
    if spec is True:
        return TelemetryConfig()
    if isinstance(spec, TelemetryConfig):
        return spec
    raise TypeError(f"telemetry must be None, True, or a TelemetryConfig; "
                    f"got {spec!r}")


class TelState(NamedTuple):
    """Recorder state threaded through the dense carry, per cell."""

    ring: torch.Tensor        # (N, R) int32 arrival slots, FIFO order
    head: torch.Tensor        # (N,) int32 index of the oldest entry
    count: torch.Tensor       # (N,) int32 entries in the ring
    delay_hist: torch.Tensor  # (N, H+1) int32 sojourn counts (+overflow)
    qlen_hist: torch.Tensor   # (N, Q+1) int32 queue-length counts (+overflow)
    series: torch.Tensor      # (N, T_s, n_tracks) f32 downsampled samples
    dropped: torch.Tensor     # (N,) int32 admissions not ringed (ring full)
    unmatched: torch.Tensor   # (N,) int32 in-window completions not binned


class SimTelemetry:
    """The recorder of one (config, horizon, policy-track) tuple, for N
    cells on `device`."""

    BASE_TRACKS: Tuple[str, ...] = ("n_in_system", "admitted", "completions")

    def __init__(self, cfg: TelemetryConfig, horizon: int, warmup: int,
                 num_servers: int, max_arrivals: int,
                 extra_tracks: Sequence[str] = (), device=None):
        need = max(int(max_arrivals), int(num_servers))
        if cfg.ring_capacity < need:
            raise ValueError(
                f"ring_capacity ({cfg.ring_capacity}) must be >= "
                f"max(max_arrivals, num_servers) = {need} so one slot's "
                f"pushes/pops hit distinct ring indices")
        extra = tuple(extra_tracks)
        clash = set(extra) & set(self.BASE_TRACKS)
        if clash:
            raise ValueError(f"telemetry track names collide with the "
                             f"base tracks: {sorted(clash)}")
        if len(set(extra)) != len(extra):
            raise ValueError(f"duplicate telemetry track names: {extra}")
        self.cfg = cfg
        self.horizon = int(horizon)
        self.warmup = int(warmup)
        self.max_arrivals = int(max_arrivals)
        self.num_servers = int(num_servers)
        self.extra_tracks = extra
        self.track_names: Tuple[str, ...] = self.BASE_TRACKS + extra
        self.n_samples = -(-self.horizon // cfg.stride)  # ceil division
        self.device = torch.device("cpu" if device is None else device)
        # The reference's compiled division by a bin width is a product
        # with the float32 reciprocal of the float32 width (XLA's form;
        # `tools/telemetry_bin_division.py`): the same here, on the CPU
        # and the card alike.
        self._inv_width = _f32_reciprocal(cfg.bin_width)
        self._inv_qwidth = _f32_reciprocal(cfg.qbin_width)
        # the push and pop lanes, made once (no per-slot arange)
        self._lane = torch.arange(self.max_arrivals, dtype=torch.int32,
                                  device=self.device)
        self._lane_m = torch.arange(self.num_servers, dtype=torch.int32,
                                    device=self.device)

    # -- loop side ----------------------------------------------------------
    def init(self, n_cells: int = 1) -> TelState:
        c = self.cfg
        i32 = dict(dtype=torch.int32, device=self.device)
        n = (int(n_cells),)
        return TelState(
            ring=torch.zeros(n + (c.ring_capacity,), **i32),
            head=torch.zeros(n, **i32),
            count=torch.zeros(n, **i32),
            delay_hist=torch.zeros(n + (c.hist_bins + 1,), **i32),
            qlen_hist=torch.zeros(n + (c.qhist_bins + 1,), **i32),
            series=torch.zeros(n + (self.n_samples, len(self.track_names)),
                               dtype=torch.float32, device=self.device),
            dropped=torch.zeros(n, **i32),
            unmatched=torch.zeros(n, **i32),
        )

    def record(self, st: TelState, t: int, admitted: torch.Tensor,
               completions: torch.Tensor, n_now: torch.Tensor,
               extras: Dict[str, torch.Tensor]) -> TelState:
        """One slot of observation.  `admitted`/`completions`/`n_now` are
        (N,) integers for slot `t`, a Python int (admissions pushed
        before completions are popped, matching the simulator's
        arrivals-then-service phase order: a task admitted and completed
        in the same slot has sojourn 0).  `extras` must carry exactly the
        extra tracks this recorder was built with, each (N,)."""
        if set(extras) != set(self.extra_tracks):
            raise ValueError(
                f"telemetry extras {sorted(extras)} do not match the "
                f"recorder's tracks {sorted(self.extra_tracks)}")
        i32, f32 = torch.int32, torch.float32
        c = self.cfg
        cap = c.ring_capacity
        in_w = t >= self.warmup
        a = torch.clamp(admitted.to(i32), 0, self.max_arrivals)
        compl = torch.clamp(completions.to(i32), 0, self.num_servers)

        # push admissions (FIFO tail), dropping what the ring cannot hold;
        # the lanes' indices are distinct (cap >= max_arrivals)
        pushes = torch.minimum(a, cap - st.count)
        idx = ((st.head + st.count)[:, None] + self._lane) % cap
        idx = idx.long()
        put = self._lane < pushes[:, None]
        ring = st.ring.scatter(-1, idx, torch.where(
            put, t, torch.gather(st.ring, -1, idx)))
        count = st.count + pushes
        dropped = st.dropped + (a - pushes)

        # pop completions (FIFO head) and bin their sojourns
        pops = torch.minimum(compl, count)
        head = st.head
        delay_hist, unmatched = st.delay_hist, st.unmatched
        if in_w:  # out of the window nothing is binned or counted
            idx_m = ((head[:, None] + self._lane_m) % cap).long()
            take = self._lane_m < pops[:, None]
            soj = (t - torch.gather(ring, -1, idx_m)).to(f32)
            bins = torch.clamp((soj * self._inv_width).to(i32), 0,
                               c.hist_bins)
            delay_hist = delay_hist.scatter_add(-1, bins.long(),
                                                take.to(i32))
            unmatched = unmatched + (compl - pops)
        head = (head + pops) % cap
        count = count - pops

        # queue-length distribution over the measurement window
        qlen_hist = st.qlen_hist
        if in_w:
            qbin = torch.clamp((n_now.to(f32) * self._inv_qwidth).to(i32),
                               0, c.qhist_bins)
            qlen_hist = qlen_hist.scatter_add(
                -1, qbin.long()[:, None],
                torch.ones_like(qbin)[:, None])

        # downsampled point samples: slot t lands at row t // stride
        series = st.series
        if t % c.stride == 0:
            vals = [n_now.to(f32), a.to(f32), compl.to(f32)]
            vals += [extras[k].to(f32) for k in self.extra_tracks]
            series = series.clone()
            series[:, t // c.stride] = torch.stack(vals, dim=-1)

        return TelState(ring=ring, head=head, count=count,
                        delay_hist=delay_hist, qlen_hist=qlen_hist,
                        series=series, dropped=dropped, unmatched=unmatched)

    def metrics(self, st: TelState) -> Dict[str, torch.Tensor]:
        """End-of-run telemetry metrics per cell."""
        hist = st.delay_hist.to(torch.float32)
        w = self.cfg.bin_width
        return {
            "delay_p50": _hist_quantile(hist, w, 0.50),
            "delay_p95": _hist_quantile(hist, w, 0.95),
            "delay_p99": _hist_quantile(hist, w, 0.99),
            "delay_hist": hist,
            "delay_overflow_frac": hist[:, -1] / torch.clamp(
                hist.sum(dim=-1), min=1.0),
            "queue_len_hist": st.qlen_hist.to(torch.float32),
            "series": st.series,
            "telemetry_dropped": st.dropped.to(torch.float32),
            "telemetry_unmatched": st.unmatched.to(torch.float32),
        }

    def live_quantile(self, st: TelState, q: float) -> torch.Tensor:
        """(N,) running sojourn quantile over everything binned SO FAR —
        the signal SLO-conditioned policies read mid-run.  NaN until the
        cell's first completion is binned (comparisons are False -> no
        breach) and inf while the quantile sits in the overflow bin (any
        finite target reads as breached)."""
        return _hist_quantile(st.delay_hist.to(torch.float32),
                              self.cfg.bin_width, q)


def _f32_reciprocal(width: float) -> float:
    """1 / width in float32, of the float32 width: exact as a Python
    float, so a product with it is one float32 multiply."""
    return float(np.float32(1.0) / np.float32(width))


def _hist_quantile(hist: torch.Tensor, width: float, q: float
                   ) -> torch.Tensor:
    """Upper edge of the bin holding quantile `q`, per row of the
    (..., H+1) float32 `hist` (NaN on an empty row, inf when it falls in
    the overflow bin).  ``q * total`` is a float32 product and the first
    bin reaching it wins, as in the reference."""
    c = torch.cumsum(hist, dim=-1)
    total = c[..., -1]
    idx = torch.argmax((c >= (q * total)[..., None]).to(torch.int32),
                       dim=-1)
    val = (idx.to(torch.float32) + 1.0) * width
    val = torch.where(idx >= hist.shape[-1] - 1,
                      torch.full_like(val, float("inf")), val)
    return torch.where(total > 0, val, torch.full_like(val, float("nan")))


# -- host-side helpers (numpy; used by tests, the engine and the studies) --

def percentiles_from_hist(counts: np.ndarray, bin_width: float,
                          qs: Sequence[float]) -> np.ndarray:
    """Numpy mirror of the in-loop quantile: upper bin edge per q."""
    counts = np.asarray(counts, np.float64)
    c = np.cumsum(counts)
    total = c[-1]
    out = np.empty(len(qs))
    for i, q in enumerate(qs):
        if total <= 0:
            out[i] = np.nan
            continue
        idx = int(np.argmax(c >= q * total))
        out[i] = np.inf if idx >= len(counts) - 1 else (idx + 1) * bin_width
    return out


def maybe_warn_overflow(overflow_frac: float, cfg: TelemetryConfig) -> bool:
    """Warn (stdlib `warnings`) when more than `OVERFLOW_WARN_FRAC` of the
    binned sojourns landed in the overflow bin — at that point any
    quantile >= 1 - overflow_frac reports inf rather than a number, and
    the histogram mean is silently clamped.  Suggests a 4x ``hist_max``
    (same bin count: 4x coarser bins, still a documented error bound).
    Returns whether it warned, so callers and tests can assert on it."""
    frac = float(overflow_frac)
    if not np.isfinite(frac) or frac <= OVERFLOW_WARN_FRAC:
        return False
    import warnings
    warnings.warn(
        f"{100.0 * frac:.1f}% of recorded sojourns exceeded "
        f"hist_max={cfg.hist_max:g} (overflow bin); percentiles at or above "
        f"q={1.0 - frac:.3f} report inf. Rerun with a larger histogram "
        f"range, e.g. TelemetryConfig(hist_max={4.0 * cfg.hist_max:g}, "
        f"hist_bins={cfg.hist_bins}).",
        RuntimeWarning, stacklevel=2)
    return True


def fcfs_sojourns(admitted: np.ndarray,
                  completions: np.ndarray) -> np.ndarray:
    """Exact sojourns under the same FIFO coupling the in-loop recorder
    uses, reconstructed from DENSE (stride=1) per-slot admission and
    completion counts: the i-th admission pairs with the i-th completion.
    Unpaired admissions (still in system at the end) are censored."""
    a = np.asarray(admitted).astype(np.int64)
    c = np.asarray(completions).astype(np.int64)
    arr = np.repeat(np.arange(len(a)), a)
    dep = np.repeat(np.arange(len(c)), c)
    n = min(len(arr), len(dep))
    return (dep[:n] - arr[:n]).astype(np.int64)
