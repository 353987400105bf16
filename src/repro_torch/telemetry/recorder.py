"""Histogram quantiles (counterpart of `repro.telemetry.recorder`; the
numpy `percentiles_from_hist`, copied)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def percentiles_from_hist(counts: np.ndarray, bin_width: float,
                          qs: Sequence[float]) -> np.ndarray:
    """Numpy mirror of the in-graph quantile: upper bin edge per q."""
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
