"""Built-in scenarios, registered by name (loaded lazily by the registry).

Each builder returns a declarative `Scenario`; options are plain Python
numbers so any scenario is constructible from a config string or CLI flag.
Arrival-modulating builders keep the time-average ``lam_mult`` at 1.0 (the
MMPP normalizes itself), so a load expressed as a fraction of the static
fluid capacity offers the same long-run traffic under every scenario — the
delay differences between scenarios then measure burstiness and drift, not
a hidden change of load.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.workloads.scenario import Scenario, Segment, register_scenario


@register_scenario("static")
def static() -> Scenario:
    """The identity scenario: every knob multiplied by 1.0 for the whole
    run.  Compiled and played back, it reproduces the pre-scenario sample
    paths bitwise (common random numbers preserved)."""
    return Scenario("static", (Segment(start=0.0),))


@register_scenario("diurnal")
def diurnal(amplitude: float = 0.35, cycles: float = 1.0,
            segments: int = 24) -> Scenario:
    """Sinusoidal day/night load: lam_mult = 1 + amplitude*sin(2*pi*cycles*u),
    discretized to `segments` piecewise-constant spans (mean exactly ~1 by
    symmetry of the midpoint rule over whole cycles)."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    if segments < 2:
        raise ValueError(f"need >= 2 segments, got {segments}")
    mults = [1.0 + amplitude * math.sin(2.0 * math.pi * cycles
                                        * (i + 0.5) / segments)
             for i in range(segments)]
    # Explicit unit-mean normalization: for whole cycles the midpoint mean
    # is ~1 already, but fractional `cycles` would otherwise smuggle extra
    # offered load into the comparison.
    mean = sum(mults) / segments
    segs = tuple(Segment(start=i / segments, lam_mult=m / mean)
                 for i, m in enumerate(mults))
    return Scenario("diurnal", segs)


@register_scenario("flash_crowd")
def flash_crowd(peak: float = 1.8, start: float = 0.45,
                width: float = 0.15) -> Scenario:
    """A sudden arrival surge: lam_mult jumps to `peak` during
    [start, start+width), compensated to keep the time-average at 1.0 so
    the long-run offered load matches the static scenario."""
    if peak <= 1.0:
        raise ValueError(f"peak must be > 1, got {peak}")
    if not 0.0 < start < start + width < 1.0:
        raise ValueError(f"surge window [{start}, {start + width}) must sit "
                         f"strictly inside (0, 1)")
    # base * (1 - width) + peak * base * width == 1
    base = 1.0 / (1.0 - width + peak * width)
    return Scenario("flash_crowd", (
        Segment(start=0.0, lam_mult=base),
        Segment(start=start, lam_mult=peak * base),
        Segment(start=start + width, lam_mult=base),
    ))


@register_scenario("mmpp")
def mmpp(lam_lo: float = 0.6, lam_hi: float = 1.6,
         mean_dwell: float = 0.08, seed: int = 0,
         max_segments: int = 48) -> Scenario:
    """2-state Markov-modulated Poisson arrivals: the rate multiplier
    alternates between `lam_lo` and `lam_hi` with exponential dwell times
    (mean `mean_dwell` of the run), sampled deterministically from `seed`
    and normalized to unit time-average."""
    if not 0.0 < lam_lo < lam_hi:
        # lam_lo == 0 (interrupted Poisson) would divide by zero in the
        # unit-mean normalization whenever the sampled path never leaves
        # the low state; approximate it with a small positive rate instead.
        raise ValueError(f"need 0 < lam_lo < lam_hi, got {lam_lo}, {lam_hi}")
    if mean_dwell <= 0.0:
        raise ValueError(f"mean_dwell must be > 0, got {mean_dwell}")
    rng = np.random.default_rng(seed)
    starts, mults = [0.0], [lam_lo]
    t = float(rng.exponential(mean_dwell))
    while t < 1.0 and len(starts) < max_segments:
        starts.append(t)
        mults.append(lam_hi if mults[-1] == lam_lo else lam_lo)
        t += float(rng.exponential(mean_dwell))
    spans = np.diff(np.array(starts + [1.0]))
    mean = float(np.dot(spans, np.array(mults)))
    segs = tuple(Segment(start=s, lam_mult=m / mean)
                 for s, m in zip(starts, mults))
    return Scenario("mmpp", segs)


@register_scenario("hot_shift")
def hot_shift(phases: int = 4, p_hot: Optional[float] = None) -> Scenario:
    """Hotspot migration: the hot rack advances one rack per phase (rack ids
    wrap mod num_racks at compile time), optionally overriding the hot
    fraction — the locality-drift case the affinity-scheduling line
    stresses (a scheduler warmed on rack 0 must follow the hotspot)."""
    if phases < 2:
        raise ValueError(f"need >= 2 phases, got {phases}")
    segs = tuple(Segment(start=k / phases, hot_rack=k, p_hot=p_hot)
                 for k in range(phases))
    return Scenario("hot_shift", segs)


@register_scenario("stragglers")
def stragglers(servers: Sequence[int] = (0, 1), factor: float = 0.25,
               start: float = 0.25, width: float = 0.5) -> Scenario:
    """Per-server straggler window: `servers` run at `factor` x their true
    rates (all tiers) during [start, start+width) — thermal throttling or a
    noisy neighbor.  Rate estimates that froze before the window are wrong
    inside it; the blind EWMA estimator re-learns."""
    if not 0.0 < factor < 1.0:
        raise ValueError(f"factor must be in (0, 1), got {factor}")
    if not 0.0 < start < start + width < 1.0:
        raise ValueError(f"straggler window [{start}, {start + width}) must "
                         f"sit strictly inside (0, 1)")
    slow = {int(s): factor for s in servers}
    return Scenario("stragglers", (
        Segment(start=0.0),
        Segment(start=start, slow_servers=slow),
        Segment(start=start + width),
    ))


@register_scenario("server_loss")
def server_loss(servers: Sequence[int] = (0, 1), start: float = 0.35,
                width: float = 0.3) -> Scenario:
    """Server failure window: `servers` are DEAD (zero service rate, all
    hosted replicas wiped) during [start, start+width) and rejoin empty
    afterwards — the availability / data-loss event the paper's 3x
    replication exists to survive.  A replication controller must re-create
    the lost replicas from the survivors, paying migration bandwidth."""
    if not servers:
        raise ValueError("server_loss needs at least one server id")
    if not 0.0 < start < start + width < 1.0:
        raise ValueError(f"failure window [{start}, {start + width}) must "
                         f"sit strictly inside (0, 1)")
    down = tuple(int(s) for s in servers)
    return Scenario("server_loss", (
        Segment(start=0.0),
        Segment(start=start, down_servers=down),
        Segment(start=start + width),
    ))


@register_scenario("rack_loss")
def rack_loss(racks: Sequence[int] = (0,), start: float = 0.35,
              width: float = 0.25) -> Scenario:
    """Rack failure window: every server in `racks` is DEAD (replicas
    wiped) during [start, start+width) — the correlated-failure case that
    motivates spreading replicas across racks.  Rack ids wrap mod the rack
    count and resolve through the consumer's rack_of map at compile time."""
    if not racks:
        raise ValueError("rack_loss needs at least one rack id")
    if not 0.0 < start < start + width < 1.0:
        raise ValueError(f"failure window [{start}, {start + width}) must "
                         f"sit strictly inside (0, 1)")
    down = tuple(int(r) for r in racks)
    return Scenario("rack_loss", (
        Segment(start=0.0),
        Segment(start=start, down_racks=down),
        Segment(start=start + width),
    ))


@register_scenario("rack_congestion")
def rack_congestion(beta_mult: float = 0.6, gamma_mult: float = 0.5,
                    start: float = 0.4, width: float = 0.4) -> Scenario:
    """Network fault: rack-switch / DCN congestion sags the TRUE rack-local
    and remote rates (beta, gamma) during [start, start+width) while local
    service (alpha) is unaffected — exactly the "network" error mode of the
    robustness study, but injected into reality instead of the estimate."""
    if not (0.0 < beta_mult <= 1.0 and 0.0 < gamma_mult <= 1.0):
        raise ValueError(f"tier multipliers must be in (0, 1], got "
                         f"{beta_mult}, {gamma_mult}")
    if not 0.0 < start < start + width < 1.0:
        raise ValueError(f"congestion window [{start}, {start + width}) must "
                         f"sit strictly inside (0, 1)")
    return Scenario("rack_congestion", (
        Segment(start=0.0),
        Segment(start=start, tier_mult=(1.0, beta_mult, gamma_mult)),
        Segment(start=start + width),
    ))
