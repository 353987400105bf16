"""Discrete-time simulator entry point (port of `repro.core.simulator`).

`simulate` keeps the reference's signature and its ``fleet=`` engage
rule: configurations the fleet path supports run there when the topology
has at least `sharding.sim.FLEET_AUTO_THRESHOLD` servers (or when
``fleet=True``/a `FleetConfig` forces it).  This slice ports only the
fleet path: where the reference would take its dense `lax.scan`, and for
any non-default scenario/placement/replication/telemetry/control seam,
`simulate` raises `NotImplementedError` naming the slice that adds it.

Mean task completion time is measured via Little's law:
``W = mean(N_in_system over measurement window) / lambda_total`` (slots).

Error models for the estimated rates (`make_estimates`):
  - "uniform":    est = true * (1 +/- eps) for every tier (a no-op for
                  PANDAS decisions: the scale-invariance control arm);
  - "network":    the local rate exact, every other tier off by
                  (1 +/- eps) — mis-estimated network depreciation;
  - "per_server": each server's estimates carry iid multipliers in
                  [1-eps, 1] (sign<0) or [1, 1+eps] (sign>0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.core import locality as loc

_DENSE = ("the dense simulator path comes with the dense slice of the port "
          "(only the fleet path runs now)")
# non-default seams and the slice of the port that adds each
_SEAMS = (("scenario", (None, "static"), "workloads"),
          ("placement", (None, "uniform"), "placement"),
          ("replication", (None, "fixed"), "replication"),
          ("telemetry", (None, False), "telemetry"),
          ("control", (None,), "control"))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    topo: loc.Topology
    true_rates: loc.Rates
    p_hot: float = 0.5
    max_arrivals: int = 24
    horizon: int = 40_000
    warmup: int = 10_000

    def __post_init__(self):
        if not 0.0 <= self.p_hot <= 1.0:
            raise ValueError(f"p_hot must be in [0, 1], got {self.p_hot}")
        if self.max_arrivals < 1:
            raise ValueError(
                f"max_arrivals must be >= 1, got {self.max_arrivals}")
        if not 0 <= self.warmup < self.horizon:
            raise ValueError(f"need 0 <= warmup < horizon, got "
                             f"warmup={self.warmup} horizon={self.horizon}")
        if self.true_rates.num_tiers != self.topo.num_tiers:
            raise ValueError(
                f"true_rates have {self.true_rates.num_tiers} tiers but the "
                f"topology has {self.topo.num_tiers}")
        if self.topo.min_rack_size < loc.NUM_REPLICAS:
            raise ValueError(
                f"every rack needs >= {loc.NUM_REPLICAS} servers for "
                f"hot-rack types; smallest rack has "
                f"{self.topo.min_rack_size}")


def default_config(**kw) -> SimConfig:
    """Paper-scale default: 24 servers in 4 racks, hot-rack traffic."""
    return SimConfig(topo=loc.Topology(24, 6), true_rates=loc.Rates(), **kw)


def make_estimates(cfg: SimConfig, mode: str, eps: float, sign: int,
                   seed: int = 0) -> np.ndarray:
    """(M, K) float32 estimated rates for one error setting.
    sign: -1 lower, +1 higher."""
    m = cfg.topo.num_servers
    k = cfg.true_rates.num_tiers
    true_k = np.asarray(cfg.true_rates.values, np.float32)
    if mode == "uniform":
        mult = np.full((m, k), 1.0 + sign * eps, np.float32)
    elif mode == "network":
        mult = np.ones((m, k), np.float32)
        mult[:, 1:] = 1.0 + sign * eps
    elif mode == "per_server":
        rng = np.random.default_rng(seed)
        u = rng.uniform(0.0, eps, size=(m, k)).astype(np.float32)
        mult = 1.0 + sign * u
    else:
        raise ValueError(f"unknown error mode {mode!r}")
    est = true_k[None, :] * mult
    return np.clip(est, 1e-3, 1.0)


def _fleet_engaged(fleet, policy, cfg, scenario, placement, replication,
                   telemetry, control=None) -> bool:
    """The reference's ``fleet=`` rule.  ``False`` -> dense.  ``True`` / a
    FleetConfig -> fleet, raising if unsupported.  ``None`` -> fleet only
    when supported and the topology has >= FLEET_AUTO_THRESHOLD servers.
    A control plane always pins the dense path."""
    if control is not None:
        if fleet is True or (fleet is not None and fleet is not False):
            raise ValueError("fleet=True is not supported with control=; "
                             "the fleet step has no control-plane seam yet")
        return False
    if fleet is False:
        return False
    from repro_torch.sharding import sim as fleet_sim  # lazy: no cycle
    reason = fleet_sim.fleet_supported(policy, cfg, scenario, placement,
                                       replication, telemetry)
    if fleet is None:
        return (reason is None and cfg.topo.num_servers
                >= fleet_sim.FLEET_AUTO_THRESHOLD)
    if reason is not None:
        raise ValueError(f"fleet=True requested but unsupported: {reason}")
    return True


def simulate(policy, cfg: SimConfig, lam_total: float, est, seed: int = 0,
             scenario=None, placement=None, replication=None,
             telemetry=None, control=None, fleet=None, device=None,
             rng=None) -> Dict[str, Any]:
    """Single-configuration run; scalar metrics come back as floats.

    ``lam_total == 0`` yields ``mean_delay = NaN``; negative loads raise.
    ``device=None`` runs on the card (raising when there is none);
    ``rng`` overrides the default `core.rng.DeviceSource(seed, ...)`.
    """
    if lam_total < 0:
        raise ValueError(f"lam_total must be >= 0, got {lam_total}")
    given = dict(scenario=scenario, placement=placement,
                 replication=replication, telemetry=telemetry,
                 control=control)
    for arg, defaults, slice_name in _SEAMS:
        if given[arg] not in defaults:
            raise NotImplementedError(
                f"{arg}={given[arg]!r} comes with the {slice_name} slice of "
                f"the port")
    if not _fleet_engaged(fleet, policy, cfg, scenario, placement,
                          replication, telemetry, control):
        raise NotImplementedError(_DENSE)
    from repro_torch.sharding import sim as fleet_sim
    return fleet_sim.fleet_simulate(policy, cfg, lam_total, est, seed,
                                    fleet, device=device, rng=rng)
