"""SLO-conditioned Balanced-PANDAS (``slo_pandas``), port of
`repro.core.slo_pandas`.

Balanced-PANDAS optimizes the MEAN workload; at rho = 0.99 the
mean-optimal policy is no longer the p99 winner.  This policy closes the
loop: it reads the telemetry recorder's running sojourn-p99 estimate
(`SimTelemetry.live_quantile`, delivered by the simulator as the
``signals`` of `slot_step`, one value a cell) and switches behaviour,
cell by cell, only while the estimate breaches ``slo_target``:

  * **routing** — the score gains a ``drain_bias * W_m`` penalty, added
    after ``W_m / rate - rate * 1e-6`` is formed, as the reference
    orders the float operations;
  * **scheduling** — idle servers serve their LONGEST queue (the first of
    equals) instead of their fastest nonempty tier.

Outside a breach — and whenever ``signals`` is absent (``telemetry=None``:
there is nothing to read) — every decision is the exact Balanced-PANDAS
program: same draws, same scores, same tie-breaks.  This is the
documented exception to the telemetry-purity invariant
(``uses_signals = True``).

Under an autoscaler the (N, M) ``server_mask`` restricts every lane's
candidates, in a breach or not, as in Balanced-PANDAS.

The breach flag is NaN-safe: the live p99 is NaN until a cell's first
completion is binned (NaN > target is False -> no breach) and inf once
the estimate passes the histogram range (inf > target -> breach).
"""

from __future__ import annotations

from repro_torch.core import balanced_pandas as bp
from repro_torch.core import locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy
from repro_torch.core.rng import DrawPlan


@register_policy
class SloPandasPolicy(SlotPolicy):
    """SLO-conditioned Balanced-PANDAS: while the in-scan sojourn-p99
    estimate breaches ``slo_target`` (slots), routing adds a
    ``drain_bias`` x workload penalty and idle servers drain their
    longest queue; otherwise — and always when telemetry is off — it IS
    Balanced-PANDAS, bitwise.  (The port's "in-scan" estimate is the
    dense slot loop's recorder, per cell.)"""

    name = "slo_pandas"
    supports_server_mask = True
    uses_signals = True

    def __init__(self, slo_target: float = 96.0, drain_bias: float = 0.25):
        if slo_target <= 0.0:
            raise ValueError(f"slo_target must be > 0, got {slo_target}")
        if drain_bias < 0.0:
            raise ValueError(f"drain_bias must be >= 0, got {drain_bias}")
        self.slo_target = float(slo_target)
        self.drain_bias = float(drain_bias)

    def draw_plan(self, num_servers: int) -> DrawPlan:
        return DrawPlan(route="servers")

    def init_state(self, topo: loc.Topology, device=None, batch=(),
                   **opts) -> bp.PandasState:
        return bp.init_state(topo, device, batch)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors,
                  server_mask=None, signals=None):
        if signals is None:
            # no telemetry -> nothing to condition on: the exact
            # Balanced-PANDAS program
            return bp.slot_step(s, draws, types, active, est, true_rates,
                                ancestors, server_mask=server_mask)
        breach = (signals["delay_p99"] > self.slo_target)[:, None]  # (N, 1)
        s = bp.route_lanes(s, draws, types, active, est, ancestors,
                           breach=breach, drain_bias=self.drain_bias,
                           server_mask=server_mask)
        return bp.serve_and_schedule(s, draws.u_serve, true_rates, breach)

    def num_in_system(self, s: bp.PandasState):
        return bp.num_in_system(s)

    def telemetry_gauges(self, s: bp.PandasState):
        return bp.telemetry_gauges(s)
