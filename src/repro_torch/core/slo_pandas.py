"""SLO-conditioned Balanced-PANDAS (``slo_pandas``), port of
`repro.core.slo_pandas` (its signal-free program).

The reference reads the in-scan telemetry recorder's running sojourn-p99
estimate (the ``signals`` of its `slot_step`) and, while it breaches
``slo_target``, adds a ``drain_bias`` x workload penalty to routing and
lets idle servers drain their longest queue.  Without signals there is
nothing to condition on, and the policy is the exact Balanced-PANDAS
program, bit for bit: same draws, same scores, same tie-breaks.  That is
all that runs without telemetry, in the reference too, and all this
port runs: the simulator refuses ``telemetry=``, and a `slot_step` given
signals raises until the telemetry slice brings the breach branch.
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
    dense slot loop's; its breach branch comes with the telemetry
    slice.)"""

    name = "slo_pandas"

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
                  signals=None):
        if signals is not None:
            raise NotImplementedError(
                "slo_pandas's breach branch reads the live p99 of the "
                "telemetry recorder; it comes with the telemetry slice of "
                "the port")
        return bp.slot_step(s, draws, types, active, est, true_rates,
                            ancestors)

    def num_in_system(self, s: bp.PandasState):
        return bp.num_in_system(s)
