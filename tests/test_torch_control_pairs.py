"""Every pair of a load generator and a controller in the port's dense
simulator, against the JAX reference's, slot by slot.

`ARMS` lists every pair.  This file runs the autoscaler's; the
admission pairs (and the autoscaler under a ``lam_mult`` track) run in
tests/test_torch_control_pairs_open.py and
tests/test_torch_control_pairs_closed.py (three files, so that each runs
on a worker of its own and stays under a minute: the reference's
compile, about 3 s an arm, is most of an arm's time).

Each arm runs `_torch_port.replay_control`: under the reference's replayed
draws the port's `CtlState` and policy state equal the reference's after
every slot, and its final metrics the reference's `simulate`.  The load
generators (open loop at ``extra_mult`` 0.8 and 1.7, closed loop, closed
loop under a ``users_mult`` track) cross the token bucket with and
without defer, the queue threshold and the autoscaler on
Balanced-PANDAS; the autoscaler pairs run again on SLO-PANDAS with
telemetry, and open loop's under a ``lam_mult`` track.  The popularity
replication controller, whose threshold (`replication.controllers.
quantile_linear`, the reference's compiled quantile) reads the decayed
counts of the chunks the admitted lanes read, runs under a deferring
bucket and under closed loop with the threshold.

Where a loadgen meets the autoscaler, the reference's compiled step
folds the loadgen's constant factor, the headroom and ``1 / rate0`` into
one float32 constant (tools/xla_control_fold.py,
`HeadroomAutoscale.sim_scale`); the four closed-loop autoscaler arms
fail on a port that multiplies twice, ``(thinking * (1 / think_time)) *
(headroom / rate0)``, as the parent of the fold's repair did (first at
slot 13).  Each arm's load makes it do what it is for (`check_pair`): a
bucket or a threshold sheds, a deferring bucket holds a backlog, an
autoscaler's ``ctl_active_min`` falls under the fleet size, the
popularity controller moves replicas.  rho is the configured rate over
the capacity, before ``extra_mult``; closed loop ignores it.
"""

import pytest

from _torch_port import (CTL_BUCKET, CTL_CLOSED, CTL_DEFER, CTL_SERVERS,
                         replay_control, users_wave)
from _torch_port import single_torch_thread  # noqa: F401

THRESHOLD = {"name": "queue_threshold", "options": {"threshold": 13}}
OPEN_08 = {"name": "open_loop", "options": {"extra_mult": 0.8}}
OPEN_17 = {"name": "open_loop", "options": {"extra_mult": 1.7}}


def _lam_track(pkg):
    """An open-loop rate that rises, then falls below its start."""
    return pkg.Scenario("lam_track", (
        pkg.Segment(0.0), pkg.Segment(0.3, lam_mult=1.45),
        pkg.Segment(0.65, lam_mult=0.6)))


def _pairs(prefix, group, loadgen, rhos, scenario=None):
    """One loadgen's arms (group, id, policy, [loadgen, controller], rho,
    telemetry, scenario, replication) with each controller on
    Balanced-PANDAS, `rhos` the load of the admission arms and of the
    autoscaler arms; the autoscaler pair again on SLO-PANDAS with
    telemetry."""
    shed, scale = rhos
    return [
        (group, f"{prefix}+bucket", "balanced_pandas", [loadgen, CTL_BUCKET],
         shed, None, scenario, None),
        (group, f"{prefix}+defer", "balanced_pandas", [loadgen, CTL_DEFER],
         shed, None, scenario, None),
        (group, f"{prefix}+threshold", "balanced_pandas",
         [loadgen, THRESHOLD], shed, None, scenario, None),
        ("autoscale", f"{prefix}+autoscale", "balanced_pandas",
         [loadgen, "autoscale"], scale, None, scenario, None),
        ("autoscale", f"slo-{prefix}+autoscale", "slo_pandas",
         [loadgen, "autoscale"], scale, True, scenario, None),
    ]


ARMS = (_pairs("open0.8", "open", OPEN_08, (1.4, 0.9))
        + _pairs("open1.7", "open", OPEN_17, (0.7, 0.4))
        + _pairs("closed", "closed", CTL_CLOSED, (1.0, 1.0))
        + _pairs("closed_wave", "closed", CTL_CLOSED, (1.0, 1.0),
                 users_wave)
        + [("open", "open1.7+autoscale-lam_track", "balanced_pandas",
            [OPEN_17, "autoscale"], 0.4, None, _lam_track, None),
           ("open", "defer+popularity", "balanced_pandas", [CTL_DEFER], 1.3,
            None, None, "popularity"),
           ("closed", "closed+threshold+popularity", "balanced_pandas",
            [CTL_CLOSED, THRESHOLD], 1.0, None, None, "popularity")])


def arms(group):
    """`pytest.param`s of the arms of one group, named by their pair."""
    return [pytest.param(*a[2:], id=a[1]) for a in ARMS if a[0] == group]


def check_pair(monkeypatch, name, control, rho, telemetry, scenario,
               replication):
    """`replay_control`, then the arm did what it is for (its last
    controller, and the replication controller)."""
    want, states = replay_control(monkeypatch, name, control, rho,
                                  telemetry, scenario, replication)
    if control[-1] == "autoscale":
        assert want["ctl_active_min"] < CTL_SERVERS
    elif control[-1] is CTL_DEFER:
        assert max(st.backlog for st in states) > 0.0
    else:
        assert want["ctl_shed"] > 0
    if replication is not None:
        assert want["repair_moves"] > 0


@pytest.mark.parametrize(
    "name,control,rho,telemetry,scenario,replication", arms("autoscale"))
def test_pair_equals_reference_after_every_slot(monkeypatch, name, control,
                                                rho, telemetry, scenario,
                                                replication):
    check_pair(monkeypatch, name, control, rho, telemetry, scenario,
               replication)
