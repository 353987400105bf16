"""The open-loop admission pairs of tests/test_torch_control_pairs.py's
`ARMS` (open loop at ``extra_mult`` 0.8 and 1.7 with the token bucket,
the deferring bucket and the queue threshold on Balanced-PANDAS, open
loop with the autoscaler under a ``lam_mult`` track, and the popularity
replication controller under a deferring bucket), against the JAX
reference's, slot by slot (`check_pair`).
"""

import pytest

from _torch_port import single_torch_thread  # noqa: F401
from test_torch_control_pairs import arms, check_pair


@pytest.mark.parametrize(
    "name,control,rho,telemetry,scenario,replication", arms("open"))
def test_pair_equals_reference_after_every_slot(monkeypatch, name, control,
                                                rho, telemetry, scenario,
                                                replication):
    check_pair(monkeypatch, name, control, rho, telemetry, scenario,
               replication)
