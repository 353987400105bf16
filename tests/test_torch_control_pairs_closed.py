"""The closed-loop admission pairs of tests/test_torch_control_pairs.py's
`ARMS` (closed loop, static and under a ``users_mult`` track, with the
token bucket, the deferring bucket and the queue threshold on
Balanced-PANDAS, and the popularity replication controller under closed
loop with the threshold), against the JAX reference's, slot by slot
(`check_pair`).
"""

import pytest

from _torch_port import single_torch_thread  # noqa: F401
from test_torch_control_pairs import arms, check_pair


@pytest.mark.parametrize(
    "name,control,rho,telemetry,scenario,replication", arms("closed"))
def test_pair_equals_reference_after_every_slot(monkeypatch, name, control,
                                                rho, telemetry, scenario,
                                                replication):
    check_pair(monkeypatch, name, control, rho, telemetry, scenario,
               replication)
