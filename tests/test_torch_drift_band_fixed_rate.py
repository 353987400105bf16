"""The port's drift study against the JAX reference's under static and
rack_congestion (whose rack weights and tier rates move, not the
arrival rate): each arm's mean delay within the band that
tests/test_torch_drift_band.py states, with the port's own draws.
"""

import pytest

from _torch_port import single_torch_thread  # noqa: F401
from test_torch_drift_band import check_scenario


@pytest.mark.parametrize("scenario", ["static", "rack_congestion"])
def test_drift_scenario_within_band_of_reference(scenario):
    check_scenario(scenario)
