"""The port's drift study run as its CLI runs it: ``main(["--smoke"])``
on the CPU, at the reference script's smoke size (`smoke_study()`:
Topology(12, 4), horizon 1500 / 400, seed 0, `stragglers` and
`rack_congestion`), through its flag parsing, its stability gate and its
OK line.  `test_torch_examples.py` holds the other smokes at cut
horizons."""

import numpy as np
import torch

from repro_torch.core import robustness as rb
from repro_torch.examples import drift_study, smoke_study
from _torch_port import single_torch_thread  # noqa: F401


def test_drift_study_smoke_main(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    seen = []
    study_fn = rb.drift_study

    def recorded(cfg, scenarios, device=None):
        seen.append((cfg, tuple(scenarios), device))
        return study_fn(cfg, scenarios=scenarios, device=device)

    monkeypatch.setattr(rb, "drift_study", recorded)
    study = drift_study.main(["--smoke"], device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("scenario smoke OK")
    assert seen == [(smoke_study(), drift_study.SMOKE_SCENARIOS,
                     torch.device("cpu"))]
    assert study["scenarios"] == drift_study.SMOKE_SCENARIOS
    for scen in drift_study.SMOKE_SCENARIOS:
        for arm, delay in study["delay"][scen].items():
            assert np.isfinite(delay).all(), (scen, arm)
    assert not any(tmp_path.iterdir())   # a smoke writes no CSV
