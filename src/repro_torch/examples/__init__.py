"""The reference's example scripts on the port: the paper's figures and their
headline claims (`figures`, the counterpart of `benchmarks/figures.py`),
the quickstart, the six studies, trace replay (`replay` holds the two
functions of `benchmarks/bench_serving.py` it needs), `serve_cluster`
and the two training examples, each the counterpart of the
`examples/` script of its name.

Each runs as ``python -m repro_torch.examples.<name>`` with the
reference script's flags and defaults.  ``main(argv=None, device=None)``
parses them; ``device=None`` means the card and raises without one, and
``device="cpu"`` runs the kernels' plain versions on the CPU.  Artifacts
go under ``experiments/figures_torch/`` and ``experiments/traces_torch/``
relative to the working directory, beside the reference's
``experiments/figures/`` and ``experiments/traces/``, which no module
here writes.
"""

from __future__ import annotations

from pathlib import Path

FIG_DIR = Path("experiments/figures_torch")


def smoke_sim(horizon: int, warmup: int):
    """The smokes' simulator: Topology(12, 4), the default rates, at most
    16 arrivals a slot."""
    from repro_torch.core import locality as loc, simulator as sim
    return sim.SimConfig(topo=loc.Topology(12, 4), true_rates=loc.Rates(),
                         max_arrivals=16, horizon=horizon, warmup=warmup)


def smoke_study(horizon: int = 1500, warmup: int = 400):
    """The smokes' study: `smoke_sim` at seed 0."""
    from repro_torch.core import robustness as rb
    return rb.StudyConfig(sim=smoke_sim(horizon, warmup), seeds=(0,))
