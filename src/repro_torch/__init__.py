"""PyTorch/CUDA port of `repro`, for one NVIDIA H100.

Laid out module for module like `repro` (the JAX reference, which stays
unchanged): `repro_torch.core.locality` is the counterpart of
`repro.core.locality`, and so on.  The port imports neither `jax` nor
`repro`; only its tests import both.  Ported so far: the dense
simulator with the reference's seven policies and the robustness study
(`core.simulator.simulate`/`sweep`, `core.robustness.run_study`), the
fleet-scale path for Balanced-PANDAS and power-of-d, one run or a whole
(load x error x seed) study batched over cells (`sharding.sim` ->
`fleet_sweep` -> the hand-written CUDA `fleet_route` kernel), the CUDA
`wwl_route` and `maxweight_claim` kernels behind `kernels.ops`, the
scenario subsystem (`workloads`: time-varying traffic and rates on the
dense simulator, the drift study and the serving engine), replica
placement, the replication lifecycle, telemetry, the control plane
(`control`: load generation, admission and autoscaling on the dense
simulator and the serving engine, and the SLO-control study), the model
stack for all ten architecture ids (dense, MoE, Mamba-2, the hybrid,
the encoder-decoder and the vision model) served by the engine with its
two model kernels and by the prefill and serve steps, and training
(`data`: the locality-aware pipeline; `launch.steps`, `optim`, `train`,
`checkpoint`, `launch.train`); see ROADMAP.md for what is still to
port.

Entry points take ``device=None``, which means the card (``"cuda"``), and
raise when none is present; pass ``device="cpu"`` to run the kernels'
plain PyTorch versions on the CPU, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
