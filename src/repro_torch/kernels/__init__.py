"""Hand-written Hopper kernels of the port and their plain versions:

  slot_step  — fused fleet slot-step (workload + private-route argmin),
               CUDA C++ in csrc/fleet_route.cu
  wwl_route  — batched Balanced-PANDAS routing (weighted-workload argmin),
               CUDA C++ in csrc/wwl_route.cu
  maxweight  — batched JSQ-MaxWeight claim scoring (weighted argmax),
               CUDA C++ in csrc/maxweight.cu
  flash_attention — online-softmax GQA attention (causal, window,
               softcap), CUDA C++ in csrc/flash_attention.cu
  ssd_scan   — Mamba-2 SSD scan with initial and final state, CUDA C++
               in csrc/ssd_scan.cu

Public API lives in ops.py (CPU -> plain version, CUDA -> kernel); plain
versions in ref.py; the nvcc build and the launch counts in _build.py.
Three of the reference's five re-exports are here; ``flash_attention``
and ``wwl_route`` are left out, since here those names are the kernel
modules (``from repro_torch.kernels import wwl_route`` is the module):
call `ops.flash_attention` and `ops.wwl_route`.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    fleet_route, maxweight_claim, ssd,
)
