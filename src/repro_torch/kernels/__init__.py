"""Hand-written Hopper kernels of the port and their plain versions:

  slot_step  — fused fleet slot-step (workload + private-route argmin),
               CUDA C++ in csrc/fleet_route.cu

Public API lives in ops.py (CPU -> plain version, CUDA -> kernel); plain
versions in ref.py; the nvcc build in _build.py.
"""
