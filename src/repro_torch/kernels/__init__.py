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
"""
