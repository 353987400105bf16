"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W limit): the yardstick's own copy, so that no
change to the program can move it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
MEMORY_BYTES = 80e9
