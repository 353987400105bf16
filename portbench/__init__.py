"""Benchmark of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints one JSON line.  Everything a cell needs is found by
name: its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, each per-layer metric's reader in
``metrics/<metric>.py`` and a kernel's cost counts in
``costs/<kernel>.py``.  ``reference/`` holds the plain reference that
decides ``correct``.  Nothing here imports ``jax``, the JAX package
``repro`` or ``benchmarks/``.
"""
