"""The port's compilation cache (counterpart of `repro.utils.cache`).

The reference opts in, through an environment variable, to JAX's
persistent compilation cache: its jitted programs take minutes to
compile and are the same from run to run.  The port compiles nothing at
run time but its CUDA kernels, and uses no `torch.compile` (no Inductor
cache).  `kernels/_build.py` already caches each kernel: it builds a
source with nvcc once and keeps the library in `kernels/_build/`, named
by a digest of the source, the shared headers and the flags, so a later
run loads it from disk and an edited source is rebuilt.

So `enable_persistent_cache()` reads no environment variable, imports
no JAX and changes nothing: it returns that directory, the one cache
the port has, for a caller that reports where it is.
"""

from __future__ import annotations

from repro_torch.kernels import _build


def enable_persistent_cache() -> str:
    """The directory of the built kernels (`kernels._build.BUILD_DIR`);
    always on, the same for every entry point."""
    return str(_build.BUILD_DIR)
