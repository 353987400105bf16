"""Measures the float32 form of the telemetry recorder's bin divisions
(ROADMAP Queue 3), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/telemetry_bin_division.py

The reference's recorder bins a sojourn as ``int(soj / bin_width)`` and a
queue length as ``int(n / qbin_width)`` inside a compiled scan, the
width a Python float.  For integer numerators 0..39999 and bin widths
``hist_max / hist_bins`` over a grid of (hist_max, hist_bins), prints
how many bins of the compiled division differ from: the true float32
quotient (what `torch` computes on the CPU for a tensor over a Python
float), the product with float32(1 / width) (the reciprocal rounded
once from float64), and the product with float32(1) / float32(width)
(the port's `recorder._f32_reciprocal`, which `torch` on the card also
forms for a division by a scalar).  Only the last must read 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.telemetry.recorder import _f32_reciprocal


def main() -> None:
    x = np.arange(0, 40000, dtype=np.float32)
    widths = [hm / hb for hm in (10.0, 64.0, 100.0, 256.0, 300.0, 512.0,
                                 1000.0) for hb in range(1, 400, 3)]
    diff = {"true quotient": 0, "float32(1 / w)": 0,
            "float32(1) / float32(w)": 0}
    for w in widths:
        xla = np.asarray(jax.jit(lambda v: (v / w).astype(jnp.int32))(x))
        forms = {
            "true quotient": (x / np.float32(w)).astype(np.int32),
            "float32(1 / w)": (x * np.float32(1.0 / w)).astype(np.int32),
            "float32(1) / float32(w)":
                (x * np.float32(_f32_reciprocal(w))).astype(np.int32)}
        for name, got in forms.items():
            diff[name] += int((got != xla).sum())
    print(f"{len(widths)} widths x {x.size} numerators; bins that differ "
          f"from the compiled reference:")
    for name, n in diff.items():
        print(f"  {name:24s} {n}")


if __name__ == "__main__":
    main()
