"""Measures the float32 differences behind `hot_aware`'s kept difference
(ROADMAP Queue 3), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_log_ulp.py

Prints, over a million uniform float32 inputs in [1e-4, 10), the share
where XLA's CPU ``log`` and where torch's differ from the correctly
rounded log (float64, rounded once); then the share of n in 1..10008
where torch's ``3 / n`` (a reciprocal times 3) differs from the float32
quotient that ``jnp`` and a tensor-by-tensor division give; then the
hot_aware weights of small topologies at which the two logs differ.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import locality as loc


def main():
    x = np.random.default_rng(0).uniform(1e-4, 10, 10 ** 6).astype(np.float32)
    exact = np.log(x.astype(np.float64)).astype(np.float32)
    xla = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    tch = torch.log(torch.from_numpy(x)).numpy()
    print(f"log off the correctly rounded value: XLA CPU "
          f"{np.mean(xla != exact):.4%}, torch {np.mean(tch != exact):.4%}")
    n = torch.arange(1, 10009, dtype=torch.int32)
    quot = torch.tensor(3.0) / n.float()
    print(f"3 / n as reciprocal x 3 off the quotient: "
          f"{np.mean((3 / n).numpy() != quot.numpy()):.2%} of n <= 10008")
    logs = jax.jit(jnp.log)
    for m, groups in ((4, 2), (8, (2, 4)), (16, 8), (12, 4), (24, 6),
                      (24, (4, 12))):
        sizes = np.bincount(np.asarray(loc.Topology(m, groups).rack_of))
        bad = []
        for r_hot in range(3, 11):
            for n_hot in sorted(set(sizes.tolist())):
                for num, den in ((3, n_hot), (r_hot - 3, max(m - n_hot, 1))):
                    w = np.float32(num) / np.float32(den)
                    if np.asarray(logs(jnp.float32(w))) != \
                            torch.log(torch.tensor(w)).numpy():
                        bad.append((r_hot, num, den))
        print(f"Topology({m}, {groups}): weights (r_hot, num, den) whose "
              f"logs differ: {sorted(set(bad))}")


if __name__ == "__main__":
    main()
