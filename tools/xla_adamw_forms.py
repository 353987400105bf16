"""Measures the float32 forms behind the reference's compiled AdamW step
(`repro.optim.adamw.update` and `lr_schedule` under `jax.jit`), on the
CPU, against the port's `repro_torch.optim.adamw`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_adamw_forms.py

Prints, over a million float32 inputs from a seed: how many values of
the compiled ``0.9 * m + (1 - 0.9) * g`` differ from the two-rounding
form and from the port's `_fma` (the first product fused into the sum);
how many values of the compiled `jax.lax.rsqrt` differ from the
correctly rounded reciprocal square root (and by how many ulps); how
many warmup learning rates at steps 0-99 differ from the source's
``peak * step / warmup`` and from the port's folded product; then, for
one `update` on a tree of 300,000 elements (float32 moments and update),
how many parameters, first and second moments of the port differ from
the compiled reference, and the largest parameter difference over
|p| + lr |step|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import adamw as RA
from repro_torch.optim import adamw as TA

N = 1_000_000


def main() -> None:
    rng = np.random.default_rng(0)
    m, g = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(lambda m, g: 0.9 * m + (1 - 0.9) * g)(m, g))
    two = np.float32(0.9) * m + np.float32(0.1) * g
    fused = TA._fma(torch.tensor(np.float32(0.9)), torch.tensor(m),
                    torch.tensor(0.1, dtype=torch.float32)
                    * torch.tensor(g)).numpy()
    print(f"b1*m + (1-b1)*g, {N} values: two roundings differ at "
          f"{int((two != want).sum())}, the port's _fma at "
          f"{int((fused != want).sum())}")

    x = rng.uniform(1e-6, 10.0, N).astype(np.float32)
    r = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    ulps = r.view(np.int32).astype(np.int64) - exact.view(
        np.int32).astype(np.int64)
    vals, counts = np.unique(ulps, return_counts=True)
    print(f"rsqrt, {N} values in [1e-6, 10): off the correctly rounded "
          f"value at {int((r != exact).sum())} "
          f"(ulps: {dict(zip(vals.tolist(), counts.tolist()))})")

    cfg = RA.AdamWConfig()
    s = np.arange(0, cfg.warmup_steps, dtype=np.int32)
    lr = np.asarray(jax.jit(jax.vmap(lambda t: RA.lr_schedule(cfg, t)))(s))
    src = np.float32(cfg.peak_lr) * s.astype(np.float32) \
        / np.float32(cfg.warmup_steps)
    port = TA.lr_schedule(TA.AdamWConfig(), torch.tensor(s)).numpy()
    print(f"warmup lr at steps 0-{cfg.warmup_steps - 1}: the source's "
          f"form differs at {int((src != lr).sum())}, the port's at "
          f"{int((port != lr).sum())}")

    shape = (1000, 300)
    p, gr, mu = (rng.normal(size=shape).astype(np.float32)
                 for _ in range(3))
    nu = np.abs(rng.normal(size=shape)).astype(np.float32)
    rst = RA.AdamWState(jnp.int32(4), {"w": mu}, {"w": nu})
    rp, rs, _ = jax.jit(lambda g, s, p: RA.update(cfg, g, s, p))(
        {"w": gr}, rst, {"w": p})
    t = lambda a: {"w": torch.tensor(a)}
    tp = t(p)
    _, ts, _ = TA.update(TA.AdamWConfig(), t(gr), TA.AdamWState(
        torch.tensor(4, dtype=torch.int32), t(mu), t(nu)), tp)
    want_p = np.asarray(rp["w"])
    got_p = tp["w"].numpy()
    size = np.abs(p) + np.abs(p - want_p)
    print(f"update, {p.size} elements: parameters differ at "
          f"{int((got_p != want_p).sum())}, mu at "
          f"{int((ts.mu['w'].numpy() != np.asarray(rs.mu['w'])).sum())}, "
          f"nu at {int((ts.nu['w'].numpy() != np.asarray(rs.nu['w'])).sum())};"
          f" largest |dp| / (|p| + lr |step|) "
          f"{float(np.max(np.abs(got_p - want_p) / size)):.3e}")


if __name__ == "__main__":
    main()
