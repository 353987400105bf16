"""Measures the float32 forms behind the popularity controller's threshold
and decay (ROADMAP Queue 3), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_quantile_ulp.py

The reference computes ``jnp.quantile(pop, 1 - hot_frac)`` and ``(1 -
decay) * pop + reads`` inside a compiled scan, where XLA may fuse a
product into the following sum (one rounding).  Prints, for 4000 rows of
C float32 popularities (ties and zeros included) at several (C,
hot_frac), how many thresholds of the compiled ``jnp.quantile`` differ
from: the two-product form (two roundings), `torch.quantile`, and the
port's `controllers.quantile_linear` (the first product fused); then,
for the decay of ``pop`` inside the reference's own compiled lifecycle
step (`SimReplication.step` in a scan under server_loss), how many
values differ from the two-rounding and from the fused form.  (Whether
XLA fuses depends on the surrounding computation: the same update
compiled alone does fuse.)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.replication.controllers import quantile_linear


def _rows(rng, n, c):
    x = rng.random((n, c)).astype(np.float32) \
        * rng.choice([1.0, 10.0, 1000.0], (n, 1)).astype(np.float32)
    x[: n // 8] = np.round(x[: n // 8])
    x[n // 8: n // 6, : c // 2] = 0.0
    return x


def _two_products(x, q):
    c = x.shape[-1]
    pos = np.float32(q) * np.float32(c - 1)
    w_high = np.float32(pos - np.float32(math.floor(pos)))
    w_low = np.float32(np.float32(1.0) - w_high)
    srt = np.sort(x, axis=-1)
    return (srt[:, math.floor(pos)] * w_low
            + srt[:, math.ceil(pos)] * w_high).astype(np.float32)


def main():
    rng = np.random.default_rng(0)
    n = 4000
    for c, hot_frac in ((16, 0.125), (64, 0.125), (64, 0.3), (37, 0.2),
                        (128, 0.125)):
        x = _rows(rng, n, c)
        q = 1.0 - hot_frac
        xla = np.asarray(jax.jit(jax.vmap(lambda r: jnp.quantile(r, q)))(x))
        two = _two_products(x, q)
        tq = torch.quantile(torch.from_numpy(x), q, dim=-1).numpy()
        port = quantile_linear(torch.from_numpy(x), q).numpy()
        print(f"C={c} hot_frac={hot_frac}: compiled jnp.quantile differs "
              f"from two products in {int((xla != two).sum())}/{n}, from "
              f"torch.quantile in {int((xla != tq).sum())}/{n}, from "
              f"quantile_linear in {int((xla != port).sum())}/{n}")

    # the decay compiled alone, then inside the reference's lifecycle step
    pop = rng.random((n, 64)).astype(np.float32) * 50
    reads = rng.integers(0, 4, (n, 64)).astype(np.float32)
    keep = np.float32(1.0 - 0.02)
    got = np.asarray(jax.jit(lambda p, r: (1.0 - 0.02) * p + r)(pop, reads))
    fused = (np.float64(keep) * pop.astype(np.float64)
             + reads.astype(np.float64)).astype(np.float32)
    print(f"decay compiled alone: differs from two roundings in "
          f"{int((got != (keep * pop + reads)).sum())}/{got.size}, from the "
          f"fused form in {int((got != fused).sum())}/{got.size}")
    # the decay inside the reference's lifecycle step, in its scan
    from repro import workloads as rwl
    from repro.core import locality as rloc
    from repro.placement import make_placement
    from repro.replication import make_replication
    topo = rloc.Topology(12, 4)
    lam = np.float32(0.8 * rloc.capacity_hot_rack(topo, rloc.Rates(), 0.5))
    for name in ("fixed", "repair", "popularity"):
        rep = make_replication(name).build_sim(
            topo, np.asarray(rloc.Rates().values), make_placement(None))
        sched = rwl.compile_schedule(rwl.make_scenario("server_loss"), topo,
                                     400, 0.5)

        def run(seed):
            base = jax.random.PRNGKey(seed)

            def body(st, t):
                knobs = rwl.slot_knobs(sched, t)
                key_t = jax.random.fold_in(base, t)
                _, active = rloc.sample_arrivals_at(
                    jax.random.split(key_t)[0], jnp.asarray(topo.rack_of),
                    lam, knobs.p_hot, knobs.hot_rack, 16)
                new, _ = rep.step(st, knobs.alive, key_t, active, t >= 100)
                ids = jax.random.categorical(
                    jax.random.fold_in(key_t, 0x5EED), rep.read_logits,
                    shape=active.shape)
                reads = jnp.zeros(rep.C, jnp.float32).at[ids].add(
                    active.astype(jnp.float32))
                return new, (st.pop, reads, new.pop)

            return jax.lax.scan(body, rep.init(), jnp.arange(400))[1]

        old, reads, got = (np.asarray(x) for x in jax.jit(run)(
            jnp.uint32(3)))
        keep = np.float32(1.0 - rep.decay)
        two = (keep * old + reads).astype(np.float32)
        fused = (np.float64(keep) * old.astype(np.float64)
                 + reads.astype(np.float64)).astype(np.float32)
        print(f"decay in the reference's {name} step (server_loss, 400 "
              f"slots): differs from two roundings in "
              f"{int((got != two).sum())}/{got.size}, from the fused form "
              f"in {int((got != fused).sum())}/{got.size}")


if __name__ == "__main__":
    main()
