"""Measures the float32 constant the reference's compiled step folds a load
generator's rate into the autoscaler with (ROADMAP Queue 3), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_control_fold.py \
        [--users 2000]

The reference's autoscaler computes ``ceil(headroom * lam_eff /
float32(rate0))``, lam_eff the loadgen's rate: closed loop's ``thinking /
float32(think_time)``, open loop's ``(lam_total * lam_mult) *
extra_mult``.  XLA folds the constants of that chain into one float32
product.  For each point of a grid of (think_time or extra_mult,
headroom, rate0) the tool compiles the reference's own hooks
(`sim_offered`, then `sim_target` with no clamp at the top), reads the
constant out of the compiled HLO, checks it against the port's
`HeadroomAutoscale.sim_scale`, and counts the inputs where the port's
count (`sim_base` times that constant, `sim_count`) differs from the
compiled reference's, and where the two-product form (the rate rounded
first, then times ``headroom / rate0``) does.  The inputs are every
thinking count 0..U (closed loop) and, for open loop, 4001 rates spread
over the counts 0..64 with the five float32 values around each step of
the count.  Exits 1 if the port's form differs anywhere.
"""

from __future__ import annotations

import argparse
import itertools
import re
import sys
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import control as rc
from repro_torch import control as cc

THINK_TIMES = (0.7, 1.5, 2.0, 2.7, 3.3, 6.3, 8.0, 13.7)
EXTRA_MULTS = (0.8, 1.37, 1.7, 2.5)
HEADROOMS = (0.9, 1.1, 1.35, 1.7, 2.3)
RATES0 = (0.45, 0.35, 0.3, 0.7, 1.0 / 3.0, 0.55, 0.9, 0.5)
TOP = 1 << 24   # the autoscaler's clamp, out of the way


class _Knobs(NamedTuple):
    lam_mult: jnp.ndarray
    users_mult: Optional[jnp.ndarray] = None


def _compiled(ref_lg, ref_as, rate0, x):
    """The reference's count at each input (thinking counts for closed
    loop, lam_total at lam_mult 1 for open loop) and the float32
    constants of its compiled HLO."""
    closed = ref_lg.name == "closed_loop"

    def chain(v):
        if closed:   # in_flight = users - thinking
            lam, _ = ref_lg.sim_offered(jnp.int32(ref_lg.users) - v,
                                        jnp.float32(0.0),
                                        _Knobs(jnp.float32(1.0)))
        else:
            lam, _ = ref_lg.sim_offered(jnp.int32(0), v,
                                        _Knobs(jnp.float32(1.0)))
        return ref_as.sim_target(lam, TOP, rate0)

    fn = jax.jit(jax.vmap(chain))
    arg = jnp.asarray(x)
    text = fn.lower(arg).compile().as_text()
    consts = [np.float32(c) for c in
              re.findall(r"f32\[\] constant\(([^)]*)\)", text)]
    return np.asarray(fn(arg)), consts


def _port(lg, asc, rate0, x):
    """The port's count (one product with `sim_scale`) and the
    two-product form's."""
    xt = torch.from_numpy(x)
    if lg.name == "closed_loop":
        base, _ = lg.sim_base(torch.full_like(xt, lg.users) - xt, None,
                              None)
    else:
        base, _ = lg.sim_base(None, xt, _Knobs(torch.tensor(1.0)))
    scale = asc.sim_scale(rate0, lg.rate_factor)
    ours = asc.sim_count(base, scale, TOP).numpy()
    two = asc.sim_target(base * lg.rate_factor, TOP, rate0).numpy()
    return ours, two, np.float32(scale)


def _open_inputs(factor: float) -> np.ndarray:
    """4001 float32 rates over the counts 0..64, and the five float32
    values around each step of the count (float64 division)."""
    grid = np.linspace(0.0, 64.0 / factor, 4001).astype(np.float32)
    steps = (np.arange(1, 65, dtype=np.float64) / factor).astype(np.float32)
    up1 = np.nextafter(steps, np.float32(np.inf))
    dn1 = np.nextafter(steps, np.float32(0.0))
    return np.concatenate([grid, np.nextafter(dn1, np.float32(0.0)), dn1,
                           steps, up1, np.nextafter(up1, np.float32(np.inf))])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--users", type=int, default=2000,
                    help="closed loop's thinking counts run 0..users")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    bad = 0
    rows = []
    specs = ([{"name": "closed_loop", "options": {"users": args.users,
                                                  "think_time": t}}
              for t in THINK_TIMES]
             + [{"name": "open_loop", "options": {"extra_mult": e}}
                for e in EXTRA_MULTS])
    for spec, h, rate0 in itertools.product(specs, HEADROOMS, RATES0):
        a_spec = {"name": "autoscale", "options": {"headroom": h}}
        lg, asc = cc.make_controller(spec), cc.make_controller(a_spec)
        ref_lg, ref_as = rc.make_controller(spec), rc.make_controller(a_spec)
        if lg.name == "closed_loop":
            x = np.arange(args.users + 1, dtype=np.int32)
        else:
            x = _open_inputs(float(asc.sim_scale(rate0, lg.rate_factor)))
        want, consts = _compiled(ref_lg, ref_as, rate0, x)
        ours, two, scale = _port(lg, asc, rate0, x)
        # no f32 constant: XLA dropped a product by 1.0
        const_ok = consts == [scale] or (not consts and scale == 1.0)
        n_ours = int((ours != want).sum())
        n_two = int((two != want).sum())
        bad += n_ours + (not const_ok)
        knob, val = ("think_time", lg.think_time) \
            if lg.name == "closed_loop" else ("extra_mult", lg.extra_mult)
        rows.append((lg.name, knob, val, h, rate0, consts, scale, const_ok,
                     n_ours, n_two, len(x)))
    for (name, knob, val, h, rate0, consts, scale, const_ok, n_ours, n_two,
         n) in rows:
        print(f"{name:11s} {knob}={val:<6g} headroom={h:<5g} "
              f"rate0={rate0:.6g}: HLO constant "
              f"{[float(c) for c in consts]} sim_scale {float(scale)!r} "
              f"({'equal' if const_ok else 'DIFFERENT'}); counts differ: "
              f"port {n_ours}/{n}, two products {n_two}/{n}")
    for name in ("closed_loop", "open_loop"):
        sel = [r for r in rows if r[0] == name]
        print(f"{name}: {len(sel)} grid points, constants equal at "
              f"{sum(r[7] for r in sel)}, port's counts differ at "
              f"{sum(r[8] for r in sel)} of {sum(r[10] for r in sel)} "
              f"inputs, the two-product form's at "
              f"{sum(r[9] for r in sel)} (at "
              f"{sum(r[9] > 0 for r in sel)} grid points)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
