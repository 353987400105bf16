"""The port's replication lifecycle on the dense simulator against the JAX
reference's, slot by slot: under the replayed draws
(`_torch_port.JaxDenseReplay` with ``reads``), the port's
`SimReplication` state and ``fg_mult`` equal the reference's
`SimReplication.step` after every slot, for the three controllers under
server_loss and rack_loss (and static for the two dynamic ones), on
uniform and on spread placement.  Exact.  Whole runs are held in
tests/test_torch_replication_run.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import workloads as rwl
from repro.core import locality as rloc
from repro.placement import make_placement as rmake_placement
from repro.replication import make_replication as rmake_replication
from repro_torch import workloads as wl
from repro_torch.core import locality as loc
from repro_torch.placement import make_placement
from repro_torch.replication import make_replication
from _torch_port import (JaxDenseReplay, read_logits,  # noqa: F401
                         single_torch_thread)

SLOTS, WARMUP, BATCH = 120, 30, 16
SEEDS = (3, 7)
RATES = (0.5, 0.45, 0.25)
STATE_CASES = [(ctrl, scen, plc) for plc in ("uniform", "spread")
               for ctrl, scen in (("fixed", "server_loss"),
                                  ("fixed", "rack_loss"),
                                  ("repair", "server_loss"),
                                  ("repair", "rack_loss"),
                                  ("repair", "static"),
                                  ("popularity", "server_loss"),
                                  ("popularity", "rack_loss"),
                                  ("popularity", "static"))]


def _topos():
    return rloc.Topology(12, 4), loc.Topology(12, 4)


def _lam(rtopo):
    return np.float32(0.8 * rloc.capacity_hot_rack(rtopo, rloc.Rates(RATES),
                                                   0.5))


@pytest.mark.parametrize("ctrl,scen,plc", STATE_CASES,
                         ids=[f"{c}-{s}-{p}" for c, s, p in STATE_CASES])
def test_lifecycle_state_equals_reference_after_every_slot(ctrl, scen, plc):
    rtopo, topo = _topos()
    lam = _lam(rtopo)
    rrep = rmake_replication(ctrl).build_sim(rtopo, np.asarray(RATES),
                                             rmake_placement(plc))
    rep = make_replication(ctrl).build_sim(topo, np.asarray(RATES),
                                           make_placement(plc), "cpu")
    np.testing.assert_array_equal(
        read_logits(rep.C, make_replication(ctrl).read_skew),
        np.asarray(rrep.read_logits))
    rsched = rwl.compile_schedule(rwl.make_scenario(scen), rtopo, SLOTS, 0.5)
    r_rack = jnp.asarray(rtopo.rack_of)
    ones = jnp.ones(rtopo.num_servers, jnp.float32)

    def r_run(seed):   # the reference scan body's lifecycle part
        base = jax.random.PRNGKey(seed)

        def body(st, t):
            knobs = rwl.slot_knobs(rsched, t)
            key_t = jax.random.fold_in(base, t)
            k_arr, _ = jax.random.split(key_t)
            _, active = rloc.sample_arrivals_at(
                k_arr, r_rack, lam * knobs.lam_mult, knobs.p_hot,
                knobs.hot_rack, BATCH, knobs.rack_weights)
            alive = knobs.alive if knobs.alive is not None else ones
            st, fg = rrep.step(st, alive, key_t, active, t >= WARMUP)
            return st, (st, fg)

        return jax.lax.scan(body, rrep.init(), jnp.arange(SLOTS))[1]

    r_states, r_fg = jax.jit(jax.vmap(r_run))(
        jnp.asarray(SEEDS, jnp.uint32))
    r_states = [np.asarray(x) for x in r_states]
    r_fg = np.asarray(r_fg)

    sched = wl.compile_schedule(wl.make_scenario(scen), topo, SLOTS, 0.5,
                                device="cpu")
    src = JaxDenseReplay("balanced_pandas", [(s, lam) for s in SEEDS], BATCH,
                         topo.num_servers, SLOTS,
                         lam_mult=sched.lam_mult[sched.seg].numpy(),
                         reads=(rep.C, rep.ctrl.read_skew))
    st = rep.init(len(SEEDS))
    moved = 0
    for t in range(SLOTS):
        d = src.slot(t)
        active = torch.arange(BATCH) < d.n[:, None]
        alive = wl.slot_knobs(sched, t).alive
        alive = torch.ones(topo.num_servers) if alive is None else alive
        st, fg = rep.step(st, alive, d.read, active, t >= WARMUP)
        for name, got, want in zip(st._fields, st, r_states):
            np.testing.assert_array_equal(
                got.numpy(), want[:, t], err_msg=f"slot {t}: {name}")
        np.testing.assert_array_equal(fg.numpy(), r_fg[:, t],
                                      err_msg=f"slot {t}: fg_mult")
        moved = int(st.moves.sum())
    if ctrl == "fixed":
        assert moved == 0
    elif scen != "static" or ctrl == "popularity":
        assert moved > 0   # the case exercised the lanes


