"""The port's control plane (`repro_torch.control`, the `Autoscaler` of
`repro_torch.launch.elastic`) against the JAX reference's, piece by
piece.

(a) The registry: names, `controller_descriptions`, `make_controller`
    and `resolve_control` with their errors, and `scale_priority` on
    three topologies.
(b) Every controller's ``sim_*`` hooks bit for bit against the
    reference's compiled (jitted, vmapped) hooks on seeded random (N,)
    inputs: the token bucket with and without defer at rates and bursts
    that are not powers of two, the queue threshold, both loadgens under
    a ``users_mult`` track, and the autoscaler at local rates whose
    reciprocal is inexact (the reference's compiled step multiplies by
    the float32 reciprocal, folded with the headroom, and with a
    loadgen's factor where the loadgen feeds it).
(c) The host projection: `Autoscaler` targets over seeded p95 streams
    with NaNs, `ClosedLoopClients` poll sequences, `HostControl`
    decisions and metrics.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import control as rctl
from repro.core import locality as rloc
from repro.launch import elastic as relastic
from repro_torch import control as ctl
from repro_torch.control import controllers as cc
from repro_torch.core import locality as loc
from repro_torch.core.rng import closed_loop_rates
from repro_torch.launch import elastic
from _torch_port import single_torch_thread  # noqa: F401

N = 4096


class _Knobs(NamedTuple):
    lam_mult: jnp.ndarray
    users_mult: Optional[jnp.ndarray] = None


def _fields(c):
    return (type(c).__name__, c.name, c.kind, dataclasses.asdict(c))


def _error(fn, *args):
    try:
        fn(*args)
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError(f"{fn.__name__}{args} did not raise")


# -- registry ---------------------------------------------------------------

def test_registry_and_descriptions_equal_reference():
    assert ctl.available_controllers() == rctl.available_controllers()
    assert ctl.controller_descriptions() == rctl.controller_descriptions()
    from repro.control import plane as rplane
    from repro_torch.control import plane
    assert plane.KINDS == rplane.KINDS
    assert ctl.CONTROL_METRIC_KEYS == rctl.CONTROL_METRIC_KEYS
    assert ctl.__all__ == rctl.__all__


SPECS = ["token_bucket", "autoscale", "closed_loop", "open_loop",
         "queue_threshold",
         {"name": "token_bucket", "options": {"rate": 2.5, "defer": True}},
         ctl.ControlConfig("queue_threshold", {"threshold": 7}),
         {"name": "autoscale", "options": {"headroom": 1.7,
                                           "min_servers": 3}},
         {"name": "closed_loop", "options": {"users": 9,
                                             "think_time": 2.5}}]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_make_controller_equals_reference(spec):
    rspec = (rctl.ControlConfig(spec.name, spec.options)
             if isinstance(spec, ctl.ControlConfig) else spec)
    assert _fields(ctl.make_controller(spec)) == \
        _fields(rctl.make_controller(rspec))


def test_resolve_control_equals_reference():
    assert ctl.resolve_control(None) is None
    for spec in (["queue_threshold", "autoscale"],
                 ({"name": "token_bucket", "options": {"rate": 3.0}},
                  "autoscale", "open_loop"), "closed_loop"):
        got, want = ctl.resolve_control(spec), rctl.resolve_control(spec)
        assert got.describe() == want.describe()
        assert sorted(got.by_kind) == sorted(want.by_kind)
        for kind in got.by_kind:
            assert _fields(got.by_kind[kind]) == _fields(want.by_kind[kind])
    one = ctl.resolve_control("token_bucket")
    assert ctl.resolve_control(one) is one
    # the errors, message for message
    for fn, rfn, arg in (
            (ctl.make_controller, rctl.make_controller, "admission"),
            (ctl.make_controller, rctl.make_controller, "no_such"),
            (ctl.make_controller, rctl.make_controller, 3.5),
            (ctl.resolve_control, rctl.resolve_control, 42),
            (ctl.resolve_control, rctl.resolve_control,
             ["token_bucket", "queue_threshold"]),
            (ctl.make_controller, rctl.make_controller,
             {"name": "token_bucket", "options": {"burst": 0.5}}),
            (ctl.make_controller, rctl.make_controller,
             {"name": "autoscale", "options": {"step_frac": 1.5}}),
            (ctl.make_controller, rctl.make_controller,
             {"name": "closed_loop", "options": {"think_time": 0.0}})):
        assert _error(fn, arg) == _error(rfn, arg), arg
    assert _error(ctl.ControlPlane, []) == _error(rctl.ControlPlane, [])


def test_register_controller_rejects_as_reference():
    from repro.control.plane import AdmissionController as RAdm
    from repro_torch.control.plane import AdmissionController as Adm
    for attrs in ({"name": "token_bucket"},
                  {"name": "bad_kind_ctl", "kind": "nope"},
                  {"name": ""}):
        got = _error(ctl.register_controller, type("X", (Adm,), attrs))
        want = _error(rctl.register_controller, type("X", (RAdm,), attrs))
        assert got == want, attrs


@pytest.mark.parametrize("topo", [(12, 4), (24, 6), (24, (4, 12))],
                         ids=["12x4", "24x6", "24x(4,12)"])
def test_scale_priority_equals_reference(topo):
    got = ctl.scale_priority(loc.Topology(*topo))
    want = rctl.scale_priority(rloc.Topology(*topo))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- the simulator hooks, bit for bit ---------------------------------------

def _admit_inputs(seed, burst, cap_backlog, batch=16):
    rng = np.random.default_rng(seed)
    tokens = rng.uniform(0, burst, N).astype(np.float32)
    tokens[: N // 8] = np.floor(tokens[: N // 8])   # integer levels too
    backlog = rng.uniform(0, cap_backlog * 1.2, N).astype(np.float32)
    backlog[N // 8: N // 4] = np.floor(backlog[N // 8: N // 4])
    n_arr = rng.integers(0, batch + 1, N).astype(np.int32)
    n_sys = rng.integers(0, 60, N).astype(np.int32)
    spare = (batch - n_arr).astype(np.int32)
    return tokens, backlog, n_arr, n_sys, spare


ADMIT_CASES = [
    ("token_bucket", {"rate": 2.37, "burst": 7.3}),
    ("token_bucket", {"rate": 0.93 * 10.0, "burst": 80.0}),
    ("token_bucket", {"rate": 4.2666665, "burst": 10.7, "defer": True,
                      "backlog_cap": 11.6}),
    ("token_bucket", {"rate": 1.9, "burst": 3.3, "defer": True,
                      "backlog_cap": 0.0}),
    ("queue_threshold", {"threshold": 17}),
]


@pytest.mark.parametrize("name,opts", ADMIT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ADMIT_CASES)])
def test_admission_hooks_bit_for_bit(name, opts):
    spec = {"name": name, "options": opts}
    port, ref = ctl.make_controller(spec), rctl.make_controller(spec)
    assert port.sim_init() == ref.sim_init()
    assert port.defers == ref.defers
    burst = opts.get("burst", 8.0)
    args = _admit_inputs(7, burst, opts.get("backlog_cap", 8.0))
    want = jax.jit(jax.vmap(ref.sim_admit))(*map(jnp.asarray, args))
    got = port.sim_admit(*map(torch.from_numpy, args))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.broadcast_to(np.asarray(w), (N,))
        assert g.shape == (N,), i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
        assert g.numpy().dtype == w.dtype, i


@pytest.mark.parametrize("users_mult", [None, "track"])
def test_loadgen_hooks_bit_for_bit(users_mult):
    rng = np.random.default_rng(3)
    in_flight = rng.integers(0, 80, N).astype(np.int32)
    lam_total = rng.uniform(0.0, 30.0, N).astype(np.float32)
    lam_mult = rng.uniform(0.2, 2.5, N).astype(np.float32)
    mult = None if users_mult is None else \
        rng.uniform(0.0, 2.2, N).astype(np.float32)
    for spec in ({"name": "open_loop", "options": {"extra_mult": 0.8}},
                 {"name": "open_loop", "options": {"extra_mult": 1.37}},
                 {"name": "closed_loop", "options": {"users": 37,
                                                     "think_time": 2.7}},
                 {"name": "closed_loop", "options": {"users": 64,
                                                     "think_time": 8.0}}):
        port, ref = ctl.make_controller(spec), rctl.make_controller(spec)

        def reference(f, lt, lm, um):
            return ref.sim_offered(f, lt, _Knobs(lm, um))

        fn = jax.jit(jax.vmap(reference, (0, 0, 0, None if mult is None
                                          else 0)))
        want = fn(jnp.asarray(in_flight), jnp.asarray(lam_total),
                  jnp.asarray(lam_mult),
                  None if mult is None else jnp.asarray(mult))
        knobs = _Knobs(torch.from_numpy(lam_mult),
                       None if mult is None else torch.from_numpy(mult))
        got = port.sim_offered(torch.from_numpy(in_flight),
                               torch.from_numpy(lam_total), knobs)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                      err_msg=str(spec))
        if want[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
            assert got[1].dtype == torch.int32
            # the draw seam's table covers every thinking count, at the
            # reference's compiled rates
            u_max = port.max_users(None if mult is None else mult)
            assert int(got[1].max()) <= u_max
            rates = jax.jit(lambda k: k.astype(jnp.float32)
                            / jnp.float32(ref.think_time))(
                jnp.arange(u_max + 1, dtype=jnp.int32))
            np.testing.assert_array_equal(
                closed_loop_rates(u_max, port.think_time), np.asarray(rates))


@pytest.mark.parametrize("rate0", [0.5, 0.45, 0.7, 1.0 / 3.0])
def test_autoscale_hook_bit_for_bit(rate0):
    rng = np.random.default_rng(11)
    m = 24
    lam = rng.uniform(0.0, 12.0, N).astype(np.float32)
    # values whose headroom x lam / rate0 sits next to an integer
    near = (np.arange(N // 4) % (m + 2)).astype(np.float32) * np.float32(
        rate0) / np.float32(1.35)
    lam[: N // 4] = np.nextafter(near, np.float32(np.inf) * (
        (np.arange(N // 4) % 2) * 2 - 1))
    for opts in ({}, {"headroom": 1.7, "min_servers": 3},
                 {"headroom": 0.9}):
        spec = {"name": "autoscale", "options": opts}
        port, ref = ctl.make_controller(spec), rctl.make_controller(spec)
        want = jax.jit(jax.vmap(lambda x: ref.sim_target(x, m, rate0)))(
            jnp.asarray(lam))
        got = port.sim_target(torch.from_numpy(lam), m, rate0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(opts))


def test_f32_scale_is_the_compiled_division():
    """The folded constant of `_f32_scale` against the reference's
    compiled ``h * x / float32(c)`` on a million float32 values."""
    x = np.random.default_rng(0).uniform(0, 40, 1 << 20).astype(np.float32)
    for h, c in ((1.35, 0.5), (1.35, 0.45), (1.7, 0.7), (1.0, 2.7),
                 (1.0, 3.0), (0.9, 1.0 / 3.0)):
        xla = np.asarray(jax.jit(lambda v: h * v / jnp.float32(c))(x))
        ours = x * np.float32(cc._f32_scale(h, c))
        np.testing.assert_array_equal(ours, xla, err_msg=f"{h} / {c}")


@pytest.mark.parametrize("loadgen,rate0", [
    ({"name": "closed_loop", "options": {"users": 400, "think_time": 2.7}},
     0.45),
    ({"name": "closed_loop", "options": {"users": 400, "think_time": 3.3}},
     0.3),
    ({"name": "open_loop", "options": {"extra_mult": 0.8}}, 0.45),
    ({"name": "open_loop", "options": {"extra_mult": 1.7}}, 0.3),
], ids=["closed-2.7", "closed-3.3", "open-0.8", "open-1.7"])
def test_loadgen_rate_folds_into_the_autoscaler(loadgen, rate0):
    """A loadgen's rate through the autoscaler, against the reference's
    compiled chain ``sim_target(sim_offered(...))``: XLA folds the
    loadgen's factor, the headroom and 1 / rate0 into one float32
    constant, and the port's `sim_count` of `sim_base` times
    `sim_scale(rate0, rate_factor)` equals it at every thinking count
    0..400, or at open-loop rates around each step of the count; the
    two-product form (the rate rounded first) does not."""
    m = 1 << 24
    port, ref = ctl.make_controller(loadgen), rctl.make_controller(loadgen)
    asc, ref_as = ctl.make_controller("autoscale"), \
        rctl.make_controller("autoscale")
    scale = asc.sim_scale(rate0, port.rate_factor)
    if port.name == "closed_loop":
        x = np.arange(port.users + 1, dtype=np.int32)
        want = jax.jit(jax.vmap(lambda v: ref_as.sim_target(ref.sim_offered(
            ref.users - v, jnp.float32(0.0), _Knobs(jnp.float32(1.0)))[0],
            m, rate0)))(jnp.asarray(x))
        base, _ = port.sim_base(port.users - torch.from_numpy(x), None, None)
    else:
        steps = (np.arange(1, 65) / scale).astype(np.float32)
        x = np.concatenate([np.nextafter(steps, np.float32(d))
                            for d in (0.0, np.inf)] + [steps])
        want = jax.jit(jax.vmap(lambda v: ref_as.sim_target(ref.sim_offered(
            0, v, _Knobs(jnp.float32(1.0)))[0], m, rate0)))(jnp.asarray(x))
        base, _ = port.sim_base(None, torch.from_numpy(x),
                                _Knobs(torch.tensor(1.0)))
    np.testing.assert_array_equal(asc.sim_count(base, scale, m).numpy(),
                                  np.asarray(want))
    two = asc.sim_target(base * port.rate_factor, m, rate0).numpy()
    assert (two != np.asarray(want)).any()


# -- the host projection ----------------------------------------------------

AUTOSCALERS = [
    dict(min_servers=2, max_servers=8, p95_high=100.0, p95_low=10.0,
         up_after=2, down_after=3, cooldown=5, step_frac=0.25),
    dict(min_servers=1, max_servers=4, p95_high=50.0, p95_low=5.0,
         up_after=2, down_after=2, cooldown=0),
    dict(min_servers=3, max_servers=24, up_after=1, down_after=4,
         cooldown=3, step_frac=0.4),
]


@pytest.mark.parametrize("opts", AUTOSCALERS, ids=range(len(AUTOSCALERS)))
def test_autoscaler_equals_reference(opts):
    rng = np.random.default_rng(5)
    got, want = elastic.Autoscaler(**opts), relastic.Autoscaler(**opts)
    p95 = rng.choice([1.0, 8.0, 30.0, 70.0, 200.0, np.nan], 600)
    for step, p in enumerate(p95):
        assert got.observe(step, float(p)) == want.observe(step, float(p))
        assert got.current == want.current
    for bad in (dict(min_servers=5, max_servers=4),
                dict(min_servers=1, max_servers=4, p95_low=9.0,
                     p95_high=1.0),
                dict(min_servers=1, max_servers=4, up_after=0),
                dict(min_servers=1, max_servers=4, step_frac=0.0)):
        with pytest.raises(ValueError) as e1:
            elastic.Autoscaler(**bad)
        with pytest.raises(ValueError) as e2:
            relastic.Autoscaler(**bad)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("users,think,seed", [(5, 3.0, 1), (8, 4.0, 0),
                                              (17, 2.5, 9)])
def test_closed_loop_clients_equal_reference(users, think, seed):
    got = ctl.ClosedLoopClients(users, think, seed=seed)
    want = rctl.ClosedLoopClients(users, think, seed=seed)
    rng = np.random.default_rng(seed + 100)
    submitted = completed = 0
    for step in range(200):
        n = got.poll(step, completed)
        assert n == want.poll(step, completed)
        assert got.in_flight == want.in_flight <= users
        submitted += n
        if completed < submitted:
            completed += int(rng.integers(0, submitted - completed + 1))
        assert got.done == want.done


@pytest.mark.parametrize("spec", [
    ["queue_threshold", "autoscale"],
    [{"name": "token_bucket", "options": {"rate": 0.25, "burst": 8}},
     {"name": "autoscale", "options": {"p95_high": 20.0, "p95_low": 4.0,
                                       "down_after": 2, "cooldown": 2}}],
    [{"name": "closed_loop", "options": {"users": 8, "think_time": 4.0}},
     {"name": "token_bucket", "options": {"rate": 0.7, "burst": 2.5}}],
], ids=["threshold+autoscale", "bucket+autoscale", "closed_loop+bucket"])
def test_host_control_equals_reference(spec):
    topo, rtopo = loc.Topology(8, 2), rloc.Topology(8, 2)
    got = ctl.resolve_control(spec).build_host(topo, 1.0, seed=3)
    want = rctl.resolve_control(spec).build_host(rtopo, 1.0, seed=3)
    assert (got.clients is None) == (want.clients is None)
    assert (got.autoscaler is None) == (want.autoscaler is None)
    rng = np.random.default_rng(2)
    done = 0
    for step in range(300):
        if got.clients is not None:
            assert got.clients.poll(step, done) == \
                want.clients.poll(step, done)
            # complete some of the requests in flight
            done += int(rng.integers(0, got.clients.in_flight + 1))
        for _ in range(int(rng.integers(0, 4))):
            n_sys = int(rng.integers(0, 300))
            assert got.admit(step, n_sys) == want.admit(step, n_sys)
        p95 = float(rng.choice([np.nan, 2.0, 10.0, 80.0, 500.0]))
        assert got.observe(step, p95) == want.observe(step, p95)
        assert got.metrics() == want.metrics()
