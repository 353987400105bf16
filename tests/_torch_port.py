"""Shared by the port's tests: the replays of the reference's draws (fleet
and dense paths), a hook that reads per-slot values out of the
reference's compiled scan, a fixture that keeps torch to one intra-op
thread, the TF32 rounding of the float32 tensor-core kernels' models,
the stub modality inputs of a model (`modality_inputs`) with the
parameters its analytic count leaves out (`uncounted_params`), and what
the examples' tests share: one stubbed `simulator.sweep` for both
packages (`stub_sweep`), the reference's `benchmarks` modules
(`reference_benchmark`) and its `examples/` scripts
(`run_reference_script`); and the control plane's replay harness
(`replay_control`, with the configuration and pieces its arms share)."""

import functools
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.rng import DenseDraws, DenseSource, DrawSource, SlotDraws


class JaxReplay(DrawSource):
    """The reference fleet chunk's draws (`repro.sharding.sim`) for the
    cells ``[(seed, lam), ...]``, vmapped over them as `fleet_sweep` runs
    them, per slot: key_t = fold_in(PRNGKey(seed), t);
    k_arr, k_algo = split(key_t); k_n, k_t = split(k_arr);
    k_hot, k_u = split(k_t); k_route, k_serve = split(k_algo); with
    ``d`` > 0 also power-of-d's u_cand = uniform(k_route, (B, d))."""

    def __init__(self, cells, batch, num_servers, d=0):
        self._seeds = jnp.asarray([s for s, _ in cells], jnp.uint32)
        self._lams = jnp.asarray([lam for _, lam in cells], jnp.float32)

        def draws(seed, lam, t):
            base = jax.random.PRNGKey(seed)
            k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
            k_n, k_t = jax.random.split(k_arr)
            n = jnp.minimum(jax.random.poisson(k_n, lam), batch)
            k_hot, k_u = jax.random.split(k_t)
            k_route, k_serve = jax.random.split(k_algo)
            out = (n, jax.random.uniform(k_hot, (batch,)),
                   jax.random.uniform(k_u, (batch, 3)),
                   jax.random.uniform(k_serve, (num_servers,)))
            if d:
                out += (jax.random.uniform(k_route, (batch, d)),)
            return out

        self._draws = jax.jit(jax.vmap(draws, (0, 0, None)))

    def slot(self, t):
        out = [torch.from_numpy(np.array(x))
               for x in self._draws(self._seeds, self._lams, jnp.int32(t))]
        return SlotDraws(out[0].long(), *out[1:])


# how each dense policy splits its per-slot key k_algo (reference modules)
_FAMILY = {"balanced_pandas": "pandas", "pandas_po2": "po2",
           "jsq_maxweight": "claim", "priority": "claim", "fifo": "fifo",
           "blind_pandas": "pandas", "slo_pandas": "pandas"}


def _slot_keys(seed, t):
    """k_arr, k_algo of slot t: split(fold_in(PRNGKey(seed), t))."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), t))


def _lane_gumbels(key, n, shape):
    """gumbel(fold_in(key, i), shape) for i < n, stacked."""
    return jax.vmap(lambda i: jax.random.gumbel(
        jax.random.fold_in(key, i), shape))(jnp.arange(n))


def place_blocks(placement) -> int:
    """The (B, M) Gumbel blocks the reference's sampler of `placement`
    draws from ``split(k_rest, 3)``: three for hdfs and spread (whose
    degraded hdfs ignores them), none for uniform and hot_aware (which
    draws from uniform's type key)."""
    from repro.placement import make_placement
    return 3 if make_placement(placement).name in ("hdfs", "spread") else 0


def type_draws(k_t, b, m, racks=0, place=0):
    """The draws the reference's type samplers make from the slot's type
    key k_t: k_hot, k_gum = split(k_t) (k_hot, k_rack, k_gum =
    split(k_t, 3) with ``racks`` > 0); u_hot = uniform(k_hot, (B,)),
    g_type = gumbel(k_gum, (B, M)), g_rack = gumbel(k_rack, (B, racks))
    (``categorical``'s Gumbels) and, with ``place`` > 0, the placement's
    blocks gumbel(k_i, (B, M)) for k_i in split(k_gum, place)."""
    if racks:
        k_hot, k_rack, k_gum = jax.random.split(k_t, 3)
    else:
        k_hot, k_gum = jax.random.split(k_t)
    out = dict(u_hot=jax.random.uniform(k_hot, (b,)),
               g_type=jax.random.gumbel(k_gum, (b, m)))
    if racks:
        out["g_rack"] = jax.random.gumbel(k_rack, (b, racks))
    if place:
        out["g_place"] = jnp.stack([jax.random.gumbel(k, (b, m)) for k in
                                    jax.random.split(k_gum, place)])
    return out


@functools.partial(jax.jit, static_argnames=("b", "m", "racks", "place",
                                             "users", "think_time"))
def _arrival_draws(seeds, lams, ts, lam_mult, extra, b, m, racks=0, place=0,
                   users=None, think_time=None):
    """(T, N) arrival draws of the reference's `sample_arrivals_at` at the
    slot's rate ``lam * lam_mult[t] * extra`` (float32, the reference's
    order; `extra` open loop's ``extra_mult``); with ``racks`` > 0 the
    weighted path's three-way split of k_t and the (B, racks) Gumbels its
    ``categorical`` draws the hot racks from; with ``place`` > 0 the
    placement sampler's blocks (`type_draws`).  Given ``users`` (U) the
    closed loop's ``n_by_k`` (U+1,) a cell: the count at the rate
    ``k / think_time`` for every k in 0..U, from the same k_n, the rate
    formed in the compiled step as the reference's loadgen forms it."""
    def one(seed, lam, t, mult):
        k_n, k_t = jax.random.split(_slot_keys(seed, t)[0])
        out = dict(n=jnp.minimum(jax.random.poisson(k_n, lam * mult * extra),
                                 b),
                   **type_draws(k_t, b, m, racks, place))
        if users is not None:
            def at(k):
                rate = k.astype(jnp.float32) / jnp.float32(think_time)
                return jnp.minimum(jax.random.poisson(k_n, rate), b)
            out["n_by_k"] = jax.vmap(at)(jnp.arange(users + 1,
                                                    dtype=jnp.int32))
        return out
    return jax.vmap(jax.vmap(one, (0, 0, None, None)), (None, None, 0, 0))(
        seeds, lams, ts, lam_mult)


@functools.partial(jax.jit, static_argnames=("family", "b", "m", "d"))
def _policy_draws(seeds, ts, family, b, m, d):
    """(T, N) draws of one policy family, from k_algo as it splits it."""
    def one(seed, t):
        k_algo = _slot_keys(seed, t)[1]
        out = {}
        if family in ("pandas", "po2"):
            k_route, k_serve = jax.random.split(k_algo)
            if family == "pandas":
                out["route"] = _lane_gumbels(k_route, b, (m,))
            else:
                def lane(i):
                    k_cand, k_tie = jax.random.split(
                        jax.random.fold_in(k_route, i))
                    return (jax.random.choice(k_cand, m, (min(d, m),),
                                              replace=False),
                            jax.random.gumbel(k_tie, (m,)))
                out["cand"], out["route"] = jax.vmap(lane)(jnp.arange(b))
        elif family == "claim":
            k_route, k_serve, k_claim = jax.random.split(k_algo, 3)
            out["route"] = _lane_gumbels(k_route, b, (3,))
            k_perm, k_tie = jax.random.split(k_claim)
            out["perm"] = jax.random.permutation(k_perm, m)
            out["claim"] = _lane_gumbels(k_tie, m, (m,))
        else:
            k_serve, k_perm = jax.random.split(k_algo)
            out["perm"] = jax.random.permutation(k_perm, m)
        out["u_serve"] = jax.random.uniform(k_serve, (m,))
        return out
    return jax.vmap(jax.vmap(one, (0, None)), (None, 0))(seeds, ts)


def read_logits(chunks: int, read_skew: float) -> np.ndarray:
    """(C,) float32 logits of the static Zipf(read_skew) chunk-read law,
    as the reference's `SimReplication` forms them."""
    w = (np.arange(chunks, dtype=np.float64) + 1.0) ** -read_skew
    return np.asarray(jnp.asarray(np.log(w / w.sum()), jnp.float32))


@functools.partial(jax.jit, static_argnames=("b",))
def _read_draws(seeds, ts, logits, b):
    """(T, N, B) chunk reads of the reference's lifecycle:
    categorical(fold_in(key_t, 0x5EED), logits, shape=(B,)) with key_t =
    fold_in(PRNGKey(seed), t)."""
    def one(seed, t):
        key_t = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        return jax.random.categorical(jax.random.fold_in(key_t, 0x5EED),
                                      logits, shape=(b,))
    return jax.vmap(jax.vmap(one, (0, None)), (None, 0))(seeds, ts)


class JaxDenseReplay(DenseSource):
    """The reference dense scan's draws (`repro.core.simulator`), per slot
    and cell ``(seed, lam)``: key_t = fold_in(PRNGKey(seed), t);
    k_arr, k_algo = split(key_t); k_n, k_t = split(k_arr);
    k_hot, k_gum = split(k_t); then k_algo split as the policy splits it.
    Bernoullis come back as their uniforms (``bernoulli`` is ``u < p``),
    random tie-breaks as their Gumbels, choices and permutations as
    indices.  Every slot up to `horizon` is drawn at construction; build
    it inside ``jax.threefry_partitionable(False)`` to get the key layout
    the older pins were recorded with.

    Under a scenario, `lam_mult` is the (horizon,) float32 multiplier in
    force at each slot (the count is drawn at ``lam * lam_mult[t]``), and
    `racks` > 0 the rack count of a schedule with per-rack weights (the
    reference then splits k_t in three: k_hot, k_rack, k_gum).  Under a
    replica `placement` (name or `PlacementConfig`) that draws blocks of
    its own, ``g_place`` replays them (`type_draws`).  With ``reads=(C,
    read_skew)`` (the replication machinery engaged) ``read`` replays the
    lifecycle's chunk reads (`_read_draws`).  Under a control plane's
    loadgen, ``extra`` is open loop's ``extra_mult`` (applied after
    `lam_mult`, in float32) and ``think=(U, think_time)`` closed loop's
    count table ``n_by_k`` (every k in 0..U, U the largest user count)."""

    def __init__(self, policy: str, cells, batch: int, num_servers: int,
                 horizon: int, d: int = 2, lam_mult=None, racks: int = 0,
                 placement=None, reads=None, extra: float = 1.0,
                 think=None):
        seeds = jnp.asarray([s for s, _ in cells], jnp.uint32)
        lams = jnp.asarray([lam for _, lam in cells], jnp.float32)
        ts = jnp.arange(horizon, dtype=jnp.int32)
        mult = jnp.ones(horizon, jnp.float32) if lam_mult is None else \
            jnp.asarray(lam_mult, jnp.float32)
        users, think_time = (None, None) if think is None else think
        out = dict(_arrival_draws(seeds, lams, ts, mult,
                                  jnp.float32(extra), b=batch,
                                  m=num_servers, racks=racks,
                                  place=place_blocks(placement),
                                  users=users, think_time=think_time))
        out.update(_policy_draws(seeds, ts, family=_FAMILY[policy],
                                 b=batch, m=num_servers, d=d))
        if reads is not None:
            out["read"] = _read_draws(seeds, ts, read_logits(*reads),
                                      b=batch)
        self._all = {k: torch.from_numpy(np.array(v)) for k, v in
                     out.items()}
        for k in ("n", "cand", "perm", "read", "n_by_k"):
            if k in self._all:
                self._all[k] = self._all[k].long()

    def slot(self, t):
        return DenseDraws(**{f: self._all[f][t] if f in self._all else None
                             for f in DenseDraws._fields})


def read_out_of_scan(monkeypatch, cls, method, store):
    """Wrap the reference's ``cls.method`` so a compiled scan hands each
    call's result to the host, in slot order, appended to `store` as
    numpy (call `jax.effects_barrier()` before reading it)."""
    real = getattr(cls, method)

    def wrapped(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        jax.debug.callback(lambda o: store.append(
            jax.tree.map(np.asarray, o)), out, ordered=True)
        return out

    monkeypatch.setattr(cls, method, wrapped)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """The port's CPU tensors are small; torch's intra-op thread pool
    only oversubscribes the cores when several test workers share them
    (measured: 2.4x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_round(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero: `cvt.rna.tf32.f32`, as the float32 tensor-core kernels
    form each hi and lo (csrc/split_tf32.cuh)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def modality_inputs(cfg, b: int, seed: int = 0) -> dict:
    """The stub inputs a model reads beside its tokens, float32 numpy from
    a seed, shaped as tests/test_models_smoke.py shapes them: ``frames``
    (b, num_audio_frames, d_model) for an encoder-decoder, ``frontend``
    (b, num_frontend_tokens, d_model) for a vision model ({} otherwise)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision":
        out["frontend"] = rng.normal(
            size=(b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def uncounted_params(cfg) -> int:
    """Parameters of a model's tree that the reference's analytic
    `param_count` leaves out: each Mamba layer's conv bias, the
    embedding's vocab-padding rows, and with a LayerNorm the final and
    cross-attention norms' biases; an encoder's final norm and its
    position table."""
    d = cfg.d_model
    conv_b = sum(st.repeats * (cfg.ssm.d_inner(d)
                               + 2 * cfg.ssm.n_groups * cfg.ssm.d_state)
                 for st in cfg.stages for sl in st.block
                 if sl.kind == "mamba")
    pad = (cfg.padded_vocab - cfg.vocab_size) * d
    n = conv_b + pad * (1 if cfg.tie_embeddings else 2)
    if cfg.norm == "layernorm":
        n += d + d * sum(st.repeats for st in cfg.stages
                         for sl in st.block if sl.cross)
    if cfg.enc_stages:
        n += d * (2 if cfg.norm == "layernorm" else 1)
        if cfg.learned_pos:
            n += max(cfg.num_audio_frames, 1) * d
    return n


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stub_sweep(monkeypatch, seen=None):
    """Replace `simulator.sweep` in both packages by one deterministic
    numpy function of the grid: (L, E, S) delays, throughputs and final
    queue lengths from a generator seeded by the policy's name and the
    bytes of the loads, estimates and seeds.  With `seen`, each call's
    (cfg, seeds) is appended to it."""
    from repro.core import simulator as rsim
    from repro_torch.core import simulator as tsim

    def sweep(policy, cfg, lam_grid, est_stack, seeds, **kw):
        lam = np.asarray(lam_grid, np.float32).reshape(-1)
        est = np.asarray(est_stack, np.float32)
        seeds = np.asarray(seeds).reshape(-1)
        if seen is not None:
            seen.append((cfg, seeds))
        rng = np.random.default_rng([zlib.crc32(str(policy).encode()),
                                     zlib.crc32(lam.tobytes()),
                                     zlib.crc32(est.tobytes()),
                                     zlib.crc32(seeds.tobytes())])
        shape = (len(lam), len(est), len(seeds))
        return {k: rng.uniform(lo, hi, shape).astype(np.float32)
                for k, lo, hi in (("mean_delay", 1.0, 10.0),
                                  ("throughput", 0.5, 20.0),
                                  ("final_n", 0.0, 50.0))}

    monkeypatch.setattr(tsim, "sweep", sweep)
    monkeypatch.setattr(rsim, "sweep", sweep)


def reference_benchmark(monkeypatch, name):
    """The module ``benchmarks.<name>``, with the repo root on
    ``sys.path``."""
    import importlib
    monkeypatch.syspath_prepend(ROOT)
    return importlib.import_module(f"benchmarks.{name}")


def run_reference_script(monkeypatch, name, argv=()):
    """Run ``examples/<name>.py``'s ``main()`` with ``sys.argv`` set to
    `argv`; the script's own changes to ``sys.path`` are undone after
    the test."""
    import importlib.util
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}",
        os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


# -- the control plane's replay harness (tests/test_torch_control_*.py) ----

CTL_BATCH = 16
CTL_SERVERS = 12
# a local rate whose float32 reciprocal is inexact (the autoscaler's
# compiled division)
CTL_RATES = (0.45, 0.35, 0.2)


def _ctl_capacity() -> float:
    from repro.core import locality as rloc
    return rloc.capacity_hot_rack(rloc.Topology(CTL_SERVERS, 4),
                                  rloc.Rates(CTL_RATES), 0.5)


CTL_CAP = _ctl_capacity()
CTL_BUCKET = {"name": "token_bucket",
              "options": {"rate": 0.8 * CTL_CAP, "burst": 2.0 * CTL_CAP}}
CTL_DEFER = {"name": "token_bucket",
             "options": {"rate": 0.8 * CTL_CAP, "burst": 2.0 * CTL_CAP,
                         "defer": True, "backlog_cap": 23.5}}
CTL_CLOSED = {"name": "closed_loop", "options": {"users": 20,
                                                 "think_time": 2.7}}


def ctl_cfgs(horizon, warmup):
    """The reference's and the port's `SimConfig` of the control replays:
    Topology(`CTL_SERVERS`, 4) at `CTL_RATES`, p_hot 0.5, `CTL_BATCH`
    lanes."""
    from repro.core import locality as rloc, simulator as rsim
    from repro_torch.core import locality as loc, simulator as sim
    kw = dict(p_hot=0.5, max_arrivals=CTL_BATCH, horizon=horizon,
              warmup=warmup)
    return (rsim.SimConfig(rloc.Topology(CTL_SERVERS, 4),
                           rloc.Rates(CTL_RATES), **kw),
            sim.SimConfig(loc.Topology(CTL_SERVERS, 4), loc.Rates(CTL_RATES),
                          **kw))


def users_wave(pkg):
    """A closed-loop population that grows, then shrinks (lam_mult 1);
    `pkg` the reference's or the port's `workloads`."""
    return pkg.Scenario("users_wave", (
        pkg.Segment(0.0), pkg.Segment(0.35, users_mult=1.7),
        pkg.Segment(0.7, users_mult=0.55)))


def ctl_policy(name):
    """The port's and the reference's `PolicyConfig` of `name`
    (SLO-PANDAS at slo_target 2)."""
    from repro.core.policy import PolicyConfig as RPolicyConfig
    from repro_torch.core.policy import PolicyConfig
    opts = {"slo_target": 2.0} if name == "slo_pandas" else {}
    return PolicyConfig(name, opts), RPolicyConfig(name, opts)


def ctl_replay(name, cfg, cells, ctl, lam_mult=None, rep=None):
    """The reference's draws of `cells` under the port's plane `ctl`
    (its count law), `lam_mult` the (horizon,) multiplier a slot, with
    the chunk reads of the port's `SimReplication` `rep` when engaged."""
    law = ctl.count_law()
    return JaxDenseReplay(name, cells, CTL_BATCH, cfg.topo.num_servers,
                          cfg.horizon, lam_mult=lam_mult,
                          extra=law.get("extra_mult", 1.0),
                          think=law.get("users"),
                          reads=None if rep is None
                          else (rep.C, rep.ctrl.read_skew))


def replay_control(monkeypatch, name, control, rho, telemetry=None,
                   scenario=None, replication=None, horizon=120, warmup=30,
                   seed=2):
    """Run `control` on policy `name` at ``rho * CTL_CAP`` in both
    packages under the reference's draws, and hold the port's `CtlState`
    and policy state (and with `replication`, its lifecycle state)
    against the reference's after every slot (read out of its compiled
    scan around `SimControl.pre`, the policy's `slot_step` and
    `SimReplication.step`) and its final metrics against the reference's
    `simulate` (``mean_delay`` as the two float32 divisions of the
    reference's compiled sweep, one ulp at most from its `simulate`).
    `scenario` is None or a function of a `workloads` package.  Returns
    the reference's metrics and its `CtlState` after each slot (numpy)."""
    from repro import workloads as rwl
    from repro.control import simproj as rsimproj
    from repro.core import balanced_pandas as rbp
    from repro.core import simulator as rsim
    from repro.core import slo_pandas as rslo
    from repro.replication import simproj as rrepsim
    from repro_torch import workloads as wl
    from repro_torch.core import simulator as sim

    rcfg, cfg = ctl_cfgs(horizon, warmup)
    lam = np.float32(rho * CTL_CAP)
    est = rsim.make_estimates(rcfg, "per_server", 0.2, -1, seed=1)
    pol, rpol = ctl_policy(name)
    r_pre, r_slot, r_rep = [], [], []
    read_out_of_scan(monkeypatch, rsimproj.SimControl, "pre", r_pre)
    rcls = rslo.SloPandasPolicy if name == "slo_pandas" else \
        rbp.BalancedPandasPolicy
    read_out_of_scan(monkeypatch, rcls, "slot_step", r_slot)
    read_out_of_scan(monkeypatch, rrepsim.SimReplication, "step", r_rep)
    want = rsim.simulate(rpol, rcfg, lam, est, seed=seed,
                         telemetry=telemetry, control=control,
                         replication=replication,
                         scenario=None if scenario is None
                         else scenario(rwl))
    jax.effects_barrier()
    assert len(r_pre) == len(r_slot) == horizon
    assert len(r_rep) == (0 if replication is None else horizon)

    sched = wl.compile_schedule(wl.make_scenario(
        None if scenario is None else scenario(wl)), cfg.topo, horizon,
        0.5, device="cpu")
    ctl = sim.build_control(control, cfg, sched, "cpu")
    lam_t = torch.tensor([lam])
    policy, init, step, rep, tel = sim._build_dense_step(
        pol, cfg, torch.as_tensor(est)[None], "cpu", sched, None,
        replication, telemetry, ctl, lam_t)
    assert (rep is None) == (replication is None)
    i_ctl = 4 + (rep is not None)
    track = None if sched.lam_mult is None or sched.num_segments == 1 else \
        sched.lam_mult[sched.seg].cpu().numpy()
    src = ctl_replay(name, cfg, [(seed, lam)], ctl, track, rep)
    carry = init()
    for t in range(horizon):
        carry = step(carry, t, src.slot(t))
        for field, got, ref in zip(carry[i_ctl]._fields, carry[i_ctl],
                                   r_pre[t][0]):
            np.testing.assert_array_equal(got[0].numpy(), ref,
                                          err_msg=f"{field} at slot {t}")
        if rep is not None:
            for field, got, ref in zip(carry[4]._fields, carry[4],
                                       r_rep[t][0]):
                np.testing.assert_array_equal(got[0].numpy(), ref,
                                              err_msg=f"{field} at slot {t}")
        for field, got, ref in zip(carry[0]._fields, carry[0],
                                   r_slot[t][0]):
            np.testing.assert_array_equal(got[0].numpy(), ref,
                                          err_msg=f"{field} at slot {t}")
    lam_scale = wl.mean_lam_mult_over(sched, warmup, horizon)
    got = sim._dense_metrics(policy, carry, lam_t * lam_scale, rep, tel, ctl)
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "mean_delay":
            np.testing.assert_array_equal(got[k][0], v, err_msg=k)
    # Little's law over the admitted rate, two float32 divisions as the
    # reference's compiled sweep forms it (its compiled simulate rewrites
    # a / (b / c) as (a * c) / b: at most one ulp apart)
    rate = np.float32(want["ctl_admitted"]) / np.float32(horizon - warmup)
    np.testing.assert_array_equal(got["mean_delay"][0],
                                  np.float32(want["mean_n"]) / rate)
    assert abs(got["mean_delay"][0] - want["mean_delay"]) <= np.spacing(
        np.float32(want["mean_delay"]))
    return want, [st[0] for st in r_pre]
