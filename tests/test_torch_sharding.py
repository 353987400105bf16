"""The port's sharding rules (`sharding.rules`, `launch.mesh`, the step
helpers) against the reference's:

  * `make_rules` gives the reference's table for every policy, expert
    count and model-axis size;
  * `params.logical_axes` and `transformer.cache_axes` are the
    reference's trees for all ten architectures;
  * `ShardCtx.spec` through `steps.make_ctx`, `param_shardings` and
    `tree_axes_to_shardings` gives the reference's `PartitionSpec`s, read
    as tuples, for every parameter and cache leaf of each smoke config on
    the meshes (2, 4), (4, 2) and (1, 8); `effective_kv_heads` is the
    reference's there.  The reference's side runs in a subprocess with 8
    host devices, as tests/test_distributed.py runs it;
  * on one card (`mesh.single_card_mesh`) `effective_kv_heads` is None
    for every architecture and `constrain` is the identity.
"""

import itertools
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import params as RP, transformer as RT
from repro.sharding import rules as rrules
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib, steps
from repro_torch.models import params as P, transformer as T
from repro_torch.sharding import rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 4), (4, 2), (1, 8))
BATCH, MAX_LEN = 8, 64


def _policies():
    for fsdp, ep, seq, dp in itertools.product(
            (True, False), ("auto", "ep", "tp"), (False, True),
            (("data",), ("pod", "data"))):
        yield dict(fsdp=fsdp, expert_parallel=ep, seq_shard_cache=seq,
                   dp_axes=dp)


def test_make_rules_is_the_reference_table():
    for kw in _policies():
        for e, tp in itertools.product((0, 8, 16, 32), (1, 2, 4, 16)):
            got = rules.make_rules(rules.ShardingPolicy(**kw), num_experts=e,
                                   model_axis_size=tp)
            want = rrules.make_rules(rrules.ShardingPolicy(**kw),
                                     num_experts=e, model_axis_size=tp)
            assert got == want, (kw, e, tp)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_logical_and_cache_axes_are_the_reference_trees(arch):
    cfg, rcfg = registry.get_config(arch), rregistry.get_config(arch)
    assert P.logical_axes(cfg) == RP.logical_axes(rcfg)
    assert T.cache_axes(cfg) == RT.cache_axes(rcfg)
    smoke = registry.get_smoke_config(arch)
    assert P.logical_axes(smoke) == RP.logical_axes(
        rregistry.get_smoke_config(arch))


_REFERENCE_SPECS = """
    import json, jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.launch import steps
    from repro.models import transformer as T
    from repro.sharding.rules import ShardingPolicy, tree_axes_to_shardings

    def spec_tree(tree):
        if isinstance(tree, dict):
            return {k: spec_tree(v) for k, v in tree.items()}
        return [list(p) if isinstance(p, tuple) and len(p) > 1
                else p[0] if isinstance(p, tuple) else p for p in tree.spec]

    out = {}
    for arch in registry.ARCH_IDS:
        cfg = registry.get_smoke_config(arch)
        for shape in %(meshes)r:
            devs = np.asarray(jax.devices()[:8]).reshape(shape)
            mesh = Mesh(devs, ("data", "model"))
            ctx = steps.make_ctx(cfg, mesh, ShardingPolicy())
            caches = T.abstract_caches(cfg, %(b)d, %(l)d,
                                       enc_len=cfg.num_audio_frames)
            out[f"{arch} {shape}"] = {
                "params": spec_tree(steps.param_shardings(cfg, ctx)),
                "caches": spec_tree(tree_axes_to_shardings(
                    ctx, caches, T.cache_axes(cfg))),
                "kv_heads": steps.effective_kv_heads(cfg, ctx)}
    print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = textwrap.dedent(_REFERENCE_SPECS) % dict(
        meshes=MESHES, b=BATCH, l=MAX_LEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("SPECS")][0]
    return json.loads(line[len("SPECS"):])


def _as_json(tree):
    """A spec tree as the reference's reads in JSON: a `PartitionSpec`
    entry of one mesh axis reads as its name, ("data",) as "data"."""
    if isinstance(tree, dict):
        return {k: _as_json(v) for k, v in tree.items()}
    return [list(p) if isinstance(p, tuple) and len(p) > 1
            else p[0] if isinstance(p, tuple) else p for p in tree]


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_are_the_reference_partition_specs(arch, reference_specs):
    cfg = registry.get_smoke_config(arch)
    caches = T.abstract_caches(cfg, BATCH, MAX_LEN,
                               enc_len=cfg.num_audio_frames)
    for data, model in MESHES:
        ctx = steps.make_ctx(cfg, {"data": data, "model": model})
        got = {"params": _as_json(steps.param_shardings(cfg, ctx)),
               "caches": _as_json(rules.tree_axes_to_shardings(
                   ctx, caches, T.cache_axes(cfg))),
               "kv_heads": steps.effective_kv_heads(cfg, ctx)}
        assert got == reference_specs[f"{arch} {(data, model)}"], (
            arch, (data, model))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_one_card_shards_nothing(arch):
    cfg = registry.get_config(arch)
    mesh = mesh_lib.single_card_mesh()
    assert mesh == {"data": 1, "model": 1}
    assert (mesh_lib.dp_axes(mesh), mesh_lib.dp_size(mesh),
            mesh_lib.model_axis_size(mesh)) == (("data",), 1, 1)
    ctx = steps.make_ctx(cfg)
    assert steps.effective_kv_heads(cfg, ctx) is None
    x = torch.empty(2, 3)
    assert ctx.constrain(x, ("act_batch", None)) is x
    with pytest.raises(ValueError):
        ctx.constrain(x, ("act_batch",))
