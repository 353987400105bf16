"""Logical-axis sharding rules (counterpart of `repro.sharding.rules`).

One rule table maps the logical axes declared beside every parameter
(`models.params.logical_axes`) and cache (`models.transformer.
cache_axes`) to mesh axes, with the reference's divisibility fallback:
a mesh axis that does not divide its dimension, or that an earlier
dimension already uses, leaves the dimension replicated.  The port runs
on one card (`launch.mesh.single_card_mesh()`), where every mesh axis
has size 1: every spec it gives there names axes of extent 1, so every
tensor is whole on the card, and `ShardCtx.constrain` is the identity.
The table and `ShardCtx.spec` are kept, the reference's for every
policy, expert count and mesh, so that what the reference would shard
on its meshes can be read, and checked, without JAX.

A spec is a tuple with one entry a dimension: None (replicated), a mesh
axis name, or a tuple of names — the entries of the reference's
`PartitionSpec`.

Left out: `ShardCtx.sharding` (a `NamedSharding`) — the port places no
tensor on a mesh; `tree_axes_to_shardings` gives the spec tuples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import MeshShape

AxisVal = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Per-run parallelism switches (the reference's; on one card none
    changes a spec's extent)."""

    fsdp: bool = True              # shard param embed-dim over data (ZeRO-3)
    expert_parallel: str = "auto"  # "auto" | "ep" | "tp"
    seq_shard_cache: bool = False  # SP: shard KV cache seq over DP axes
    dp_axes: Tuple[str, ...] = ("data",)   # ("pod","data") on multi-pod


def make_rules(policy: ShardingPolicy, *, num_experts: int = 0,
               model_axis_size: int = 1) -> Dict[Optional[str], AxisVal]:
    ep = (policy.expert_parallel == "ep" or
          (policy.expert_parallel == "auto" and num_experts > 0
           and num_experts % model_axis_size == 0))
    dp = tuple(policy.dp_axes)
    return {
        # parameters
        "vocab": "model",
        "embed": dp if policy.fsdp else None,
        "q_heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model" if ep else None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "conv": None,
        "pos": None,
        "layers": None,
        None: None,
        # activations
        "act_batch": dp,
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model" if ep else None,
        "act_cap": None if ep else dp,
        "act_cache": dp if policy.seq_shard_cache else None,
    }


class ShardCtx:
    """Threads (mesh axis sizes, rules) through the step builders."""

    def __init__(self, mesh_shape: MeshShape,
                 rules: Dict[Optional[str], AxisVal]):
        self.mesh_shape = dict(mesh_shape)
        self.rules = rules

    def spec(self, axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Tuple[AxisVal, ...]:
        """The spec of logical `axes` against `shape`, dropping any mesh
        axis that does not divide its dim or is already used."""
        used: set = set()
        parts = []
        for dim, ax in zip(shape, axes):
            val = self.rules.get(ax)
            if val is None:
                parts.append(None)
                continue
            mesh_axes = (val,) if isinstance(val, str) else tuple(val)
            if any(a in used for a in mesh_axes):
                parts.append(None)
                continue
            extent = math.prod(self.mesh_shape[a] for a in mesh_axes)
            if extent == 0 or dim % extent != 0:
                parts.append(None)
                continue
            used.update(mesh_axes)
            parts.append(val if isinstance(val, str) else tuple(val))
        return tuple(parts)

    def constrain(self, x: torch.Tensor, axes: Sequence[Optional[str]]):
        """The identity on one card (the reference's sharding constraint);
        checks that `axes` name every dimension."""
        if len(axes) != x.ndim:
            raise ValueError(f"axes {axes} vs shape {tuple(x.shape)}")
        return x


def tree_axes_to_shardings(ctx: ShardCtx, shape_tree, axes_tree):
    """The tree of specs for a tree of tensors (or anything with a
    ``shape``) and the parallel tree of logical-axis tuples."""
    if isinstance(shape_tree, dict):
        if not isinstance(axes_tree, dict) or set(axes_tree) != set(
                shape_tree):
            raise ValueError("axes tree does not match value tree")
        return {k: tree_axes_to_shardings(ctx, v, axes_tree[k])
                for k, v in shape_tree.items()}
    if not isinstance(axes_tree, tuple):
        raise ValueError("axes tree does not match value tree")
    return ctx.spec(axes_tree, tuple(shape_tree.shape))

