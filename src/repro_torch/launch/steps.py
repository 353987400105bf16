"""Train step of the port (counterpart of `repro.launch.steps`): the
runtime plan and `build_train_step`.

The reference's `build_train_step` closes over (cfg, mesh, policy) and
jits a step over sharded state; the port's closes over (cfg, plan,
device) and runs eagerly on one card:

  - the global batch is split into ``n_mb`` microbatches as the
    reference's ``to_microbatches`` splits it, ``reshape(mb, n_mb, ...)``
    then ``swapaxes(0, 1)``: microbatch j holds rows j, j + n_mb, ...;
  - each microbatch's gradients come from `torch.autograd.grad` of
    `transformer.lm_loss` (``impl="xla"``, the plan's ``remat``) and are
    added, cast to ``accum_dtype``, into one buffer a parameter (float32
    by default: ``.grad`` would accumulate in the parameter's dtype,
    bf16 at full width); each microbatch's own gradients are dropped once
    added; the sum is divided by ``n_mb`` and cast, as there;
  - `optim.adamw.update` then writes the new parameters and moments into
    the state's tensors (the reference donates its state to the jitted
    step: neither keeps two copies), and the buffers are freed.

`build_prefill_step` and `build_serve_step` are not ported (ROADMAP
Queue 1 item 11.6): the serving engine has its own steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models import params as params_lib, transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class RuntimePlan:
    """Per-(arch, shape) runtime knobs — see configs/runtime.py.  The
    reference's ``policy`` (sharding) and ``pin_gathers`` have no meaning
    on one card and are left out, and so is ``max_len`` (the decode cache
    length): only `build_prefill_step` and `build_serve_step` read it,
    and the port does not have them yet."""

    microbatches: int = 1
    accum_dtype: str = "float32"
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    remat: bool = True


def num_microbatches(plan: RuntimePlan, global_batch: int) -> int:
    """The reference's count at one data-parallel rank:
    ``min(plan.microbatches, global_batch)``, stepped down until it
    divides the batch."""
    n_mb = max(1, min(plan.microbatches, global_batch))
    while global_batch % n_mb:
        n_mb -= 1
    return n_mb


def microbatch(x: torch.Tensor, n_mb: int, j: int) -> torch.Tensor:
    """Microbatch `j` of `n_mb` as the reference's ``to_microbatches``
    cuts it: ``reshape(mb, n_mb, ...)``, then ``swapaxes(0, 1)``, so rows
    j, j + n_mb, ... (a view)."""
    return x.reshape((x.shape[0] // n_mb, n_mb) + tuple(x.shape[1:]))[:, j]


def abstract_state(cfg: ModelConfig, plan: RuntimePlan) -> TrainState:
    """The train state's shapes and dtypes on the ``meta`` device."""
    aparams = params_lib.abstract_params(cfg)
    return TrainState(params=aparams,
                      opt=adamw.abstract_state(plan.opt, aparams),
                      step=torch.empty((), dtype=torch.int32, device="meta"))


def build_train_step(cfg: ModelConfig, plan: RuntimePlan, global_batch: int,
                     seq_len: int, device=None):
    """Returns (step_fn, abstract_state, abstract_batch).

    step_fn(state, batch) -> (state, metrics): `batch` holds ``tokens``
    and ``labels`` (global_batch, seq_len) integer arrays or tensors
    (moved to the device); `state` is updated in place and returned with
    its step count advanced; metrics are the reference's ``loss``,
    ``grad_norm`` and ``lr``, float32 tensors on the device (no host
    read).  `device` None means the card.
    """
    from repro_torch.configs.shapes import RunShape, input_specs

    dev = resolve_device(device)
    n_mb = num_microbatches(plan, global_batch)
    adt = torch_dtype(plan.accum_dtype)
    abstract_batch = input_specs(
        cfg, RunShape("train", "train", seq_len, global_batch))

    def loss_fn(params, mb_batch):
        return T.lm_loss(params, cfg, mb_batch, remat=plan.remat)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        leaves = params_lib.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("tokens", "labels")}
        if n_mb == 1:
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        else:
            acc = [torch.zeros(p.shape, dtype=adt, device=dev)
                   for p in leaves]
            loss = None
            for j in range(n_mb):
                l_j, _ = loss_fn(params, {k: microbatch(v, n_mb, j)
                                          for k, v in batch.items()})
                g_j = torch.autograd.grad(l_j, leaves)
                for a, g in zip(acc, g_j):
                    a.add_(g.to(adt))
                del g_j
                loss = l_j.detach() if loss is None else loss + l_j.detach()
            for a in acc:
                a.div_(n_mb)
            grads = acc
            loss = loss / n_mb
        # the float32 buffers are freed when the step returns
        _, new_opt, opt_metrics = adamw.update(
            plan.opt, _unflatten(params, iter(grads)), state.opt, params)
        metrics = {"loss": loss, **opt_metrics}
        return TrainState(params, new_opt, state.step + 1), metrics

    return train_step, abstract_state(cfg, plan), abstract_batch


def _unflatten(tree, leaves):
    """An iterator of leaves (in `params.tree_leaves` order) in the
    structure of `tree`."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
