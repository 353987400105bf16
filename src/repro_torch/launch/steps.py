"""Step builders of the port (counterpart of `repro.launch.steps`): the
runtime plan, `build_train_step`, `build_prefill_step` and
`build_serve_step`.

The reference's `build_train_step` closes over (cfg, mesh, policy) and
jits a step over sharded state; the port's closes over (cfg, plan,
device) and runs eagerly on one card:

  - the global batch — every key of it: ``tokens``, ``labels`` and an
    encoder-decoder's ``frames`` or a vision model's ``frontend`` — is
    split into ``n_mb`` microbatches as the reference's
    ``to_microbatches`` splits it, ``reshape(mb, n_mb, ...)`` then
    ``swapaxes(0, 1)``: microbatch j holds rows j, j + n_mb, ...;
  - each microbatch's gradients come from `torch.autograd.grad` of
    `transformer.lm_loss` (``impl="xla"``, the plan's ``remat``) and are
    added, cast to ``accum_dtype``, into one buffer a parameter (float32
    by default: ``.grad`` would accumulate in the parameter's dtype,
    bf16 at full width); each microbatch's own gradients are dropped once
    added; the sum is divided by ``n_mb`` and cast, as there;
  - `optim.adamw.update` then writes the new parameters and moments into
    the state's tensors (the reference donates its state to the jitted
    step: neither keeps two copies), and the buffers are freed.

`build_prefill_step` and `build_serve_step` are the reference's
batched prefill (the encoder first, then `forward` with ``frontend``,
``enc_out`` and caches) and one decode step (`decode_step`, then the
argmax).  On one card the reference's mesh, shardings, donation and
``aligned_decode`` (a mesh-sharded in-place cache write) have no
meaning: the port's steps run eagerly and write the caches in place.
The prefill goes through the model's kernel route, as the serving
engine's does: ``impl="pallas_ssd"`` (the SSD kernel) when the model has
a Mamba layer, ``impl="pallas"`` (flash attention) otherwise, where the
reference's prefill step takes its plain route.
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
    on one card and are left out."""

    microbatches: int = 1
    accum_dtype: str = "float32"
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    remat: bool = True
    max_len: int = 0  # decode cache length (shape.seq_len)


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
    and ``labels`` (global_batch, seq_len) integer arrays or tensors, and
    ``frames`` or ``frontend`` where the model reads them (every key is
    moved to the device and microbatched); `state` is updated in place
    and returned with
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
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
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


def build_prefill_step(cfg: ModelConfig, plan: RuntimePlan, batch: int,
                       seq_len: int, device=None):
    """Returns (prefill_fn, (abstract_params, abstract_caches,
    abstract_batch)).

    prefill_fn(params, caches, batch) -> (logits of the last row (B, V)
    float32, caches): `batch` holds ``tokens`` (B, T) and ``frames`` or
    ``frontend`` where the model reads them (moved to the device); the
    encoder runs first, then `forward` at positions ``arange`` over the
    whole stream (frontend rows included), through the kernel route.
    The caches (`init_caches` of ``plan.max_len`` or `seq_len` slots
    and, for an encoder-decoder, ``num_audio_frames`` cross rows) are
    written in place and returned.  Nothing is recorded for autograd.
    `device` None means the card.
    """
    from repro_torch.configs.shapes import RunShape, input_specs

    dev = resolve_device(device)
    max_len = plan.max_len or seq_len
    impl = T.prefill_impl(cfg)
    acaches = T.abstract_caches(cfg, batch, max_len,
                                enc_len=cfg.num_audio_frames)
    abstract_batch = input_specs(
        cfg, RunShape("prefill", "prefill", seq_len, batch))

    @torch.no_grad()
    def prefill(params, caches, batch_in):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch_in.items()}
        enc_out = None
        if cfg.is_encdec:
            enc_out = T.encode(params, cfg, b["frames"], impl=impl)
        logits, caches, _ = T.forward(
            params, cfg, b["tokens"], frontend=b.get("frontend"),
            enc_out=enc_out, caches=caches, impl=impl)
        return logits[:, -1], caches

    return prefill, (params_lib.abstract_params(cfg), acaches,
                     abstract_batch)


def build_serve_step(cfg: ModelConfig, plan: RuntimePlan, batch: int,
                     max_len: int, device=None):
    """Returns (serve_fn, (abstract_params, abstract_caches,
    abstract_batch)).

    serve_fn(params, caches, batch) -> (next_token (B,) int32, logits
    (B, V) float32, caches): one `decode_step` of ``tokens`` (B, 1) at
    ``lengths`` (B,), then the argmax; the caches are written in place.
    A model with learned positions refuses a `max_len` past its table
    (``learned_pos`` rows), where the reference would clamp the position.
    `device` None means the card.
    """
    from repro_torch.configs.shapes import RunShape, input_specs

    if cfg.learned_pos and max_len > cfg.learned_pos:
        raise ValueError(f"{cfg.name}: a cache of {max_len} positions "
                         f"passes the learned-position table of "
                         f"{cfg.learned_pos} rows")
    dev = resolve_device(device)
    acaches = T.abstract_caches(cfg, batch, max_len,
                                enc_len=cfg.num_audio_frames)
    abstract_batch = input_specs(
        cfg, RunShape("decode", "decode", max_len, batch))

    @torch.no_grad()
    def serve(params, caches, batch_in):
        logits, caches = T.decode_step(
            params, cfg, torch.as_tensor(batch_in["tokens"], device=dev),
            torch.as_tensor(batch_in["lengths"], device=dev), caches)
        next_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return next_tok, logits[:, 0], caches

    return serve, (params_lib.abstract_params(cfg), acaches, abstract_batch)


def _unflatten(tree, leaves):
    """An iterator of leaves (in `params.tree_leaves` order) in the
    structure of `tree`."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
