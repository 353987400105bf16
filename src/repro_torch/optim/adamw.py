"""AdamW of the port (counterpart of `repro.optim.adamw`): plain functions
over the port's parameter tree, updating it and the moments in place.

Optimizer state mirrors the parameter tree (same keys, same shapes).
`moment_dtype` trades memory for precision: the >= 100B configs keep bf16
moments, everything else float32; `update_dtype` is the dtype of the
update arithmetic, as the reference's compiled step rounds it.  As in
the reference: the gradients are clipped by their global norm, a
parameter whose stored tensor has fewer than two dimensions takes no
weight decay (the stacked per-stage norm scales have two, as there), and
the new parameter is cast back to its own dtype.

`torch.optim.AdamW` is not used: it clips nothing, decays every tensor
it is given and keeps its moments in the parameter's dtype.  The
reference returns new trees (its train step donates the old ones); the
port writes the new values into the parameters and moments it is given,
so a step needs no second copy of the state.  Elementwise work runs over
slices of at most `CHUNK` elements, which bounds the float32 temporaries
of a stacked tensor without changing a value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import tree_leaves, tree_map

CHUNK = 1 << 25  # elements per slice of the elementwise update


class AdamWState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # dtype of the update arithmetic (bf16 for the >= 100B models, as
    # there; `CHUNK` bounds the float32 temporaries either way)
    update_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float) -> float:
    """`x` rounded to float32 (exact as a Python float)."""
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32, in the form of the reference's compiled
    float32: XLA fuses the first product of a sum into a multiply-add,
    which rounds once.  Here the product is exact in float64 and the sum
    is rounded twice, to float64 and then to float32.  That differs from
    one rounding only where the float64 sum lands exactly on a float32
    halfway point while the exact one does not (an ulp, rarely: no element
    of a million in tools/xla_adamw_forms.py)."""
    return (a.double() * torch.as_tensor(b).double()
            + c.double()).to(torch.float32)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * peak; float32, in
    the reference's compiled form: each division by a constant is a
    product with the float32 constant XLA folds, and the cosine's scale
    is fused into its sum."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step * _f32(_f32(cfg.peak_lr) / _f32(max(cfg.warmup_steps, 1)))
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        * _f32(1.0 / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1))),
        0.0, 1.0)
    cos = _fma(torch.full_like(prog, (1 - cfg.min_lr_frac) * 0.5),
               1 + torch.cos(math.pi * prog),
               torch.full_like(prog, cfg.min_lr_frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments beside each parameter (its device, `moment_dtype`)."""
    dt = torch_dtype(cfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def abstract_state(cfg: AdamWConfig, abstract_params: Any) -> AdamWState:
    """Shapes and dtypes of `init`'s state on the ``meta`` device (no
    memory); `abstract_params` may hold tensors on any device."""
    dt = torch_dtype(cfg.moment_dtype)
    z = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return AdamWState(count=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(z, abstract_params),
                      nu=tree_map(z, abstract_params))


def _slices(*tensors) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of at most CHUNK elements of contiguous
    tensors of one shape (views: writes reach the tensors)."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for lo in range(0, n, CHUNK):
        yield tuple(f[lo:lo + CHUNK] for f in flat)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(
        sum(torch.sum(torch.square(c.to(torch.float32)))
            for (c,) in _slices(g.contiguous()))
        for g in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any,
           lr: Optional[torch.Tensor] = None):
    """One AdamW step.  Writes the new parameters into `params` and the new
    moments into ``state.mu``/``state.nu``; returns (params, new_state,
    metrics) with the reference's metrics ``grad_norm`` and ``lr``
    (float32 tensors on the parameters' device)."""
    count = state.count + 1
    if lr is None:
        lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    dev = gnorm.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    # a true division: torch's ``c / t`` is ``t.reciprocal() * c``
    scale = torch.clamp(f32(cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else f32(1.0)
    udt = torch_dtype(cfg.update_dtype)
    # the constants in the update dtype, as the reference's weakly typed
    # Python floats become (torch would take them in float32)
    u = lambda x: torch.tensor(x, dtype=udt, device=dev)
    b1, b2, nb1, nb2 = u(cfg.b1), u(cfg.b2), u(1 - cfg.b1), u(1 - cfg.b2)
    wd, eps2 = u(cfg.weight_decay), u(cfg.eps ** 2)
    c = count.to(torch.float32)
    bc1 = (1 - torch.pow(cfg.b1, c)).to(udt)
    bc2 = (1 - torch.pow(cfg.b2, c)).to(udt)
    scale_u, lr_u = scale.to(udt), lr.to(udt)

    # float32 follows the reference's compiled multiply-adds (`_fma`);
    # bf16 rounds every step, as the reference's compiled bf16 rounds its
    # moments (float32 intermediates put them up to 23 bf16 ulps apart)
    madd = _fma if udt == torch.float32 else lambda a, b, c: a * b + c
    g_l, m_l, v_l, p_l = (tree_leaves(t) for t in
                          (grads, state.mu, state.nu, params))
    for g, m, v, p in zip(g_l, m_l, v_l, p_l):
        decay = cfg.weight_decay > 0 and p.ndim >= 2  # no decay on 1-d
        for gs, ms, vs, ps in _slices(g.contiguous(), m, v, p):
            gu = gs.to(udt) * scale_u
            mu = madd(b1, ms.to(udt), nb1 * gu)
            nu = madd(b2, vs.to(udt), nb2 * torch.square(gu))
            t1 = mu / bc1
            r = torch.rsqrt(torch.maximum(nu / bc2, eps2))
            step = madd(t1, r, wd * ps.to(udt)) if decay else t1 * r
            ps.copy_(madd(-lr_u, step, ps.to(udt)).to(ps.dtype))
            ms.copy_(mu.to(ms.dtype))
            vs.copy_(nu.to(vs.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(count, state.mu, state.nu), metrics
