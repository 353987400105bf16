"""The port's roofline (`utils.roofline`) against the reference's:

  * `attention_flops` and `model_flops` equal the reference's for all
    ten architectures x the four shapes, and so do `launch.dryrun`'s
    model FLOPs and model bytes (the reference's `run_cell` formulas,
    decode cache bytes from its `abstract_caches`);
  * `Roofline` computes the reference's terms, keys and fractions with
    the H100's rates in place of the v5e's;
  * `attention_cost` and `ssd_cost` give the bounds `chip_smoke.py`
    printed before they moved (copies of its `_attn_bound` and
    `_ssd_bound` below), bit for bit.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.configs.shapes import SHAPES as RSHAPES
from repro.models import transformer as RT
from repro.models.config import active_param_count, param_count
from repro.utils import roofline as rrl
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.utils import roofline as rl


def _reference_terms(cfg, shape):
    """The reference's `run_cell` model FLOPs and model bytes, one
    device."""
    n_active = active_param_count(cfg)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * t
        attn = rrl.attention_flops("train", cfg, t, b)
    elif shape.kind == "prefill":
        tokens = b * t
        attn = rrl.attention_flops("serve", cfg, t, b)
    else:
        tokens = b
        attn = rrl.attention_flops("serve", cfg, t, b, decode=True)
    mflops = rrl.model_flops("train" if shape.kind == "train" else "serve",
                             n_active, tokens, attn)
    p_bytes = 2.0 * param_count(cfg)
    act_stream = 2.0 * tokens * cfg.d_model * max(cfg.num_layers, 1) * 2
    if shape.kind == "train":
        return mflops, 3.0 * p_bytes + 2.0 * act_stream
    if shape.kind == "prefill":
        return mflops, p_bytes + act_stream
    caches = RT.abstract_caches(cfg, b, t, enc_len=cfg.num_audio_frames)
    cache_b = float(sum(np.prod(x.shape) * x.dtype.itemsize
                        for x in jax.tree.leaves(caches)))
    return mflops, p_bytes + cache_b + 2.0 * tokens * cfg.d_model * 2


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_formulas_are_the_reference_formulas(arch):
    cfg, rcfg = registry.get_config(arch), rregistry.get_config(arch)
    for name, shape in SHAPES.items():
        b, t = shape.global_batch, shape.seq_len
        for kind, decode in (("train", False), ("serve", False),
                             ("serve", True)):
            assert rl.attention_flops(kind, cfg, t, b, decode) == \
                rrl.attention_flops(kind, rcfg, t, b, decode)
        assert rl.model_flops("train", 1.5e9, b * t, 7.0) == \
            rrl.model_flops("train", 1.5e9, b * t, 7.0)
        assert dryrun.model_terms(cfg, shape) == _reference_terms(
            rcfg, RSHAPES[name])


def test_roofline_is_the_reference_model_at_h100_rates(monkeypatch):
    for name, val in (("PEAK_FLOPS", rl.PEAK_FLOPS), ("HBM_BW", rl.HBM_BW),
                      ("ICI_BW", rl.ICI_BW), ("DCN_BW", rl.DCN_BW)):
        monkeypatch.setattr(rrl, name, val)
    for args in itertools.product((0.0, 3.1e15), (0.0, 2.2e11),
                                  (0.0, 4.0e8), (0.0, 1.0e7),
                                  (0.0, 1.9e15), (0.0, 6.6e10)):
        assert rl.Roofline(*args).as_dict() == rrl.Roofline(*args).as_dict()
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.HBM_PER_CARD) == (989e12, 3.35e12,
                                                           80e9)
    one_card = rl.Roofline(1e11, 1e9, 0.0)
    assert one_card.collective_s == 0.0 and one_card.dominant == "memory"


# chip_smoke.py's bounds as they stood before they moved into
# utils.roofline: the constants and functions verbatim
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
F32_SPLIT_OPS_PER_S = TF32_OPS_PER_S / 3
SSD_CHUNK = 128


def _attn_bound(shape, causal, window, dtype):
    b, hq, hkv, tq, tk, d = shape
    qpos = np.arange(tq) + (tk - tq)
    hi = np.minimum(tk, qpos + 1) if causal else np.full(tq, tk)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(tq)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4 * d * pairs * b * hq
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * b * hq * tq * d + 2 * b * hkv * tk * d)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_SPLIT_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _ssd_bound(shape, dtype):
    bsz, t, h, p, n = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * (2 * bsz * t * h * p + 2 * bsz * t * n)
              + 4 * bsz * t * h + 2 * 4 * bsz * h * p * n)
    lt = min(SSD_CHUNK, t)
    chunks = -(-t // lt)
    flops = bsz * chunks * (2 * lt * lt * n
                            + h * (2 * lt * lt * p + 4 * lt * p * n))
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_SPLIT_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def test_kernel_costs_are_the_bounds_chip_smoke_printed():
    rng = np.random.default_rng(0)
    attn = [(1, 32, 2, 128, 128, 128), (1, 32, 2, 8192, 8192, 128),
            (4, 16, 8, 320, 320, 128), (1, 4, 4, 128, 128, 16),
            (4, 4, 1, 1024, 1024, 256)]
    attn += [tuple(int(x) for x in rng.integers(1, 300, 6)) for _ in range(20)]
    for shape, causal, window, dtype in itertools.product(
            attn, (True, False), (0, 64, 4096),
            (torch.bfloat16, torch.float32)):
        assert rl.attention_cost(shape, causal, window, dtype) == \
            _attn_bound(shape, causal, window, dtype)
    ssd = [(1, 128, 64, 64, 128), (4, 1024, 64, 64, 128),
           (2, 32, 32, 8, 8), (1, 8192, 64, 64, 128)]
    ssd += [tuple(int(x) for x in rng.integers(1, 300, 5)) for _ in range(20)]
    for shape, dtype in itertools.product(ssd, (torch.bfloat16,
                                                torch.float32)):
        assert rl.ssd_cost(shape, dtype) == _ssd_bound(shape, dtype)
