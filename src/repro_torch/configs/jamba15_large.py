"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2 — Mamba:attention 7:1
interleave (one attention layer per 8), MoE every other layer.
[arXiv:2403.19887]

Layer block (8 sub-layers, repeated 9x): Mamba at positions 0-3 and 5-7,
attention at position 4; MoE MLP at odd positions, dense MLP at even.
Jamba's Mamba-1 layers are modeled with Mamba-2 SSD blocks of matching
state size, as in the reference.
At full width one block of eight sub-layers holds 44.1B parameters (88
GB in bf16), more than one 80 GB card: the port runs it at
`smoke_config()`.
"""

from repro_torch.models.config import (LayerSpec, MoEConfig, ModelConfig,
                                       SSMConfig, Stage)


def _sub(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    return LayerSpec(kind=kind, moe=(i % 2 == 1))


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    stages=(Stage(tuple(_sub(i) for i in range(8)), 9),),
    rope_theta=10_000.0,
    rope_fraction=0.0,   # jamba attention uses no positional encoding
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4),
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=1 / 64, layers=1 / 9, vocab=256)
