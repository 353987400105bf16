"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096, per the
assignment sheet).  [arXiv:2401.04088]

Stage grouping (7 blocks of 8 scanned layers) doubles as the sqrt-remat
granularity for the 141B training memory budget.
At full width it holds 140.6B parameters (281 GB in bf16), more than one
80 GB card: the port runs it at `smoke_config()`.
"""

from repro_torch.models.config import LayerSpec, MoEConfig, ModelConfig, Stage

_L = LayerSpec(kind="attn", window=4096, moe=True)

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    stages=(Stage((_L,) * 8, 7),),
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2),
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=1 / 48, layers=2 / 7, vocab=256)
