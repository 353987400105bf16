"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
(per-expert) vocab=49155, MoE 32 experts top-8, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

The reference shards the 32 experts over its 16 model shards (expert
parallelism); the port runs all of them on one card.
"""

from repro_torch.models.config import (LayerSpec, MoEConfig, ModelConfig,
                                       uniform_stages)

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    stages=uniform_stages(24, LayerSpec(kind="attn", moe=True)),
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=32, top_k=8),
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.25, layers=4 / 24, vocab=256)
