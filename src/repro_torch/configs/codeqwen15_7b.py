"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32 => MHA) d_ff=13440
vocab=92416 — qwen1.5 architecture (qkv bias, 64k context rope).
[hf:Qwen/CodeQwen1.5-7B]
"""

from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    stages=uniform_stages(32, LayerSpec(kind="attn")),
    rope_theta=1_000_000.0,
    attn_bias=True,
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.0625, layers=4 / 32, vocab=256)
