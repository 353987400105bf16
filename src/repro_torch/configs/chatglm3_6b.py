"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE applied to half the head dims ("2d" RoPE), GQA.
[arXiv:2406.12793; hf THUDM/chatglm3-6b]
"""

from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    stages=uniform_stages(28, LayerSpec(kind="attn")),
    rope_theta=10_000.0,
    rope_fraction=0.5,   # chatglm rotary on half of head_dim
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.0625, layers=4 / 28, vocab=256)
