"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free, ssm_state=128,
vocab=50280 — SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads/layer.
"""

from repro_torch.models.config import (LayerSpec, ModelConfig, SSMConfig,
                                       uniform_stages)

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    stages=uniform_stages(48, LayerSpec(kind="mamba")),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4),
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.125, layers=4 / 48, vocab=256)
