"""internvl2-2b [vlm]: InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-1.8B backbone: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  [arXiv:2404.16821]

The 256 frontend rows go before the text tokens in one causal stream
(`transformer.forward(frontend=...)`).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, uniform_stages

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    stages=uniform_stages(24, LayerSpec(kind="attn")),
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    frontend="vision",
    num_frontend_tokens=256,  # 448px / 14 patches, 0.25x pixel shuffle
)


def smoke_config():
    return CONFIG.scaled(width=0.125, layers=4 / 24, vocab=256)
