"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local(512-window):global pattern, qk-norm, tied
embeddings, GeGLU.  [hf:google/gemma-3-1b-pt]
"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage

_LOCAL = LayerSpec(kind="attn", window=512, rope_theta=10_000.0)
_GLOBAL = LayerSpec(kind="attn", window=0, rope_theta=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    # 26 layers: 4 full (5 local + 1 global) cycles + 2 trailing local.
    stages=(Stage((_LOCAL,) * 5 + (_GLOBAL,), 4), Stage((_LOCAL,), 2)),
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    post_norm=True,
    norm="rmsnorm",
    act="geglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.25, layers=1 / 4, vocab=512)
