"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — alternating local(4096):global attention, logit softcaps,
GeGLU, tied embeddings, post-norms.  [arXiv:2408.00118]
"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage

_LOCAL = LayerSpec(kind="attn", window=4096)
_GLOBAL = LayerSpec(kind="attn", window=0)

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    stages=(Stage((_LOCAL, _GLOBAL), 13),),
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    embed_scale=True,
    post_norm=True,
    norm="rmsnorm",
    act="geglu",
)


def smoke_config():
    return CONFIG.scaled(width=0.125, layers=2 / 13, vocab=512)
