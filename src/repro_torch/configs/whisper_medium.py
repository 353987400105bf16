"""whisper-medium [audio]: encoder-decoder, 24L+24L d_model=1024 16H
(kv=16) d_ff=4096 vocab=51865 — conv audio frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings), LayerNorm,
GELU MLP, learned positions, decoder cross-attention.
[arXiv:2212.04356]

Whisper's real decoder context is 448; the assigned decode_32k shape
lowers a 32k-position decoder as specified (the positional table is
sized accordingly, 33024 rows).  A position at or past the table has no
row: `launch.steps.build_serve_step` refuses a longer cache.
"""

from repro_torch.models.config import LayerSpec, ModelConfig, Stage

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    enc_stages=(Stage((LayerSpec(kind="attn", causal=False),), 24),),
    stages=(Stage((LayerSpec(kind="attn", cross=True),), 24),),
    rope_fraction=0.0,
    learned_pos=33024,       # covers the assigned decode_32k cache length
    norm="layernorm",
    act="gelu",
    frontend="audio",
    num_audio_frames=1500,
)


def smoke_config():
    return CONFIG.scaled(width=0.125, layers=2 / 24, vocab=256)
