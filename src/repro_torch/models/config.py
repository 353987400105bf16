"""Model configuration system (counterpart of `repro.models.config`,
copied: plain dataclasses, no JAX).

A model is a stack of *stages*; each stage repeats a *block* of sub-layers
(`LayerSpec`s) with its parameters stacked along a leading axis.  This is
what lets heterogeneous architectures (uniform decoders, alternating
local/global attention, hybrids, encoder-decoder) share one layer
implementation with exact parameter counts.  The reference scans the
stacked axis; the port walks it with a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sub-layer of a block."""

    kind: str = "attn"          # "attn" | "mamba"
    window: int = 0             # sliding-window size; 0 = full attention
    moe: bool = False           # MoE MLP instead of dense
    cross: bool = False         # adds cross-attention (decoder of enc-dec)
    causal: bool = True         # False for encoder self-attention
    rope_theta: float = 0.0     # 0 -> use model default (gemma3 local layers
                                # override with a shorter theta)


@dataclasses.dataclass(frozen=True)
class Stage:
    """`repeats` copies of `block` with stacked params."""

    block: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.block) * self.repeats


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.5
    # "ep" shards the expert axis over the model mesh axis; "tp" shards the
    # per-expert ffn dim.  "auto" picks ep iff num_experts % model_axis == 0.
    sharding: str = "auto"
    # Below this many tokens, capacity = N (no drops): decode and small-batch
    # prefill stay exact; large training batches use capacity semantics.
    no_drop_threshold: int = 4096


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]                 # decoder / main stack
    enc_stages: Tuple[Stage, ...] = ()        # encoder stack (enc-dec only)

    # attention options
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0    # chatglm applies rotary to half the dims
    qk_norm: bool = False         # gemma3
    attn_softcap: float = 0.0     # gemma2
    attn_bias: bool = False       # qwen-family qkv bias
    attn_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    learned_pos: int = 0          # >0: learned positions (whisper), table size

    # output head
    final_softcap: float = 0.0    # gemma2 logit softcap
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: embeddings * sqrt(d_model)

    # substructure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    post_norm: bool = False       # gemma2/3 post-block norms
    act: str = "swiglu"           # swiglu | geglu | gelu

    # modality frontend (stub: inputs arrive as precomputed embeddings)
    frontend: str = "none"        # none | vision | audio
    num_frontend_tokens: int = 0  # vision: patch tokens prepended
    num_audio_frames: int = 0     # audio: encoder frames (whisper: 1500)

    dtype: str = "bfloat16"

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    @property
    def num_enc_layers(self) -> int:
        return sum(s.num_layers for s in self.enc_stages)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so logits/embedding shard over TP: odd
        vocabs (internvl2 92553, granite 49155, whisper 51865, mamba2 50280)
        otherwise replicate the CE one-hot across the model axis — measured
        +11 GB/device on internvl2 train_4k.  Rows >= vocab_size are masked
        to -inf in the head."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return bool(self.enc_stages)

    @property
    def attention_free(self) -> bool:
        return all(sl.kind != "attn" for st in self.stages for sl in st.block)

    @property
    def max_attention_window(self) -> int:
        """0 if any attention layer is full/global (unbounded cache)."""
        windows = [sl.window for st in self.stages for sl in st.block
                   if sl.kind == "attn"]
        if not windows:
            return -1  # attention-free
        return 0 if any(w == 0 for w in windows) else max(windows)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid or all-windowed attention."""
        return self.attention_free or self.max_attention_window > 0 or \
            self.family in ("ssm", "hybrid")

    def scaled(self, width: float = 1.0, layers: float = 1.0,
               vocab: int = 0) -> "ModelConfig":
        """Reduced copy for smoke tests: shrink width/depth/vocab but keep the
        structural pattern (block composition, MoE/SSM settings) intact."""
        def shrink_stage(s: Stage) -> Stage:
            return Stage(s.block, max(1, int(round(s.repeats * layers))))

        d = _round8(int(self.d_model * width))
        heads = max(1, int(self.num_heads * width))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = self.moe
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(
                ssm, d_state=max(8, _round8(int(ssm.d_state * width))),
                head_dim=max(8, _round8(int(ssm.head_dim * width))), chunk=32)
        return dataclasses.replace(
            self,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=max(8, _round8(int(self.head_dim * width))),
            d_ff=_round8(max(16, int(self.d_ff * width))) if self.d_ff else 0,
            vocab_size=vocab or self.vocab_size,
            stages=tuple(shrink_stage(s) for s in self.stages),
            enc_stages=tuple(shrink_stage(s) for s in self.enc_stages),
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            num_audio_frames=min(self.num_audio_frames, 16),
            learned_pos=min(self.learned_pos, 4096) if self.learned_pos else 0,
            moe=moe,
            ssm=ssm,
            dtype="float32",
        )


def _round8(x: int) -> int:
    return max(8, (x // 8) * 8)


def uniform_stages(num_layers: int, spec: LayerSpec) -> Tuple[Stage, ...]:
    return (Stage((spec,), num_layers),)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + all stages + head)."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += d * v
    total += d  # final norm
    if cfg.learned_pos:
        total += cfg.learned_pos * d

    def layer_params(sl: LayerSpec) -> int:
        n = 0
        if sl.kind == "attn":
            n += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
            if cfg.attn_bias:
                n += cfg.q_dim + 2 * cfg.kv_dim
            if cfg.qk_norm:
                n += 2 * cfg.head_dim
            if sl.cross:
                n += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                n += d  # cross-attn norm
        else:
            ssm = cfg.ssm
            din = ssm.d_inner(d)
            gn = ssm.n_groups * ssm.d_state
            h = ssm.num_heads(d)
            proj_out = 2 * din + 2 * gn + h
            n += d * proj_out                     # in_proj
            n += (din + 2 * gn) * ssm.conv_kernel  # conv
            n += 3 * h                            # A_log, D, dt_bias
            n += din                              # gated norm
            n += din * d                          # out_proj
        # mlp
        has_mlp = sl.moe or ff > 0
        if sl.moe:
            e = cfg.moe.num_experts
            n += d * e  # router
            n += e * (2 * d * ff + ff * d) if cfg.act in ("swiglu", "geglu") \
                else e * 2 * d * ff
        elif has_mlp:
            n += (2 * d * ff + ff * d) if cfg.act in ("swiglu", "geglu") \
                else 2 * d * ff
        # norms (pre attn/mlp [+post])
        n_norms = (2 if has_mlp else 1) * (2 if cfg.post_norm else 1)
        n += n_norms * d
        if cfg.norm == "layernorm":
            n += n_norms * d  # biases
        return n

    for st in cfg.stages + cfg.enc_stages:
        total += st.repeats * sum(layer_params(sl) for sl in st.block)
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of num_experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    full = param_count(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    per_expert = 3 * d * ff if cfg.act in ("swiglu", "geglu") else 2 * d * ff
    n_moe_layers = sum(st.repeats * sum(1 for sl in st.block if sl.moe)
                       for st in cfg.stages + cfg.enc_stages)
    inactive = (n_moe_layers * (cfg.moe.num_experts - cfg.moe.top_k)
                * per_expert)
    return full - inactive
