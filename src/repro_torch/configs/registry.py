"""Architecture registry (counterpart of `repro.configs.registry`):
exact public configs, selectable via ``--arch <id>``.

Each ported ``<id>.py`` module defines ``CONFIG`` (exact) and
``smoke_config()`` (a reduced same-family config for CPU tests).  The
port serves the dense attention-only architectures, the Mamba-2 one and
the two MoE ones (granite-moe-1b, mixtral-8x22b); the other ids of the
reference raise `NotImplementedError` until their layers are ported
(whisper-medium's encoder-decoder, internvl2-2b's vision frontend,
jamba-1.5-large's hybrid Mamba/attention stack: the model-stack slice of
the port).
"""

from __future__ import annotations

import importlib

from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "chatglm3_6b",
    "gemma3_1b",
    "codeqwen15_7b",
    "gemma2_2b",
    "internvl2_2b",
    "jamba15_large",
    "whisper_medium",
    "mixtral_8x22b",
    "granite_moe_1b",
    "mamba2_13b",
)

# The ids whose layers the port has: dense attention, Mamba-2 only, or
# attention with MoE MLPs.
PORTED_IDS = ("chatglm3_6b", "gemma3_1b", "codeqwen15_7b", "gemma2_2b",
              "mixtral_8x22b", "granite_moe_1b", "mamba2_13b")

# What each id that still raises lacks.
MISSING = {
    "internvl2_2b": "the vision frontend",
    "jamba15_large": "the hybrid Mamba-2/attention stack",
    "whisper_medium": "the encoder-decoder (cross-attention, encoder, "
                      "learned positions)",
}

# Canonical external names <-> module ids.
ALIASES = {
    "chatglm3-6b": "chatglm3_6b",
    "gemma3-1b": "gemma3_1b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "gemma2-2b": "gemma2_2b",
    "internvl2-2b": "internvl2_2b",
    "jamba-1.5-large-398b": "jamba15_large",
    "whisper-medium": "whisper_medium",
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-1.3b": "mamba2_13b",
}


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    """The exact configs of the ported ids only (`PORTED_IDS`), where the
    reference's returns all of `ARCH_IDS`: the others raise."""
    return {a: get_config(a) for a in PORTED_IDS}


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED_IDS:
        raise NotImplementedError(
            f"arch {arch!r} needs {MISSING[arch]}, which the port does not "
            f"have yet (the model-stack slice of the port); ported: "
            f"{PORTED_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")
