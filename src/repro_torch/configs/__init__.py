"""Assigned-architecture registry: ``get_config(arch_id, smoke=False)``.

Full configs are the published dimensions of each architecture (only
dimensions: nothing is downloaded); smoke configs are reduced same-family
variants for the CPU tests.  The same registry as ``repro.configs``.
"""
from __future__ import annotations

from repro_torch.utils.config import ModelConfig

from repro_torch.configs import (starcoder2_15b, internlm2_1_8b, minicpm3_4b,
                                 mistral_large_123b, whisper_large_v3,
                                 zamba2_2_7b, llama32_vision_90b, olmoe_1b_7b,
                                 qwen2_moe_a2_7b, mamba2_780m)

_MODULES = {
    "starcoder2-15b": starcoder2_15b,
    "internlm2-1.8b": internlm2_1_8b,
    "minicpm3-4b": minicpm3_4b,
    "mistral-large-123b": mistral_large_123b,
    "whisper-large-v3": whisper_large_v3,
    "zamba2-2.7b": zamba2_2_7b,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mamba2-780m": mamba2_780m,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; valid: {list(_MODULES)}")
    mod = _MODULES[arch]
    return mod.smoke_config() if smoke else mod.config()
