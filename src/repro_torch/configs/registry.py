"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, glm4_9b, granite_moe_3b,
                                 hymba_1_5b, llava_next_mistral_7b,
                                 musicgen_medium, phi3_medium_14b,
                                 qwen2_5_14b, rwkv6_3b, stablelm_12b)
from repro_torch.configs.base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (glm4_9b, stablelm_12b, qwen2_5_14b, phi3_medium_14b,
              arctic_480b, granite_moe_3b, rwkv6_3b, musicgen_medium,
              hymba_1_5b, llava_next_mistral_7b)
}

ALIASES = {
    "glm4": "glm4-9b", "stablelm": "stablelm-12b", "qwen2.5-14b": "qwen2.5-14b",
    "qwen": "qwen2.5-14b", "phi3": "phi3-medium-14b", "arctic": "arctic-480b",
    "granite": "granite-moe-3b-a800m", "granite-moe-3b-a800m": "granite-moe-3b-a800m",
    "rwkv6": "rwkv6-3b", "musicgen": "musicgen-medium", "hymba": "hymba-1.5b",
    "llava": "llava-next-mistral-7b", "llava-next-mistral-7b": "llava-next-mistral-7b",
}


def get_arch(name: str) -> ArchConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]
