"""Architecture registry: arch id -> (full config, smoke config)."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, *, smoke: bool = False, **overrides):
    if arch not in _ARCH_MODULES:
        raise ValueError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
