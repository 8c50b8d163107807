"""Architecture registry: arch id -> (full config, smoke config)."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, *, smoke: bool = False, **overrides):
    if arch not in _ARCH_MODULES:
        raise ValueError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
