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

# ``repro``'s registry order, the order of its model-zoo table
_ZOO_ORDER = ("llava-next-34b", "gemma-7b", "minicpm3-4b", "qwen1.5-0.5b",
              "qwen2-0.5b", "seamless-m4t-medium", "recurrentgemma-2b",
              "kimi-k2-1t-a32b", "arctic-480b", "xlstm-1.3b")


def _notes(cfg) -> str:
    bits = []
    if cfg.mla is not None:
        bits.append("MLA latent KV")
    elif cfg.num_kv_heads == 1:
        bits.append("MQA")
    elif cfg.num_kv_heads < cfg.num_heads:
        bits.append(f"GQA {cfg.num_heads}:{cfg.num_kv_heads}")
    if cfg.moe is not None:
        bits.append(f"MoE {cfg.moe.num_experts}e/top{cfg.moe.top_k}")
    kinds = set(cfg.block_pattern)
    if kinds - {"attn"}:
        bits.append("+".join(sorted(kinds - {"attn"})) + " blocks")
    if cfg.window:
        bits.append(f"window {cfg.window}")
    if cfg.encoder_layers:
        bits.append("enc-dec")
    if cfg.frontend:
        bits.append(f"{cfg.frontend} frontend")
    return ", ".join(bits) or "dense attention"


def _kv_dtypes(cfg) -> str:
    """The serving KV dtypes an arch accepts, as
    ``serve.engine.validate_kv_dtype`` decides them: quantized dtypes need
    an attention-only decoder."""
    if set(cfg.block_pattern) - {"attn"} or cfg.encoder_layers:
        return "fp32"
    return "fp32/int8/fp8"


def zoo_table() -> str:
    """The Markdown model-zoo table of ``repro``'s ``zoo_table``, from the
    port's configs (the same string):

      PYTHONPATH=src python -c "from repro_torch.configs.registry \\
        import zoo_table; print(zoo_table())"
    """
    rows = ["| arch id | family | layers | d_model | heads | params "
            "| kv dtypes | notes |",
            "|---|---|---|---|---|---|---|---|"]
    for arch in _ZOO_ORDER:
        cfg = get_config(arch)
        p = cfg.param_count()
        if p >= 1e12:
            params = f"{p / 1e12:.2f}T"
        elif p >= 1e9:
            params = f"{p / 1e9:.1f}B"
        else:
            params = f"{p / 1e6:.0f}M"
        layers = (f"{cfg.encoder_layers}+{cfg.decoder_layers}"
                  if cfg.encoder_layers else str(cfg.num_layers))
        rows.append(
            f"| `{arch}` | {cfg.family} | {layers} | {cfg.d_model} "
            f"| {cfg.num_heads} | {params} | {_kv_dtypes(cfg)} "
            f"| {_notes(cfg)} |")
    return "\n".join(rows)
