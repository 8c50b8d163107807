"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1:2 ratio. [arXiv:2402.19427; hf]

26 layers with a 13-block unit repeated twice: 8 local-attention and 18
recurrent blocks, the published 1:2 ratio and depth (the strict period-3
phase shifts by one at the unit boundary).
"""
from repro_torch.configs.base import ModelConfig

_UNIT = ("rglru", "rglru", "attn") * 4 + ("rglru",)   # 13 blocks

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    max_seq_len=1_048_576,
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,              # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="geglu",
    scale_embeddings=True,
    block_pattern=_UNIT,
    window=2048,                 # local attention window
    lru_width=2560,
    logits_softcap=30.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, lru_width=64, window=32,
    block_pattern=("rglru", "rglru", "attn"),
)
