"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (MHA kv=16) d_ff=2816
vocab=151936 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    max_seq_len=32768,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    rope_base=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256,
)
