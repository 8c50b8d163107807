"""gemma-7b [dense]: 28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    max_seq_len=32768,
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,                # gemma's oversized heads = paper's largest d
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    scale_embeddings=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=256,
)
