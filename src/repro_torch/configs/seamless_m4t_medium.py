"""seamless-m4t-medium [audio]: 12 + 12 layers (encoder, decoder)
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206, tied head; LayerNorm, a
non-gated GELU FFN, QKV bias. The speech frontend is a stub: its 1,024
frame embeddings are a model input, projected and encoded.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    max_seq_len=32768,
    num_layers=12,               # per side
    encoder_layers=12,
    decoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",           # non-gated
    norm="layernorm",
    qkv_bias=True,
    tie_embeddings=True,
    frontend="audio",
    frontend_tokens=1024,        # stub speech frames fed to the encoder
    frontend_dim=1024,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, encoder_layers=2, decoder_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    frontend_tokens=16, frontend_dim=16,
)
