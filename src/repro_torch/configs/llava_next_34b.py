"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, untied head. Backbone only (Yi-34B-class); the vision frontend
is a stub: its 576 patch embeddings of width 1024 (CLIP ViT-L/14) are a
model input, projected and prepended to the text.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

# anyres: one base tile of 24 x 24 = 576 patches
FRONTEND_TOKENS = 576

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    max_seq_len=32768,
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    activation="swiglu",
    rope_base=5_000_000.0,
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=FRONTEND_TOKENS,
    frontend_dim=1024,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, frontend_tokens=8, frontend_dim=16,
)
