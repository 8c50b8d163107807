"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    max_seq_len=32768,
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,             # MLA expands latents to all heads
    d_ff=6400,
    vocab_size=73448,
    activation="swiglu",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_rope_dim=32,
        qk_nope_dim=64,
        v_head_dim=64,
    ),
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256,
    # v_head_dim != qk dims on purpose: exercises the Dq != Dv paths
    mla=MLAConfig(q_lora_rank=24, kv_lora_rank=16, qk_rope_dim=8,
                  qk_nope_dim=8, v_head_dim=12),
)
