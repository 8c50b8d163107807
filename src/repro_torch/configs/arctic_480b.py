"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) vocab=32000, MoE 128
experts top-2 (d_ff=4864) + dense residual FFN in parallel, untied head.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    max_seq_len=32768,
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32000,
    activation="swiglu",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864,
                  dense_residual=True, dense_d_ff=4864),
    tie_embeddings=False,
    opt_state_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=32,
                  dense_residual=True, dense_d_ff=32),
)
