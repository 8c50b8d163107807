"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8, per-expert d_ff=2048, untied head — trillion-param
MoE (paper-table). [arXiv:2501.kimi2; unverified]

Its head dim is 7168 / 64 = 112 (GQA group 8): the four serving kernels
and the flash forward of training take any head dim up to 256
(``kernels/decode/decode.py:MAX_HEAD_DIM``) and have a build at 112
(``csrc/*.cu``). One layer's 384 experts are ~34 GB in bf16, so on one
card it is served at full width and depth 2 (``chip_smoke.py``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    max_seq_len=32768,
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,                      # all FFN capacity lives in the experts
    vocab_size=163840,
    activation="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048),
    tie_embeddings=False,
    opt_state_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32),
)
