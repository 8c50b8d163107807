"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (7:1 ratio, xLSTM[7:1]); blocks carry their own projections.
[arXiv:2405.04517; unverified]

No softmax attention exists in this family, so the paper's ExpMul operator
does not apply to it, and no layer has a KV cache: the state is per slot.
"""
from repro_torch.configs.base import ModelConfig

_UNIT = ("mlstm",) * 7 + ("slstm",)   # 8-block unit x 6 = 48 layers

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    max_seq_len=1_048_576,
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_UNIT,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    max_seq_len=256,
    num_layers=8, d_model=64, num_heads=2, num_kv_heads=2, vocab_size=256,
)
