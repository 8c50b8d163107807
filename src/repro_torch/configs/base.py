"""Model configuration of the port: the attention-only decoder fields of
``repro.configs.base.ModelConfig`` under the same names and defaults, with
``MLAConfig`` for multi-head latent attention (minicpm3-4b).

Fields of families the port does not serve yet (MoE, recurrent block
kinds, encoder-decoder, modality frontends) are left out until their slice,
and so are ``family`` and ``max_seq_len``, which nothing of the port reads.
An MLA config's attention reads its head dims from ``mla`` alone:
``resolved_head_dim()`` (``d_model // num_heads``) is neither its qk dim
nor its v dim.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

ATTENTION_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2 family)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_rope_dim: int = 32
    qk_nope_dim: int = 64
    v_head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None    # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    activation: str = "swiglu"     # swiglu | geglu (gated MLPs)
    qkv_bias: bool = False
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    rope_base: float = 10000.0
    window: int | None = None      # local attention window
    mla: MLAConfig | None = None

    # "kernel": the attention ticks run the hand-written CUDA kernels (their
    # plain versions for CPU tensors); "plain": the plain PyTorch versions
    # on any device, the reference the kernels are held against.
    attention_impl: str = "kernel"
    attention_variant: str = "expmul"      # exact | expmul  (paper default on)
    # the full-sequence forward's KV tile width (part of an ExpMul result;
    # the backward's blocks are the largest divisor of Sk not above it)
    attention_block_k: int = 512

    page_size: int = 16            # tokens per KV block
    pool_blocks: int = 0           # 0: engine fully provisions slots*max_len
    kv_dtype: str = "fp32"         # fp32 | int8 | fp8
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True             # recompute each layer in the backward

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        d, hd, H = self.d_model, self.resolved_head_dim(), self.num_heads
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * H * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        else:
            attn = (d * H * hd + 2 * d * self.num_kv_heads * hd + H * hd * d)
            if self.qkv_bias:
                attn += (H + 2 * self.num_kv_heads) * hd
        ffn = 3 * d * self.d_ff        # gated: w_gate, w_up, w_down
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + d + self.num_layers * (attn + ffn + 2 * d)
