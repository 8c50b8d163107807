"""Model configuration of the port: the dense, attention-only decoder fields
of ``repro.configs.base.ModelConfig`` under the same names and defaults.

Fields of families the port does not serve yet (MoE, MLA, recurrent block
kinds, encoder-decoder, modality frontends) are left out until their slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

ATTENTION_IMPLS = ("kernel", "plain")


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
    activation: str = "swiglu"     # swiglu (the only gated MLP ported)
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_base: float = 10000.0
    window: int | None = None      # local attention window

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
        d, hd = self.d_model, self.resolved_head_dim()
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        ffn = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + d + self.num_layers * (attn + ffn + 2 * d)
