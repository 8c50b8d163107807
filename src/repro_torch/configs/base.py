"""Model configuration of the port: the attention-only decoder fields of
``repro.configs.base.ModelConfig`` under the same names and defaults, with
``MLAConfig`` for multi-head latent attention (minicpm3-4b) and
``MoEConfig`` for a mixture-of-experts FFN (arctic-480b, kimi-k2-1t-a32b),
and the fields of the recurrent patterns: ``block_pattern`` (a unit of
block kinds, ``attn``, ``rglru``, ``mlstm`` or ``slstm``, repeated to fill
``num_layers``; recurrentgemma-2b mixes RG-LRU and attention blocks,
xlstm-1.3b has mLSTM and sLSTM blocks and no attention layer),
``lru_width`` and ``logits_softcap``; ``norm`` (RMSNorm, or LayerNorm
for seamless-m4t-medium); the encoder-decoder depths ``encoder_layers``
and ``decoder_layers`` (seamless-m4t-medium: a non-causal encoder over
frontend frames, a decoder with cross-attention); and the modality
frontend stub ``frontend``, ``frontend_tokens`` and ``frontend_dim``: the
frontend's embeddings are a model input, projected to ``d_model``
(llava-next-34b prepends them to the text, seamless-m4t-medium encodes
them).

``family`` and ``max_seq_len`` carry ``repro``'s values (``zoo_table``
reads the family). ``scan_layers`` is left out: it is XLA's ``lax.scan``
over the layers, which changes no number. The ``attention_*`` fields feed
``kernels.registry.AttentionSpec.from_config``: ``attention_impl`` names
the full-sequence entry (and, at "kernel", "plain" or "pallas", the whole
family); ``attention_decode_impl``, ``attention_prefill_impl`` and
``attention_paged_impl`` (None: follow ``attention_impl``) name a serving
table's entry. ``opt_state_dtype`` is the AdamW moments' dtype the training
launcher asks for (``bfloat16`` for arctic-480b and kimi-k2-1t-a32b, as in
``repro``). An MLA config's attention reads its head dims from ``mla``
alone: ``resolved_head_dim()`` (``d_model // num_heads``) is neither its
qk dim nor its v dim. A config with ``moe`` has no dense FFN of ``d_ff``:
its FFN is the experts (and the dense residual of ``moe.dense_d_ff``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# the full-sequence names of the registry (``kernels.registry.
# attention_impls()`` without the ``_q`` twins a quantized kv_dtype picks)
ATTENTION_IMPLS = ("flash_jnp", "kernel", "pallas", "plain", "ref")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert hidden size
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0            # hidden of the dense residual path
    capacity_factor: float = 1.25
    router_dtype: str = "float32"  # the router softmax is kept exact


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
    family: str = "dense"          # dense|moe|hybrid|ssm|encdec|vlm|audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None    # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    activation: str = "swiglu"     # swiglu | geglu (gated) | gelu
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    rope_base: float = 10000.0
    max_seq_len: int = 8192
    # hybrid patterns: the unit repeats to fill num_layers
    block_pattern: tuple[str, ...] = ("attn",)   # attn|rglru|mlstm|slstm
    window: int | None = None      # local attention window
    lru_width: int | None = None   # rg-lru state width (default d_model)
    logits_softcap: float | None = None
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    # encoder-decoder depths (0: decoder-only)
    encoder_layers: int = 0
    decoder_layers: int = 0
    # modality frontend stub: its embeddings (B, frontend_tokens,
    # frontend_dim) are a model input
    frontend: str | None = None    # vision | audio
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # "kernel": every table runs the hand-written CUDA kernels (their
    # plain versions for CPU tensors); "plain": the plain PyTorch versions
    # on any device, the reference the kernels are held against; "pallas"
    # runs "kernel"; "flash_jnp" and "ref": the reference's XLA routes
    # (masked_xla / xla / gather_xla when serving), no kernel.
    attention_impl: str = "kernel"
    attention_variant: str = "expmul"      # exact | expmul  (paper default on)
    # the plain versions' query block (the CUDA kernels keep their own;
    # neither changes a number)
    attention_block_q: int = 128
    # the full-sequence forward's and the contiguous prefill's KV tile
    # width (part of an ExpMul result; the backward's blocks are the
    # largest divisor of Sk not above it)
    attention_block_k: int = 512
    attention_q_chunks: int = 4            # flash_jnp's causal query chunks
    attention_decode_impl: str | None = None   # None: follows impl
    attention_prefill_impl: str | None = None  # None: follows impl
    # None: follows impl ("kernel" runs the fused paged kernels, the
    # reference's names their own routes, gather_xla by default)
    attention_paged_impl: str | None = None

    page_size: int = 16            # tokens per KV block
    pool_blocks: int = 0           # 0: engine fully provisions slots*max_len
    kv_dtype: str = "fp32"         # fp32 | int8 | fp8
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True             # recompute each layer in the backward
    opt_state_dtype: str = "float32"  # AdamW moments (the launcher's)

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def pattern_for(self, num_layers: int | None = None) -> tuple[str, ...]:
        """The block kind of every layer, in layer order."""
        n = num_layers if num_layers is not None else self.num_layers
        unit = self.block_pattern
        if n % len(unit):
            raise ValueError(f"{n} layers do not tile the unit {unit}")
        return tuple(unit) * (n // len(unit))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters as ``repro``'s ``param_count`` counts them (MLA's two
        latent norms, LayerNorm biases and the frontend projection of an
        encoder-decoder left out, a decoder layer's cross-attention counted
        with the QKV bias it does not have, as there)."""
        return self._param_count(active_only=False)

    def active_param_count(self) -> int:
        """Parameters a token passes through: ``top_k`` experts of
        ``num_experts`` (``repro``'s ``active_param_count``)."""
        return self._param_count(active_only=True)

    def _param_count(self, active_only: bool) -> int:
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
        # w_gate, w_up, w_down of a gated MLP; w_up, w_down of a plain one
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.moe is not None:      # experts, router, dense residual
            m = self.moe
            n = m.top_k if active_only else m.num_experts
            ffn = n * mult * d * m.d_ff + d * m.num_experts
            if m.dense_residual:
                ffn += mult * d * m.dense_d_ff
        else:
            ffn = mult * d * self.d_ff
        w = self.lru_width or d
        # in/out projections (two branches), conv4, gates a/x, lambda, norms
        rglru = 2 * d * w + 4 * w + 2 * w * w + 3 * w + w * d + 2 * d
        # xLSTM blocks carry their own projections and no FFN: mLSTM's
        # up/gate/down, block-diagonal q/k/v and i/f gates; sLSTM's four
        # block-diagonal input and recurrent gates and its gated FFN
        inner = int(1.5 * d)
        inner -= inner % H
        mlstm = (2 * d * inner + 3 * H * (inner // H) ** 2 + 2 * inner * H
                 + inner * d + 2 * d)
        slstm = 8 * H * (d // H) ** 2 + 3 * d * int(4 / 3 * d) + 2 * d
        blocks = {"attn": attn + ffn + 2 * d, "rglru": rglru + ffn,
                  "mlstm": mlstm, "slstm": slstm}
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:       # decoder layers add cross + its norm
            return (emb + d + sum(blocks[kind] for kind in
                                  self.pattern_for(self.encoder_layers))
                    + self.decoder_layers * (blocks["attn"] + attn + d))
        front = self.frontend_dim * d if self.frontend else 0
        return (emb + d + front
                + sum(blocks[kind] for kind in self.pattern_for()))
