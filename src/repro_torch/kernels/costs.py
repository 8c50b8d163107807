"""Analytic datapath cost model for attention calls (the port of
``repro/kernels/costs.py``, DESIGN.md §12).

It prices what an attention call is *designed* to move and compute, and
is shared by two layers: the dispatch counters of the attention wrappers
(shape-level cost per call, ``serve/metrics.py``) and the ``ServeEngine``
executed-cost ledger (actual host-side lengths per engine step). The
formulas are the reference's, so the port's ledger equals ``repro``'s
for the same steps.

Cost conventions (documented per helper): q/output traffic is excluded
(identical across paths), gather datapaths pay a write + read of the
materialized fp32 copy, paged layouts amortize the int32 block-table
read, quantized dtypes add the per-row float32 scale reads.
"""
from __future__ import annotations

SCALE_BYTES = 4   # per-row float32 scale (numerics/quant.py contract)
F32 = 4
TABLE_BYTES = 4   # int32 block-table entry, amortized over page_size tokens


def kv_code_bytes(kv_dtype: str) -> int:
    """Bytes per stored KV element: 1 for int8/fp8 codes, 4 for fp32."""
    return F32 if kv_dtype == "fp32" else 1


def impl_path(impl: str) -> str:
    """Map a registry name (a resolved impl, with or without ``_q``) onto
    the cost model's two datapaths. ``"fused"``: in-kernel block tables
    and in-register dequant, no materialized copy: the port's "kernel"
    and "plain" (the kernel's arithmetic in PyTorch ops) and the
    reference's "pallas", which runs "kernel". ``"gather"``: everything
    else, which gathers, concatenates or dequantizes into a contiguous
    copy first ("gather_pallas", "gather_xla", "masked_xla", "xla",
    "flash_jnp", "ref"; the contiguous float ``xla`` / ``masked_xla``
    forms read in place, which the helpers price as no copy)."""
    base = impl.removesuffix("_q")
    return "fused" if base in ("kernel", "plain", "pallas") else "gather"


def analytic_bytes_per_ctx_token(layout, kv_dtype, path, *, Hkv, D, Dv,
                                 page_size):
    """Designed HBM bytes touched per context token for one decode step.

    Counted per logical token of resident history, summed over the K and V
    rows of all ``Hkv`` heads:

      * cache read — what the attention math must load: codes (1 B/elt) +
        scale rows for quantized dtypes, 4 B/elt for fp32.
      * gather overhead — the gather datapaths materialize a contiguous
        fp32 copy of the (dequantized) history before attending, paying a
        full write + read of that copy on top of the cache read. The
        contiguous-fp32 gather ("xla") reads the cache in place (masked
        one-pass softmax, no copy), so its overhead is zero — fused vs
        gather only diverges where a copy exists (every paged cell and,
        in time if not bytes, the dequant cells).
      * paged adds the block-table read, amortized per token.

    q/o traffic is context-independent and excluded (identical across
    paths).
    """
    elt = kv_code_bytes(kv_dtype)
    cache_read = Hkv * (D + Dv) * elt
    if kv_dtype != "fp32":
        cache_read += Hkv * 2 * SCALE_BYTES
    copy = 2 * Hkv * (D + Dv) * F32  # write + read of the fp32 copy
    b = cache_read
    if layout == "paged":
        b += TABLE_BYTES / page_size
        if path == "gather":
            b += copy
    elif path == "gather" and kv_dtype != "fp32":
        # contiguous quantized gather: dequantized fp32 copy of the cache
        b += copy
    return b


def analytic_bytes_per_chunk_token(layout, kv_dtype, path, *, Hkv, D, Dv,
                                   ctx, chunk, page_size):
    """Designed HBM bytes touched per *chunk token* for one prefill step.

    A chunk of ``chunk`` fresh tokens attends over ``ctx`` resident
    history tokens plus itself; per KV head a token row costs
    ``(D + Dv) * elt`` bytes (+ 2 scale rows when quantized):

      * history read — what the attention math must load once per chunk:
        codes (1 B/elt) + scale rows for quantized dtypes, 4 B/elt fp32.
      * gather overhead — the gather datapaths materialize a contiguous
        dequantized fp32 copy of the history (and of the quantized chunk)
        before attending, paying a full write + read of that copy on top
        of the raw read. The contiguous-fp32 gather reads the cache in
        place (masked one-pass softmax, no copy), so its overhead is
        zero — fused vs gather only diverges where a copy exists (every
        paged cell and every quantized cell).
      * the chunk's own fresh KV is read once by both paths; paged adds
        the block-table read.

    Everything is divided by ``chunk``: the steady-state per-prompt-token
    HBM cost of prefilling at this chunk size. q/output traffic is
    identical across paths and excluded.
    """
    elt = kv_code_bytes(kv_dtype)
    row = Hkv * (D + Dv) * elt
    if kv_dtype != "fp32":
        row += Hkv * 2 * SCALE_BYTES
    row_f32 = Hkv * (D + Dv) * F32
    hist = ctx * row
    chunk_bytes = chunk * row
    b = hist + chunk_bytes
    copy = 2 * (ctx + chunk) * row_f32      # write + read of the fp32 copy
    if layout == "paged":
        b += TABLE_BYTES * (-(-ctx // page_size))
        if path == "gather":
            b += copy
    elif path == "gather" and kv_dtype != "fp32":
        b += copy
    return b / chunk


def analytic_attention_flops(q_tokens, kv_tokens, *, heads, d_qk, d_v):
    """Attention-math FLOPs for ``q_tokens`` queries over ``kv_tokens``
    keys/values: 2·D_qk per (q, k) score pair + 2·D_v per weighted-sum
    pair, per head — the standard estimate, masking ignored (an upper
    bound within 2x for causal chunks, exact for decode)."""
    return 2 * heads * (d_qk + d_v) * int(q_tokens) * int(kv_tokens)


def attn_kv_geometry(cfg) -> dict:
    """Per-attention-layer KV geometry of a model config, in the shape the
    analytic helpers take: ``Hkv`` heads of ``D``-dim K plus ``Dv``-dim V
    rows per token, over ``layers`` attention layers (recurrent kinds hold
    no KV and are left out). An MLA layer stores
    one latent row of ``kv_lora_rank + qk_rope_dim`` features per token,
    priced as one ``Hkv=1`` head with ``Dv=0`` (as ``kv_token_bytes``);
    its ``d_qk`` / ``d_v`` are the attention math's per-head dims after
    the latents' expansion, which price its FLOPs."""
    layers = cfg.pattern_for().count("attn")
    if cfg.mla is not None:
        m = cfg.mla
        return {"Hkv": 1, "D": m.kv_lora_rank + m.qk_rope_dim, "Dv": 0,
                "heads": cfg.num_heads, "layers": layers,
                "d_qk": m.qk_nope_dim + m.qk_rope_dim, "d_v": m.v_head_dim}
    d = cfg.resolved_head_dim()
    return {"Hkv": cfg.num_kv_heads, "D": d, "Dv": d,
            "heads": cfg.num_heads, "layers": layers, "d_qk": d,
            "d_v": d}


# ---- the attention calls' costs, reported to an op counter ------------
#
# An op counter (``launch/op_costs.py``) sees every PyTorch op, but not a
# CUDA kernel launched through ``ctypes`` nor the work a ``meta`` operand
# stands for. The five attention wrappers report such a call here, once,
# with its analytic cost; the active counters add it up. A wrapper checks
# ``counting()`` before it works out a report, so a launch with no counter
# active does no cost arithmetic.

COST_SINKS: list = []


def counting() -> bool:
    """Whether an op counter is active."""
    return bool(COST_SINKS)


def record_call(name: str, *, flops: float, bytes: float) -> None:
    """Report one attention call (``name`` its kernel's) to every active
    counter. Its FLOPs are float32 ones on the CUDA cores: the attention
    kernels run fmaf chains, and the flash backward's recompute
    (``flash_ref``) computes in float32."""
    for sink in COST_SINKS:
        sink(name, flops=float(flops), bytes=float(bytes),
             flop_type="float32")


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped), each in its dtype."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def attention_call_cost(out, operands, *, batch, heads, q_tokens, kv_tokens,
                        d_qk, d_v, kv_bytes=0):
    """(flops, bytes) of one attention call: ``analytic_attention_flops``
    over ``batch`` rows (masking ignored: an upper bound within 2x for a
    causal call), and each operand read once and the output written once,
    each in its own dtype; a contiguous cache at its whole span (a
    ``meta`` call has no lengths to read), a paged pool as the
    ``kv_bytes`` of its tables' span."""
    flops = batch * analytic_attention_flops(q_tokens, kv_tokens,
                                             heads=heads, d_qk=d_qk, d_v=d_v)
    return flops, tensor_bytes(out, *operands) + kv_bytes


def report_call(name, out, operands, **shape):
    """``record_call`` of ``attention_call_cost``; returns ``out``."""
    flops, nbytes = attention_call_cost(out, operands, **shape)
    record_call(name, flops=flops, bytes=nbytes)
    return out
