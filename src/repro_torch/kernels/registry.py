"""The attention backend registry of the port (the twin of
``repro/kernels/registry.py``, DESIGN.md §3).

One ``AttentionSpec`` says *how* attention is computed (implementation,
arithmetic variant, tile widths, local window, KV storage dtype) apart
from *where* it is called: the full sequence (training, forward), a
chunked prefill or a one-token decode, over per-slot caches or a paged
pool. The layers (``layers/attention_layer.py``, ``layers/mla.py``) and
``core.attention.attention`` build a spec from the model config and call
one of the five ``dispatch_*`` functions below, which look the spec's
implementation up in the table of that calling convention:

  full sequence   fn(q, k, v, *, spec, causal, scale)       -> (B, H, Sq, Dv)
  chunked prefill fn(q, k_cache, v_cache, k_chunk, v_chunk,
                     *, spec, scale, lengths, n_valid,
                     rolling)                               -> (B, H, C, Dv)
  decode          fn(q, k_cache, v_cache, lengths,
                     *, spec, scale)                        -> (B, H, Dv)
  paged prefill   fn(q, k_chunk, v_chunk, k_pool, v_pool,
                     rows, *, spec, scale, q_positions,
                     chunk_valid, lengths, n_valid,
                     block_tables, page_size)               -> (B, H, C, Dv)
  paged decode    fn(q, k_pool, v_pool, rows, lengths,
                     *, spec, scale, block_tables,
                     page_size)                             -> (B, H, Dv)

The conventions are the reference's. The chunked prefill passes the
resident cache and the chunk's fresh KV as separate operands with
``lengths`` (tokens resident) and ``n_valid`` (valid chunk tokens);
``rolling`` reads a windowed layer's cache as a rolling buffer. The paged
conventions take flat pools (pool_tokens, Hkv, .) with ``rows`` (B, L),
the physical row of each logical position (``kernels.paged.slot_rows``),
and the raw ``block_tables`` and ``page_size``. The port's layers pass
the tables and leave ``rows`` None: the fused kernels read the tables
themselves, and a gather route computes ``rows`` from them on the device,
with no host read, so a serving tick stays capturable in a CUDA graph.
Likewise a paged prefill may get ``n_valid`` instead of ``q_positions``
and ``chunk_valid``; each entry derives what it lacks from the others.

Names. The reference's names are all registered: ``ref`` and
``flash_jnp`` (full sequence), ``masked_xla`` (prefill), ``xla``
(decode), ``gather_xla`` and ``gather_pallas`` (both paged tables), and
``pallas`` in every table. The port adds two of its own in every table:
``kernel``, the hand-written CUDA kernels (their plain PyTorch versions
for CPU tensors), and ``plain``, the plain versions on any device. The
reference's ``pallas`` is a declared fallback onto ``kernel``
(``register_*(name, fallback_of=...)``): the port has no Pallas, and its
CUDA kernels are the Pallas kernels' counterparts, so ``resolved_backends``
reports ``requested 'pallas' -> runs 'kernel'``. ``gather_pallas`` runs
the contiguous CUDA kernels over a gathered copy of the paged history.

``AttentionSpec.kv_dtype`` adds the quantized axis: at "int8" or "fp8"
the resolvers return each table's ``<name>_q`` entry
(``kernels/kvquant.py``), whose cache-side K/V operands are
``numerics.quant.QuantKV`` (codes plus float32 scale rows).

Observability: when ``kernels.build.DISPATCH_SINK`` is set, each
``dispatch_*`` call reports once, under its kind ("full", "prefill",
"decode", "paged_prefill", "paged_decode"), its route's label and the
operands' geometry; the kernel wrappers it reaches report nothing more,
so one attention call counts once. A route's label is the name it runs
(after a declared fallback) without ``_q``: "kernel" and "plain" carry
exactly the labels the wrappers give when called directly, and the
quantization is the ``kv_dtype`` label.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import build

# the names that select themselves in every table when a spec names no
# serving impl (the reference: only "pallas")
KERNEL_FAMILY = ("kernel", "plain", "pallas")
# the routes that launch a CUDA kernel on CUDA tensors
KERNEL_ROUTES = ("kernel", "gather_pallas")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Everything attention dispatch needs beyond the operands.

    ``impl`` names the full-sequence entry; ``decode_impl``,
    ``prefill_impl`` and ``paged_impl`` default (None) to the natural
    companion of ``impl``, so a config only has to pick one family.
    ``remat`` is kept for the reference's field set: PyTorch's autograd
    keeps what ``flash_ref`` saves, and the layers recompute by
    ``cfg.remat`` themselves.
    """

    impl: str = "flash_jnp"          # ref | flash_jnp | kernel | plain | ...
    decode_impl: str | None = None   # xla | kernel | plain | pallas
    prefill_impl: str | None = None  # masked_xla | kernel | plain | pallas
    paged_impl: str | None = None    # gather_xla | gather_pallas | kernel
    variant: str = "exact"           # exact | expmul
    use_ste: bool = False            # straight-through grads for expmul
    window: int | None = None        # local attention span
    kv_dtype: str = "fp32"           # fp32 | int8 | fp8 (KV-cache storage)
    block_q: int = 128
    block_k: int = 512
    decode_block_k: int = 256
    q_chunks: int = 4                # causal block skipping (flash_jnp)
    remat: bool = True

    def quantized(self) -> bool:
        """True when KV is stored quantized: every table resolves to its
        ``<name>_q`` entry, whose cache-side operands are ``QuantKV``; the
        full-sequence ``_q`` entries fake-quantize fresh K/V, so a forward
        equals a round trip through a quantized cache."""
        return self.kv_dtype != "fp32"

    def _q(self, name: str) -> str:
        return name + "_q" if self.quantized() else name

    def _family(self, default: str) -> str:
        return self.impl if self.impl in KERNEL_FAMILY else default

    def resolved_impl(self) -> str:
        return self._q(self.impl)

    def resolved_decode_impl(self) -> str:
        return self._q(self.decode_impl or self._family("xla"))

    def resolved_prefill_impl(self) -> str:
        return self._q(self.prefill_impl or self._family("masked_xla"))

    def resolved_paged_impl(self) -> str:
        return self._q(self.paged_impl or self._family("gather_xla"))

    @classmethod
    def from_config(cls, cfg, *, window=None, variant=None, use_ste=False,
                    kv_dtype=None) -> "AttentionSpec":
        """The spec of a ``ModelConfig`` (the one cfg -> kernel mapping).
        ``kv_dtype`` overrides ``cfg.kv_dtype``: MLA quantizes its latents
        before the expansion and passes "fp32", so the expanded K/V are
        never quantized twice."""
        return cls(
            impl=cfg.attention_impl,
            decode_impl=cfg.attention_decode_impl,
            prefill_impl=cfg.attention_prefill_impl,
            paged_impl=cfg.attention_paged_impl,
            variant=variant if variant is not None else cfg.attention_variant,
            use_ste=use_ste,
            window=window,
            kv_dtype=kv_dtype if kv_dtype is not None else cfg.kv_dtype,
            block_q=cfg.attention_block_q,
            block_k=cfg.attention_block_k,
            q_chunks=cfg.attention_q_chunks,
            remat=cfg.remat,
        )

    def replace(self, **kw) -> "AttentionSpec":
        return dataclasses.replace(self, **kw)


_ATTENTION_IMPLS: dict[str, object] = {}
_PREFILL_IMPLS: dict[str, object] = {}
_DECODE_IMPLS: dict[str, object] = {}
_PAGED_PREFILL_IMPLS: dict[str, object] = {}
_PAGED_DECODE_IMPLS: dict[str, object] = {}

# (table kind, registered name) -> the name whose entry it runs
_FALLBACK_NOTES: dict[tuple[str, str], str] = {}


def _make_register(table, kind):
    def register(name: str, *, fallback_of: str | None = None):
        def deco(fn):
            table[name] = fn
            if fallback_of is not None:
                _FALLBACK_NOTES[(kind, name)] = fallback_of
            return fn
        return deco
    return register


register_attention = _make_register(_ATTENTION_IMPLS, "full-sequence")
register_prefill = _make_register(_PREFILL_IMPLS, "prefill")
register_decode = _make_register(_DECODE_IMPLS, "decode")
register_paged_prefill = _make_register(_PAGED_PREFILL_IMPLS, "paged prefill")
register_paged_decode = _make_register(_PAGED_DECODE_IMPLS, "paged decode")


def register_kernel_family(register, entry, suffix: str = "") -> None:
    """Register the port's kernel routes in one table: ``kernel`` (the
    CUDA kernels, their plain versions for CPU tensors), ``pallas`` (a
    declared fallback onto ``kernel``) and ``plain`` (the plain versions
    on any device); ``entry(plain)`` builds the entry, ``suffix`` "_q"
    names the quantized twins."""
    kernel = entry(False)
    register("kernel" + suffix)(kernel)
    register("pallas" + suffix, fallback_of="kernel" + suffix)(kernel)
    register("plain" + suffix)(entry(True))


def resolved_name(kind: str, name: str) -> str:
    """The entry a registered ``name`` of table ``kind`` runs."""
    return _FALLBACK_NOTES.get((kind, name), name)


def route_label(kind: str, name: str) -> str:
    """The dispatch and ledger label of ``name``: the entry it runs,
    without ``_q``."""
    return resolved_name(kind, name).removesuffix("_q")


def resolved_backends(spec: AttentionSpec, *,
                      paged: bool = False) -> list[dict]:
    """What this spec runs, per dispatch table: one dict a table,
    ``{"kind", "requested", "resolved", "fallback", "note"}``, where
    ``resolved`` differs from ``requested`` for a declared fallback
    (``pallas`` runs ``kernel``), and ``note`` says that, with no card, a
    kernel route runs its plain version on CPU tensors. ``ServeEngine``
    logs the rows with a fallback or a note once at start."""
    import torch

    _register_builtins()
    kinds = [
        ("full-sequence", spec.resolved_impl()),
        ("prefill", spec.resolved_prefill_impl()),
        ("decode", spec.resolved_decode_impl()),
    ]
    if paged:
        kinds += [
            ("paged prefill", spec.resolved_paged_impl()),
            ("paged decode", spec.resolved_paged_impl()),
        ]
    no_card = not torch.cuda.is_available()
    out = []
    for kind, name in kinds:
        resolved = resolved_name(kind, name)
        note = ""
        if no_card and resolved.removesuffix("_q") in KERNEL_ROUTES:
            note = ("plain version (no card: a kernel entry called on CPU "
                    "tensors runs its plain version)")
        out.append({
            "kind": kind,
            "requested": name,
            "resolved": resolved,
            "fallback": resolved != name,
            "note": note,
        })
    return out


def _register_builtins():
    """Import the modules whose entries register themselves: the core
    built-ins and the ``_q`` twins (both import this module, so they are
    imported here, lazily)."""
    import repro_torch.core.attention  # noqa: F401
    import repro_torch.kernels.kvquant  # noqa: F401


def _lookup(table, name, kind):
    if name not in table:
        _register_builtins()
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} attention impl {name!r}; "
            f"registered: {sorted(table)}"
        ) from None


def attention_impls() -> tuple[str, ...]:
    """Every registered full-sequence name, ``_q`` entries included."""
    _register_builtins()
    return tuple(sorted(_ATTENTION_IMPLS))


def check_spec(spec: AttentionSpec, *, paged: bool = False) -> None:
    """Raise the ``ValueError`` of an unknown name now, for every table
    ``spec`` would use."""
    _lookup(_ATTENTION_IMPLS, spec.resolved_impl(), "full-sequence")
    _lookup(_PREFILL_IMPLS, spec.resolved_prefill_impl(), "prefill")
    _lookup(_DECODE_IMPLS, spec.resolved_decode_impl(), "decode")
    if paged:
        _lookup(_PAGED_PREFILL_IMPLS, spec.resolved_paged_impl(),
                "paged prefill")
        _lookup(_PAGED_DECODE_IMPLS, spec.resolved_paged_impl(),
                "paged decode")


def _shape(x):
    """An operand's shape: a ``QuantKV`` reports its codes'."""
    return getattr(x, "codes", x).shape


def _observed(kind, table_kind, name, spec, kv, call, **geometry):
    """Run ``call()``; with a dispatch sink installed, report the call to
    it once and keep the wrappers ``call`` reaches from reporting it
    again. The ``kv_dtype`` label is the cache-side operand ``kv``'s, as
    the wrappers label it: codes and scales (``QuantKV``) carry the
    spec's, values "fp32"."""
    sink = build.DISPATCH_SINK
    if sink is None:
        return call()
    sink(kind, impl=route_label(table_kind, name), variant=spec.variant,
         kv_dtype=spec.kv_dtype if hasattr(kv, "codes") else "fp32",
         **geometry)
    build.DISPATCH_SINK = None
    try:
        return call()
    finally:
        build.DISPATCH_SINK = sink


def dispatch_attention(spec: AttentionSpec, q, k, v, *, causal=True,
                       scale=None):
    """Full-sequence attention. q: (B, H, Sq, D); k/v: (B, Hkv, Sk, .)."""
    name = spec.resolved_impl()
    fn = _lookup(_ATTENTION_IMPLS, name, "full-sequence")
    qs, ks, vs = _shape(q), _shape(k), _shape(v)
    return _observed(
        "full", "full-sequence", name, spec, k,
        lambda: fn(q, k, v, spec=spec, causal=causal, scale=scale),
        batch=qs[0], heads=qs[1], heads_kv=ks[1], d_qk=ks[-1], d_v=vs[-1],
        kv_tokens=ks[2], q_tokens=qs[2])


def dispatch_prefill(spec: AttentionSpec, q, k_cache, v_cache, k_chunk,
                     v_chunk, *, lengths, n_valid, scale=None,
                     rolling=False):
    """Chunked-prefill attention: chunk queries over [cache ++ chunk].

    q: (B, H, C, D) chunk queries; k_cache/v_cache: (B, Hkv, S, .) the
    resident cache (values, or ``QuantKV`` codes and scales for a
    quantized spec); k_chunk/v_chunk: (B, Hkv, C, .) the chunk's fresh KV
    (the same representation); lengths: (B,) tokens already resident;
    n_valid: (B,) valid chunk tokens (idle rows pass 0 and get finite
    rows of no meaning).

    Positions are implied: chunk token i sits at ``lengths + i``; cache
    slot j holds position j (``rolling=False``) or the rolling-buffer
    position ``last - ((last - j) % S)`` (``rolling=True``, windowed
    layers). Query i sees KV j iff position_j <= position_i (and within
    ``spec.window`` when set). ``masked_xla`` rebuilds the positional
    tensors; the kernels mask in the tile, with no concatenation.
    """
    name = spec.resolved_prefill_impl()
    fn = _lookup(_PREFILL_IMPLS, name, "prefill")
    qs, ks, vs = _shape(q), _shape(k_cache), _shape(v_cache)
    return _observed(
        "prefill", "prefill", name, spec, k_cache,
        lambda: fn(q, k_cache, v_cache, k_chunk, v_chunk, spec=spec,
                   scale=scale, lengths=lengths, n_valid=n_valid,
                   rolling=rolling),
        batch=qs[0], heads=qs[1], heads_kv=ks[1], d_qk=ks[-1], d_v=vs[-1],
        kv_tokens=ks[2], q_tokens=qs[2])


def dispatch_decode(spec: AttentionSpec, q, k_cache, v_cache, lengths, *,
                    scale=None):
    """One-token decode. q: (B, H, D); caches: (B, Hkv, S, .); lengths:
    (B,) tokens to attend, the current one included."""
    name = spec.resolved_decode_impl()
    fn = _lookup(_DECODE_IMPLS, name, "decode")
    qs, ks, vs = _shape(q), _shape(k_cache), _shape(v_cache)
    return _observed(
        "decode", "decode", name, spec, k_cache,
        lambda: fn(q, k_cache, v_cache, lengths, spec=spec, scale=scale),
        batch=qs[0], heads=qs[1], heads_kv=ks[1], d_qk=ks[-1], d_v=vs[-1],
        kv_tokens=ks[2], q_tokens=1)


def _table_tokens(rows, block_tables, page_size):
    return (_shape(rows)[1] if rows is not None
            else block_tables.shape[1] * page_size)


def dispatch_paged_prefill(spec: AttentionSpec, q, k_chunk, v_chunk, k_pool,
                           v_pool, rows=None, *, lengths, q_positions=None,
                           chunk_valid=None, n_valid=None, scale=None,
                           block_tables=None, page_size=0):
    """Chunked prefill against a paged KV pool (DESIGN.md §7).

    q: (B, H, C, D) chunk queries; k_chunk/v_chunk: (B, Hkv, C, .) the
    chunk's fresh KV (not yet in the pool); k_pool/v_pool: (pool_tokens,
    Hkv, .) flat pools; rows: (B, L) physical rows of logical positions
    0..L-1 (sentinel rows read as zero and are masked), or None with
    ``block_tables`` (B, max_blocks) and ``page_size`` given; lengths:
    (B,) tokens resident; q_positions (B, C) absolute chunk positions and
    chunk_valid (B, C) bool, or n_valid (B,) valid chunk tokens. The
    history is masked positionally as on the contiguous layout.
    """
    name = spec.resolved_paged_impl()
    fn = _lookup(_PAGED_PREFILL_IMPLS, name, "paged prefill")
    qs, ks, vs = _shape(q), _shape(k_pool), _shape(v_pool)
    return _observed(
        "paged_prefill", "paged prefill", name, spec, k_pool,
        lambda: fn(q, k_chunk, v_chunk, k_pool, v_pool, rows, spec=spec,
                   scale=scale, q_positions=q_positions,
                   chunk_valid=chunk_valid, lengths=lengths, n_valid=n_valid,
                   block_tables=block_tables, page_size=page_size),
        batch=qs[0], heads=qs[1], heads_kv=ks[1], d_qk=ks[-1], d_v=vs[-1],
        kv_tokens=_table_tokens(rows, block_tables, page_size),
        q_tokens=qs[2], page_size=page_size)


def dispatch_paged_decode(spec: AttentionSpec, q, k_pool, v_pool, rows,
                          lengths, *, scale=None, block_tables=None,
                          page_size=0):
    """One-token decode against a paged KV pool.

    q: (B, H, D); pools: (pool_tokens, Hkv, .); rows: (B, L) physical rows
    in logical order, or None with ``block_tables`` and ``page_size``
    given (the current token's KV already written); lengths: (B,) tokens
    to attend, the current one included. ``spec.window`` masks positions
    below ``lengths - window``.
    """
    name = spec.resolved_paged_impl()
    fn = _lookup(_PAGED_DECODE_IMPLS, name, "paged decode")
    qs, ks, vs = _shape(q), _shape(k_pool), _shape(v_pool)
    return _observed(
        "paged_decode", "paged decode", name, spec, k_pool,
        lambda: fn(q, k_pool, v_pool, rows, lengths, spec=spec, scale=scale,
                   block_tables=block_tables, page_size=page_size),
        batch=qs[0], heads=qs[1], heads_kv=ks[1], d_qk=ks[-1], d_v=vs[-1],
        kv_tokens=_table_tokens(rows, block_tables, page_size), q_tokens=1,
        page_size=page_size)
