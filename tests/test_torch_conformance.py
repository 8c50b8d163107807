"""The port's twin of ``tests/test_conformance.py``: the same
``cells.CELLS`` matrix ({exact, expmul} x {fp32, int8, fp8} x
{contiguous, paged} x {mha, gqa, windowed, mla} x {forward,
prefill_decode, fused}), the same operands and serving simulation
(chunked prefill of 22 tokens in chunks of 8, then 2 decodes; pages of 4,
shuffled), run through the port's registry only (``repro_torch.kernels.
registry``; nothing of ``repro`` is imported):

* every active cell is held against the port's fp32 full-sequence
  ``flash_ref`` (one pass: ``block_k = S``, no query chunks) at the cell's
  documented ``ref_tol``;
* every fused cell (the ``pallas`` names, which run the port's ``kernel``
  route: the kernels' plain versions on CPU tensors) is held against its
  gather twin at ``PAIR_TOL`` = 1e-4, paired as ``_pair_reference`` pairs
  them: exact cells against the XLA serving split (masked_xla / xla /
  gather_xla); paged ExpMul cells against ``gather_pallas`` (the history
  gathered, then the contiguous kernels at ``block_k = page_size`` and
  ``decode_block_k = page_size``: the fused kernels' tiles), its decode
  rows left out for windowed cells (``gather_pallas`` decode takes the
  one-pass ``gather_xla`` there); quantized contiguous ExpMul cells
  against the fp32 fused route on fake-quantized operands.

``test_pairs_that_are_bit_for_bit`` states which pairs come out exactly
equal: the three fp32 paged ExpMul cells (the same page-wide tiles, the
same fmaf chains, the same operands). The quantized ExpMul pairs differ
by at most 2.4e-7: the gather twin and the fake-quantized copy multiply
codes by scales before the score product, the fused kernels after it.
The exact pairs (against the one-pass XLA split) differ by at most
8.3e-7, summation order.

``tests/test_conformance.py`` runs the same matrix on ``repro``; it is not
run again here (its cost), and the port's routes are held against
``repro``'s same-named entries by ``tests/test_torch_registry.py``.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.attention import flash_ref  # noqa: E402
from repro_torch.kernels.paged import (  # noqa: E402
    scatter_rows,
    slot_rows,
    token_rows,
)
from repro_torch.kernels.registry import (  # noqa: E402
    AttentionSpec,
    dispatch_attention,
    dispatch_decode,
    dispatch_paged_decode,
    dispatch_paged_prefill,
    dispatch_prefill,
)
from repro_torch.numerics.quant import (  # noqa: E402
    QuantKV,
    fake_quant_kv,
    kv_code_dtype,
    quantize_kv,
)

from cells import CELLS, FAMILY_SHAPES, Cell  # noqa: E402

B = 2
S = 24        # total sequence length
C = 8         # prefill chunk size
N_DEC = 2     # tokens decoded one by one after the chunked prefill
PS = 4        # page size of the paged cells
BQ = 8        # query block of the plain versions
BK = 8        # contiguous KV tile (the paged history tiles by PS)
PAIR_TOL = 1e-4


def _data(cell: Cell):
    sh = FAMILY_SHAPES[cell.family]
    rng = np.random.default_rng(zlib.crc32(cell.family.encode()))

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q = draw(B, sh["H"], S, sh["D"])
    k = draw(B, sh["Hkv"], S, sh["D"])
    v = draw(B, sh["Hkv"], S, sh["Dv"])
    return q, k, v, sh["window"]


def _reference(cell: Cell, q, k, v, window):
    """The fp32 full-sequence one-pass reference (same variant)."""
    return flash_ref(q, k, v, causal=True, window=window,
                     variant=cell.variant, block_k=S, causal_q_chunks=1)


def _spec(cell: Cell, mode: str, window):
    serving = {
        "forward": dict(),
        "prefill_decode": dict(prefill_impl="masked_xla", decode_impl="xla",
                               paged_impl="gather_xla"),
        "fused": dict(prefill_impl="pallas", decode_impl="pallas",
                      paged_impl="pallas"),
        "gather_pallas": dict(prefill_impl="pallas", decode_impl="pallas",
                              paged_impl="gather_pallas"),
    }[mode]
    return AttentionSpec(impl="flash_jnp", variant=cell.variant,
                         kv_dtype=cell.kv_dtype, window=window,
                         block_q=BQ, block_k=BK, decode_block_k=PS,
                         q_chunks=1, **serving)


def _codec(cell, kc, vc):
    """A chunk's K/V as the spec takes them: values, or codes and scales."""
    if cell.kv_dtype == "fp32":
        return kc, vc
    return (QuantKV(*quantize_kv(kc, cell.kv_dtype)),
            QuantKV(*quantize_kv(vc, cell.kv_dtype)))


def _buffers(cell, shape, Dk, Dv):
    """Zeroed K/V stores of ``shape`` (+ a feature axis): values, or codes
    with float32 scale rows."""
    if cell.kv_dtype == "fp32":
        return {"k": torch.zeros(shape + (Dk,)),
                "v": torch.zeros(shape + (Dv,))}
    cd = kv_code_dtype(cell.kv_dtype)
    return {"k": torch.zeros(shape + (Dk,), dtype=cd),
            "v": torch.zeros(shape + (Dv,), dtype=cd),
            "k_scale": torch.zeros(shape), "v_scale": torch.zeros(shape)}


def _operands(cell, buf):
    if cell.kv_dtype == "fp32":
        return buf["k"], buf["v"]
    return (QuantKV(buf["k"], buf["k_scale"]),
            QuantKV(buf["v"], buf["v_scale"]))


def _rows_of(cell, krow, vrow):
    """{"k", "v"[, "k_scale", "v_scale"]} of rows to store."""
    if cell.kv_dtype == "fp32":
        return {"k": krow, "v": vrow}
    kq, vq = quantize_kv(krow, cell.kv_dtype), quantize_kv(vrow,
                                                           cell.kv_dtype)
    return {"k": kq.codes, "v": vq.codes, "k_scale": kq.scale,
            "v_scale": vq.scale}


def _run_contiguous(cell, q, k, v, window, spec):
    span = window if window is not None else S
    rolling = window is not None
    buf = _buffers(cell, (B, k.shape[1], span), k.shape[-1], v.shape[-1])

    def write(i, krow, vrow):     # one token's rows at slot i % span / i
        pos = i % span if rolling else i
        for name, val in _rows_of(cell, krow, vrow).items():
            buf[name][:, :, pos] = val

    outs = []
    n_pre = S - N_DEC
    for s0 in range(0, n_pre, C):
        s1 = min(s0 + C, n_pre)
        o = dispatch_prefill(
            spec, q[:, :, s0:s1], *_operands(cell, buf),
            *_codec(cell, k[:, :, s0:s1], v[:, :, s0:s1]),
            lengths=torch.full((B,), s0, dtype=torch.int32),
            n_valid=torch.full((B,), s1 - s0, dtype=torch.int32),
            rolling=rolling)
        outs.append(o)
        for i in range(s0, s1):   # sequential writes: the layer's gating
            write(i, k[:, :, i], v[:, :, i])
    for i in range(n_pre, S):
        write(i, k[:, :, i], v[:, :, i])
        attn_len = min(i + 1, span) if rolling else i + 1
        o1 = dispatch_decode(spec, q[:, :, i], *_operands(cell, buf),
                             torch.full((B,), attn_len, dtype=torch.int32))
        outs.append(o1[:, :, None])
    return torch.cat(outs, dim=2)


def _run_paged(cell, q, k, v, window, spec):
    Hkv = k.shape[1]
    MB = -(-S // PS)
    nblk = B * MB + 3
    perm = np.random.default_rng(7).permutation(nblk)
    bt = torch.from_numpy(np.stack([perm[i * MB:(i + 1) * MB]
                                    for i in range(B)]).astype(np.int32))
    rows = slot_rows(bt, PS)
    pool = _buffers(cell, (nblk * PS, Hkv), k.shape[-1], v.shape[-1])

    def tok_major(t):   # (B, Hkv, n, .) -> (B*n, Hkv, .)
        return t.transpose(1, 2).reshape((-1, t.shape[1]) + t.shape[3:])

    def write(positions, kc, vc):
        wrows = token_rows(bt, positions, PS).reshape(-1)
        for name, val in _rows_of(cell, kc, vc).items():
            dst, val = pool[name], tok_major(val)
            if dst.dtype == torch.float8_e4m3fn:   # no CPU index_copy_
                dst, val = dst.view(torch.uint8), val.view(torch.uint8)
            scatter_rows(dst, wrows, val)

    outs = []
    n_pre = S - N_DEC
    for s0 in range(0, n_pre, C):
        s1 = min(s0 + C, n_pre)
        Cc = s1 - s0
        kc, vc = k[:, :, s0:s1], v[:, :, s0:s1]
        positions = s0 + torch.arange(Cc)[None, :].expand(B, Cc)
        o = dispatch_paged_prefill(
            spec, q[:, :, s0:s1], *_codec(cell, kc, vc),
            *_operands(cell, pool), rows, q_positions=positions,
            chunk_valid=torch.ones((B, Cc), dtype=torch.bool),
            lengths=torch.full((B,), s0, dtype=torch.int32),
            block_tables=bt, page_size=PS)
        outs.append(o)
        write(positions, kc, vc)
    for i in range(n_pre, S):
        write(torch.full((B, 1), i, dtype=torch.int32), k[:, :, i:i + 1],
              v[:, :, i:i + 1])
        o1 = dispatch_paged_decode(
            spec, q[:, :, i], *_operands(cell, pool), rows,
            torch.full((B,), i + 1, dtype=torch.int32), block_tables=bt,
            page_size=PS)
        outs.append(o1[:, :, None])
    return torch.cat(outs, dim=2)


_RUN_CACHE: dict = {}


def _run(cell: Cell, mode: str):
    key = (cell.variant, cell.kv_dtype, cell.layout, cell.family, mode)
    if key not in _RUN_CACHE:
        q, k, v, window = _data(cell)
        spec = _spec(cell, mode, window)
        if mode == "forward":
            out = dispatch_attention(spec, q, k, v, causal=True)
        elif cell.layout == "contiguous":
            out = _run_contiguous(cell, q, k, v, window, spec)
        else:
            out = _run_paged(cell, q, k, v, window, spec)
        _RUN_CACHE[key] = out
    return _RUN_CACHE[key]


def _pair_reference(cell: Cell):
    """(reference output, rows compared) of the fused-vs-gather check, or
    (None, 0) where the cell has no same-tile twin (fp32 contiguous
    ExpMul: the kernel is its own schedule)."""
    n_pre = S - N_DEC
    if cell.variant != "expmul":
        return _run(cell, "prefill_decode"), S
    if cell.layout == "paged":
        rows = S if cell.family != "windowed" else n_pre
        return _run(cell, "gather_pallas"), rows
    if cell.kv_dtype != "fp32":
        q, k, v, window = _data(cell)
        fcell = dataclasses.replace(cell, kv_dtype="fp32")
        out = _run_contiguous(fcell, q, fake_quant_kv(k, cell.kv_dtype),
                              fake_quant_kv(v, cell.kv_dtype), window,
                              _spec(fcell, "fused", window))
        return out, S
    return None, 0


@pytest.mark.parametrize("cell", [c for c in CELLS if not c.skip],
                         ids=lambda c: c.id)
def test_conformance_cell(cell: Cell):
    q, k, v, window = _data(cell)
    ref = _reference(cell, q, k, v, window)
    out = _run(cell, cell.mode)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(torch.max(torch.abs(out - ref)))
    assert err <= cell.ref_tol, (
        f"{cell.id}: |out - fp32 full-sequence ref| = {err:.3e} exceeds the "
        f"documented tolerance {cell.ref_tol:.0e}")
    if cell.mode == "fused":
        pair, nrows = _pair_reference(cell)
        if pair is not None:
            np.testing.assert_allclose(
                out[:, :, :nrows].numpy(), pair[:, :, :nrows].numpy(),
                atol=PAIR_TOL, rtol=PAIR_TOL,
                err_msg=f"{cell.id}: fused vs gather twin")


def test_pairs_that_are_bit_for_bit():
    """The fp32 paged ExpMul pairs are exactly equal (fused kernel and
    gather_pallas walk the same page-wide tiles over the same values)."""
    for cell in CELLS:
        if (cell.skip or cell.mode != "fused" or cell.variant != "expmul"
                or cell.layout != "paged" or cell.kv_dtype != "fp32"):
            continue
        pair, nrows = _pair_reference(cell)
        assert torch.equal(_run(cell, "fused")[:, :, :nrows],
                           pair[:, :, :nrows]), cell.id
