"""The CUDA kernels of ``repro_torch`` against their plain versions, on the
card (``cuda`` marker; every test skips without one). This file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and plain version sum both products in the same order
(``kernels/flash/tile.py:fma_chain``), and dyadic inputs make every score
exact (``kernels/checks.py``), so both variants are held at 1e-5 of the
output's magnitude, or at one bf16 ulp for the exact variant's bfloat16
output (``kernel_tol``); unallocated
pool pages hold NaN, so a paged kernel that reads one fails. Contiguous
caches hold large finite stale rows past each length instead (the
reference multiplies zero weights into them).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.checks import (  # noqa: E402
    contiguous_case,
    expmul_case,
    flash_case,
    flash_edge_cases,
    kernel_tol,
    paged_case,
    rel_err,
    run_contiguous_decode,
    run_contiguous_prefill,
    run_decode,
    run_expmul,
    run_flash,
    run_prefill,
    same_bits,
    sentinel_within,
)
from repro_torch.kernels.expmul.ops import merged_output_update  # noqa: E402
from repro_torch.kernels.flash.tile import fma_chain  # noqa: E402
from repro_torch.numerics.log2exp import expmul as expmul_bits  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


SHAPES = {16: dict(H=4, Hkv=2), 64: dict(H=14, Hkv=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_paged_decode_kernel_matches_plain(cuda, D, kv, variant, q_dtype):
    rng = np.random.default_rng(D)
    case = paged_case(rng, B=4, D=D, page_size=16, max_blocks=16,
                      lengths=[37, 0, 200, 16], kv=kv, q_dtype=q_dtype,
                      device=cuda, **SHAPES[D])
    before = build.COUNTS["paged_decode"]
    got = run_decode(case, variant)
    ref = run_decode(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["paged_decode"] == before + 1
    assert got.dtype == q_dtype
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[1].abs().max()) == 0.0            # the idle row


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_paged_prefill_kernel_matches_plain(cuda, D, kv, variant, q_dtype):
    rng = np.random.default_rng(D + 1)
    case = paged_case(rng, B=4, D=D, page_size=16, max_blocks=24,
                      lengths=[40, 0, 0, 129], n_valid=[70, 0, 33, 64],
                      chunk=70, kv=kv, q_dtype=q_dtype, device=cuda,
                      **SHAPES[D])
    before = build.COUNTS["paged_prefill"]
    got = run_prefill(case, variant)
    ref = run_prefill(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["paged_prefill"] == before + 1
    assert got.dtype == q_dtype
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[1].abs().max()) == 0.0            # the idle row


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_kernels_stop_at_table_width(cuda, variant):
    """Lengths past the table's span: both walks stop at its width."""
    rng = np.random.default_rng(8)
    kw = dict(B=2, D=16, page_size=16, max_blocks=4, kv="int8",
              device=cuda, **SHAPES[16])
    case = paged_case(rng, lengths=[64, 5], **kw)
    case["lengths"][0] = 64 + 40
    assert rel_err(run_decode(case, variant),
                   run_decode(case, variant, plain=True)) <= 1e-5
    case = paged_case(rng, lengths=[48, 5], n_valid=[16, 3], chunk=16, **kw)
    case["lengths"][0] = 64 + 7
    assert rel_err(run_prefill(case, variant),
                   run_prefill(case, variant, plain=True)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_kernels_windowed_match_plain(cuda, variant):
    """A local window: decode masks cols below length - window and skips
    whole pages under it; prefill masks per row and skips per block."""
    rng = np.random.default_rng(7)
    kw = dict(B=4, D=16, page_size=16, window=21, kv="int8", device=cuda,
              **SHAPES[16])
    case = paged_case(rng, max_blocks=16, lengths=[37, 0, 200, 16], **kw)
    assert rel_err(run_decode(case, variant),
                   run_decode(case, variant, plain=True)) <= 1e-5
    case = paged_case(rng, max_blocks=24, lengths=[40, 0, 0, 129],
                      n_valid=[70, 0, 33, 64], chunk=70, **kw)
    assert rel_err(run_prefill(case, variant),
                   run_prefill(case, variant, plain=True)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 7, 32])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_paged_decode_cluster_edges_match_plain(cuda, group, ps, kv, variant,
                                                q_dtype):
    """The cluster layout's edges over a 2,048-token table: lengths 0, 1,
    ps - 1, ps, ps + 1 and the full width (one or two rounds, idle ranks),
    and a sentinel inside a length (clamped to the last pool block); GQA
    groups 1, 7 and 32 (the most the kernel takes)."""
    mb = 2048 // ps
    lengths = [0, 1, ps - 1, ps, ps + 1, mb * ps, 5 * ps + 3]
    rng = np.random.default_rng(ps + group)
    case = paged_case(rng, B=len(lengths), H=2 * group, Hkv=2, D=64,
                      page_size=ps, max_blocks=mb, lengths=lengths, kv=kv,
                      q_dtype=q_dtype, dyadic=False, device=cuda)
    sentinel_within(case, len(lengths) - 1, 2)
    before = build.COUNTS["paged_decode"]
    got = run_decode(case, variant)
    ref = run_decode(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["paged_decode"] == before + 1
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[0].abs().max()) == 0.0             # the idle row


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_long_context_matches_plain(cuda, ps, kv, variant):
    """A 32,768-token context (Qwen2-0.5B's): 2,048 pages of 16 or 1,024
    of 32 in 32 rounds of the cluster, lengths ending inside a round; GQA
    group 7, bf16 q (the serving path's)."""
    lengths = [32768, 2305, 20001, 0]
    rng = np.random.default_rng(ps)
    case = paged_case(rng, B=len(lengths), H=14, Hkv=2, D=64, page_size=ps,
                      max_blocks=32768 // ps, lengths=lengths, kv=kv,
                      q_dtype=torch.bfloat16, dyadic=False, device=cuda)
    got = run_decode(case, variant)
    ref = run_decode(case, variant, plain=True)
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= kernel_tol(variant, torch.bfloat16)
    assert float(got[-1].abs().max()) == 0.0            # the idle row


@pytest.mark.cuda
def test_paged_decode_shared_memory_does_not_grow(cuda):
    """The kernel's own query: a CTA's shared memory is the same at 1,024
    and at 32,768 tokens of context (its chunk and partials only)."""
    import ctypes

    from repro_torch.kernels.decode import decode
    fn = build.load("paged_decode", decode._SIGNATURE).paged_decode_smem
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 5
    for group in (1, 7, 32):
        for kv in (0, 1, 2, 3):
            at = {fn(group, 64, ps, ctx // ps, kv) for ps in (16, 32)
                  for ctx in (1024, 32768)}
            assert len(at) == 1 and 0 < min(at) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 15, 100, 256])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_paged_prefill_chunk_edges_match_plain(cuda, C, kv, variant,
                                               q_dtype):
    """Chunks of C rows (not multiples of the 32-row query block) over 0,
    1 page and 1,000 tokens of history (several pages staged at once, the
    last partly); one row idle."""
    rng = np.random.default_rng(C + 1)
    case = paged_case(rng, B=4, D=64, page_size=16, max_blocks=128,
                      lengths=[0, 16, 1000, 0],
                      n_valid=[C, C, max(1, C // 3), 0], chunk=C, kv=kv,
                      q_dtype=q_dtype, dyadic=False, device=cuda,
                      **SHAPES[64])
    before = build.COUNTS["paged_prefill"]
    got = run_prefill(case, variant)
    ref = run_prefill(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["paged_prefill"] == before + 1
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got.view(4, -1)[3].abs().max()) == 0.0  # the idle row


@pytest.mark.cuda
def test_fma_chain_equals_raw_fmaf_chain(cuda, tmp_path):
    """The plain tile step's products (``fma_chain``), on the card and on
    the host, equal a raw ``fmaf`` chain kernel bit for bit, on operands
    where fused and unfused rounding differ (``tools/fma_witness.py``)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import fma_witness

    chain = fma_witness.fmaf_chain_kernel(tmp_path)
    rng = np.random.default_rng(0)
    for M, K, N in ((64, 64, 64), (33, 256, 65), (7, 16, 64)):
        a, b = (torch.from_numpy(x).to(cuda)
                for x in fma_witness.operands(rng, M, K, N))
        want = chain(a, b)
        assert same_bits(fma_chain(a, b), want)
        assert same_bits(fma_chain(a.cpu(), b.cpu()).to(cuda), want)


# ---------------------------------------------------------------------------
# contiguous caches
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_contiguous_decode_kernel_matches_plain(cuda, D, kv, variant,
                                                q_dtype):
    # two 256-wide tiles; ragged, idle (0), exactly S, stale rows past each
    rng = np.random.default_rng(D + 2)
    case = contiguous_case(rng, B=4, D=D, S=400, lengths=[37, 0, 400, 300],
                           kv=kv, q_dtype=q_dtype, device=cuda, **SHAPES[D])
    before = build.COUNTS["decode"]
    got = run_contiguous_decode(case, variant)
    ref = run_contiguous_decode(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["decode"] == before + 1
    assert got.dtype == q_dtype
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[1].abs().max()) == 0.0            # the idle row


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_contiguous_prefill_kernel_matches_plain(cuda, D, kv, variant,
                                                 q_dtype):
    # a fresh cache over two 512-wide tiles, ragged chunks, an idle row
    rng = np.random.default_rng(D + 3)
    case = contiguous_case(rng, B=4, D=D, S=600, lengths=[530, 0, 17, 600],
                           n_valid=[70, 0, 33, 64], chunk=70, kv=kv,
                           q_dtype=q_dtype, device=cuda, **SHAPES[D])
    before = build.COUNTS["prefill"]
    got = run_contiguous_prefill(case, variant)
    ref = run_contiguous_prefill(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["prefill"] == before + 1
    assert got.dtype == q_dtype
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("window,rolling", [(256, True), (100, True),
                                            (21, False)],
                         ids=["rolling", "rolling-narrow", "fresh-window"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_contiguous_prefill_windows_match_plain(cuda, variant, window,
                                                rolling, kv):
    """Rolling buffers of span 256: one wrapped (length 1000), one shorter
    than the span, one empty, one full; a 300-token chunk, longer than
    the span. A fresh cache with a window skips whole tiles per block."""
    rng = np.random.default_rng(9)
    lengths = [1000, 100, 0, 256] if rolling else [200, 100, 0, 256]
    case = contiguous_case(rng, B=4, D=64, S=256, lengths=lengths,
                           n_valid=[300, 7, 0, 300], chunk=300, kv=kv,
                           window=window, rolling=rolling, device=cuda,
                           **SHAPES[64])
    assert rel_err(run_contiguous_prefill(case, variant),
                   run_contiguous_prefill(case, variant, plain=True)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S,group", [(2048, 1), (2048, 7), (2048, 32),
                                     (32768, 7)],
                         ids=["S2048-group1", "S2048-group7",
                              "S2048-group32", "S32768-group7"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_contiguous_decode_cluster_tiles_match_plain(cuda, S, group, kv,
                                                     variant, q_dtype):
    """One cluster of 8 CTAs per (sequence, KV head), one 256-wide tile a
    rank in a round. S = 2048: lengths 1, 255, 256, 257, 1024, 2048 and 0
    read 1 to 8 tiles, so some ranks are idle, and one row none; GQA
    groups 1, 7 and 32 (the most the kernel takes). S = 32768 (Qwen2-0.5B's
    context): 128 tiles in 16 rounds, lengths ending inside a round. The
    kernel's shared memory does not grow with S, so every case launches."""
    lengths = ([1, 255, 256, 257, 1024, 2048, 0] if S == 2048
               else [S, 2305, S // 2 + 1, 0])
    rng = np.random.default_rng(S + group)
    case = contiguous_case(rng, B=len(lengths), H=2 * group, Hkv=2, D=64,
                           S=S, lengths=lengths, kv=kv, q_dtype=q_dtype,
                           dyadic=False, device=cuda)
    before = build.COUNTS["decode"]
    got = run_contiguous_decode(case, variant)
    ref = run_contiguous_decode(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["decode"] == before + 1
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[-1].abs().max()) == 0.0            # the idle row


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 15, 100])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_contiguous_prefill_ragged_chunks_match_plain(cuda, C, kv, variant,
                                                      q_dtype):
    """Chunks of C rows, not a multiple of the kernel's 32-row query block,
    over cache tiles of 512 (S = 1100: the last one ragged); float32 and
    bf16 q over float32 values, bf16 values and int8 codes; one row idle
    (n_valid 0). The plain version sums as the kernel does at every shape
    (``fma_chain``), the 15-row chunk included."""
    rng = np.random.default_rng(C)
    case = contiguous_case(rng, B=3, D=64, S=1100, lengths=[1100, 0, 700],
                           n_valid=[C, 0, max(1, C // 3)], chunk=C, kv=kv,
                           q_dtype=q_dtype, dyadic=False, device=cuda,
                           **SHAPES[64])
    before = build.COUNTS["prefill"]
    got = run_contiguous_prefill(case, variant)
    ref = run_contiguous_prefill(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS["prefill"] == before + 1
    assert rel_err(got, ref) <= kernel_tol(variant, q_dtype)
    assert float(got[1].abs().max()) == 0.0             # the idle row


# ---------------------------------------------------------------------------
# the training path's full-sequence forward
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "cross"])
@pytest.mark.parametrize("block_k", [32, 128, 512])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, D, mask, block_k, variant, dtype):
    """Sq = Sk = 200 (ragged against every tile width: K padded, the last
    tile partly masked), causal, causal with a 48-token window, and
    non-causal with 120 queries over 200 keys; GQA 6/2."""
    rng = np.random.default_rng(D + block_k)
    Sq, causal, window = {"causal": (200, True, None),
                          "window": (200, True, 48),
                          "cross": (120, False, None)}[mask]
    for dyadic in (True, False):
        case = flash_case(rng, B=2, H=6, Hkv=2, Sq=Sq, Sk=200, D=D,
                          dtype=dtype, dyadic=dyadic, causal=causal,
                          window=window, block_k=block_k, device=cuda)
        before = build.COUNTS["flash"]
        got = run_flash(case, variant)
        ref = run_flash(case, variant, plain=True)
        torch.cuda.synchronize()
        assert build.COUNTS["flash"] == before + 1
        assert got.dtype == dtype and got.shape == ref.shape
        assert rel_err(got, ref) <= kernel_tol(variant, dtype), dyadic


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 31, 33, 65, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_layout_edges_match_plain(cuda, S, D, group, variant,
                                               dtype):
    """The register-tiled layout's edges (``checks.flash_edge_cases``):
    Sq = Sk off the 32-row query block and the 64-row sub-tile, a window
    ending inside a sub-tile, keys past ``kv_len`` (stale rows) causal and
    not, GQA groups 1 and 7, dyadic and random."""
    rng = np.random.default_rng(S * 1000 + D * 10 + group)
    for dyadic in (True, False):
        for label, case in flash_edge_cases(rng, S=S, D=D, group=group,
                                            dtype=dtype, dyadic=dyadic,
                                            device=cuda):
            before = build.COUNTS["flash"]
            got = run_flash(case, variant)
            ref = run_flash(case, variant, plain=True)
            torch.cuda.synchronize()
            assert build.COUNTS["flash"] == before + 1
            assert got.dtype == dtype and got.shape == ref.shape
            assert rel_err(got, ref) <= kernel_tol(variant, dtype), \
                (label, dyadic)


@pytest.mark.cuda
def test_flash_kernel_checks_shared_memory_before_launch(cuda, monkeypatch):
    """A shape whose shared memory a block exceeds the card's raises
    ValueError through the kernel's own query (``flash_smem``), before any
    launch: here a card that allows one byte less than D 128 at 512-wide
    tiles needs."""
    from repro_torch.kernels.flash import flash
    need = flash.smem_bytes(128, 512)
    assert need == 124928 and flash.smem_bytes(64, 512) == 100352
    assert need <= flash.card_smem_limit(cuda)
    monkeypatch.setattr(flash, "card_smem_limit", lambda device: need - 1)
    case = flash_case(np.random.default_rng(0), B=1, H=2, Hkv=1, Sq=600,
                      Sk=1024, D=128, block_k=512, device=cuda)
    before = build.COUNTS["flash"]
    with pytest.raises(ValueError, match="shared memory"):
        run_flash(case, "expmul")
    assert build.COUNTS["flash"] == before
    case = flash_case(np.random.default_rng(0), B=1, H=2, Hkv=1, Sq=600,
                      Sk=1024, D=128, block_k=256, device=cuda)
    run_flash(case, "expmul")                  # narrower tiles fit
    assert build.COUNTS["flash"] == before + 1


@pytest.mark.cuda
def test_flash_kernel_rejects_wide_tiles(cuda):
    case = flash_case(np.random.default_rng(0), B=1, H=2, Hkv=1, Sq=600,
                      Sk=600, D=64, block_k=600, device=cuda)
    with pytest.raises(ValueError, match="block_k"):
        run_flash(case, "expmul")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_head_dim_32_matches_plain(cuda, variant, dtype):
    """Head dim 32, the fidelity study's: its shape (8 x 64 tokens, 4 / 2
    heads, one 64-wide tile) and a ragged causal 200 over 128-wide tiles."""
    rng = np.random.default_rng(32)
    for B, S, block_k in ((8, 64, 64), (2, 200, 128)):
        for dyadic in (True, False):
            case = flash_case(rng, B=B, H=4, Hkv=2, Sq=S, Sk=S, D=32,
                              dtype=dtype, dyadic=dyadic, causal=True,
                              block_k=block_k, device=cuda)
            before = build.COUNTS["flash"]
            got = run_flash(case, variant)
            ref = run_flash(case, variant, plain=True)
            torch.cuda.synchronize()
            assert build.COUNTS["flash"] == before + 1
            assert rel_err(got, ref) <= kernel_tol(variant, dtype), dyadic


# ---------------------------------------------------------------------------
# the standalone ExpMul operator
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (8, 16), (32, 64),
                                   (128, 256), (257, 130), (64, 1024),
                                   (300, 65), (4096, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_expmul_kernel_bit_identical_to_plain(cuda, shape, dtype):
    """Kernel, plain version and frexp/ldexp oracle, raw bits, with the
    contract's edge values (``checks.expmul_case``); odd widths take the
    kernel's scalar path, the others its 16-byte vectors."""
    x, v = expmul_case(np.random.default_rng(shape[0] + shape[1]), *shape,
                       dtype=dtype, device=cuda)
    before = build.COUNTS["expmul"]
    got, plain, oracle = run_expmul(x, v)
    torch.cuda.synchronize()
    assert build.COUNTS["expmul"] == before + 1
    assert got.dtype == dtype and got.shape == v.shape
    assert same_bits(got, plain) and same_bits(got, oracle)
    # a misaligned view (rows of an odd column offset) is copied, not refused
    view = v[:, 1:]
    assert same_bits(run_expmul(x, view)[0], run_expmul(x, view)[1])


@pytest.mark.cuda
def test_merged_output_update_kernel_matches_bit_path(cuda):
    rng = np.random.default_rng(5)
    rows = 1000
    o_star = torch.from_numpy(rng.standard_normal((rows, 65)).astype(
        np.float32)).to(cuda)
    v_star = torch.from_numpy(rng.standard_normal((rows, 65)).astype(
        np.float32)).to(cuda)
    m_prev = torch.from_numpy(rng.uniform(-3, 1, rows).astype(
        np.float32)).to(cuda)
    m_cur = torch.maximum(m_prev, torch.zeros_like(m_prev))
    s = m_cur - torch.from_numpy(rng.uniform(0, 18, rows).astype(
        np.float32)).to(cuda)
    before = build.COUNTS["expmul"]
    got = merged_output_update(o_star, v_star, m_prev, m_cur, s)
    want = (expmul_bits((m_prev - m_cur)[:, None], o_star)
            + expmul_bits((s - m_cur)[:, None], v_star))
    torch.cuda.synchronize()
    assert build.COUNTS["expmul"] == before + 2
    assert same_bits(got, want)
