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
reference multiplies zero weights into them). At the engine level, the
shared-prefix cache on the two paged kernels: warm streams equal cold
ones, and the kernel engine's equal the plain engine's on spliced and
copied-on-write block tables. The compiled ticks: an engine whose ticks
replay CUDA graphs equals one with eager ticks bit for bit, and counts
each replay's launches. MLA: the contiguous kernels at minicpm3-4b's head
dims (K rows of 96, V rows of 64) against their plain versions, codes and
pairs off the builds, and a narrow MLA config's graph ticks. arctic-480b: the four
serving kernels at its head dim 128, GQA groups 1, 7 and 32 (a paged
decode whose group does not fit a block's shared memory runs in parts),
on poisoned pages too, and its smoke config's MoE ticks, at head
dim 128, captured in CUDA graphs. recurrentgemma-2b: the four serving
kernels at its local attention (10 / 1 heads of 256, a 2,048-token window,
a wrapped rolling buffer), its smoke config's hybrid ticks captured in
CUDA graphs, and its RG-LRU state written in place by every replay.
kimi-k2-1t-a32b: the four serving kernels at its head dim 112, GQA groups
1 and 8, on poisoned pages too, and a narrowed kimi (8 / 1 heads of 112,
16 experts top-8) served through the kernels against the plain versions.
The encoder-decoder and frontend archs: flash non-causal at Sq != Sk (an
encoder-decoder's cross-attention), the cross-attention decode's one-pass
plain route on the card against the CPU, and the smoke configs of
llava-next-34b and seamless-m4t-medium through the kernels against the
plain versions. Training: flash at head dims 96, 112 and 256, and one
train step of every arch's smoke config through the kernel against one
through the plain version; flash at a query offset (a rank's rows of a
query-split call) against the whole call's rows and the plain version.
The contract: every kernel at the inputs its Pallas kernel takes past the
widths it is built for (``checks.CONTRACT_SHAPES``: head dims off the
builds, Dv != D over codes, GQA groups split into parts, pages up to 256,
rows off 16 bytes) against its plain version, and D, Dv or a page past
256 refused before any launch.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import MLAConfig, MoEConfig, get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.checks import (  # noqa: E402
    CONTRACT_FLASH_DIMS,
    CONTRACT_SHAPES,
    contiguous_case,
    contract_case,
    expmul_case,
    head_dim_cases,
    flash_case,
    flash_cross_cases,
    flash_edge_cases,
    kernel_tol,
    MLA_DIMS,
    mla_cases,
    one_pass_case,
    POISON_SPOTS,
    SERVING_KERNELS,
    paged_case,
    poisoned_case,
    rel_err,
    rows_rel_err,
    run_contiguous_decode,
    run_contiguous_prefill,
    run_decode,
    run_expmul,
    run_flash,
    run_prefill,
    same_bits,
    sentinel_within,
    windowed_cases,
)
from repro_torch.core.attention import decode_one_pass  # noqa: E402
from repro_torch.kernels.expmul.ops import merged_output_update  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash.tile import fma_chain  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.api import init_model  # noqa: E402
from repro_torch.numerics.log2exp import expmul as expmul_bits  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

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
@pytest.mark.parametrize("D", [16, 64, 96, 112, 128, 256])
@pytest.mark.parametrize("mask", ["causal", "window", "cross"])
@pytest.mark.parametrize("block_k", [32, 128, 512])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, D, mask, block_k, variant, dtype):
    """Sq = Sk = 200 (ragged against every tile width: K padded, the last
    tile partly masked), causal, causal with a 48-token window, and
    non-causal with 120 queries over 200 keys; GQA 6/2; head dims 96 and
    112 on the value side's padding to 128, 256 on the staging at the
    step."""
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
@pytest.mark.parametrize("D", [16, 32, 64, 96, 112, 128, 256])
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
@pytest.mark.parametrize("D", [64, 112, 256])
@pytest.mark.parametrize("window", [None, 48], ids=["causal", "window"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_query_offset(cuda, D, window, variant, dtype):
    """The flash kernel on rows a: of a causal call at ``q_offset=a``
    (a rank's rows of a query-split call): equal bit for bit to rows a:
    of the whole call at a = 128 and 256 (multiples of the 128-row query
    block), and within ``kernel_tol`` of the plain version at the same
    offset at a = 100 and 200, Sq = Sk = 384, GQA 6 / 2, tiles of 128."""
    rng = np.random.default_rng(D + 7)
    case = flash_case(rng, B=2, H=6, Hkv=2, Sq=384, Sk=384, D=D, dtype=dtype,
                      dyadic=False, causal=True, window=window, block_k=128,
                      device=cuda)
    q, k, v = case["q"], case["k"], case["v"]

    def call(a, plain=False):
        return flash_attention_fwd(q[:, :, a:].contiguous(), k, v,
                                   causal=True, window=window,
                                   variant=variant, block_k=128, q_offset=a,
                                   plain=plain)

    whole = call(0)
    for a in (128, 256):
        before = build.COUNTS["flash"]
        got = call(a)
        torch.cuda.synchronize()
        assert build.COUNTS["flash"] == before + 1
        assert torch.equal(got, whole[:, :, a:]), a
    for a in (100, 200):
        got, ref = call(a), call(a, plain=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape
        assert rel_err(got, ref) <= kernel_tol(variant, dtype), a


@pytest.mark.cuda
@pytest.mark.parametrize("D,group", [(64, 1), (128, 7), (96, 1), (112, 8),
                                     (256, 1)])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_cross_attention_shapes_match_plain(cuda, D, group,
                                                         variant, dtype):
    """Non-causal at Sq != Sk (``checks.flash_cross_cases``): 1, 7 and 33
    queries (off the 32-row query block) over 16 and 1,024 keys, at
    seamless-m4t-medium's D 64 group 1 and llava-next-34b's D 128 group
    7, and at the head dims of minicpm3-4b (96), kimi-k2-1t-a32b (112,
    group 8) and gemma-7b (256), dyadic and random."""
    rng = np.random.default_rng(D + group)
    for dyadic in (True, False):
        for label, case in flash_cross_cases(rng, D=D, group=group,
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
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_one_pass_decode_on_the_card_matches_cpu(cuda, variant, dtype):
    """The cross-attention decode's route (plain ops on every device) on
    CUDA tensors against its CPU result, at seamless-m4t-medium's cross
    K/V, lengths 0, 1, 1,024 and ragged."""
    case = one_pass_case(np.random.default_rng(3), dtype=dtype)
    names = ("q", "k", "v", "lengths")
    ref = decode_one_pass(*(case[n] for n in names), variant=variant)
    before = dict(build.COUNTS)
    got = decode_one_pass(*(case[n].to(cuda) for n in names),
                          variant=variant)
    assert got.device.type == "cuda" and dict(build.COUNTS) == before
    assert not got[0].any()                        # length 0: zeros
    # the card sums in another order than the CPU: float32 within 1e-5, a
    # bfloat16 result one rounding step apart at most (kernel_tol's bound
    # for the exact variant's bfloat16 output), under ExpMul too
    assert rel_err(got.cpu(), ref) <= kernel_tol("exact", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-medium"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_frontend_archs_smoke_kernels_match_plain(cuda, arch, variant):
    """The smoke configs (float32) through the kernels against the plain
    versions: ``forward`` with frontend embeddings (llava: prepended;
    seamless: encoded, and attended to by cross-attention); for seamless
    ``encode_for_decode`` and four ``decode_step``s, each launching one
    decode kernel a decoder layer and nothing else."""
    base = get_config(arch, smoke=True, dtype="float32",
                      param_dtype="float32", attention_variant=variant)
    params = init_model(base, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    B = 3
    batch = {"tokens": torch.randint(1, base.vocab_size, (B, 40),
                                     generator=gen, device=cuda),
             "frontend_embeds": torch.randn(
                 (B, base.frontend_tokens, base.frontend_dim),
                 generator=gen, device=cuda)}
    logits = {}
    for impl in ("kernel", "plain"):
        cfg = base.replace(attention_impl=impl)
        build.reset_counts()
        with torch.no_grad():
            logits[impl] = api.forward(params, batch, cfg)
        flash = base.encoder_layers + 2 * base.decoder_layers or \
            base.num_layers
        assert build.COUNTS["flash" if impl == "kernel" else
                            "flash_plain"] == flash
    assert rel_err(logits["kernel"], logits["plain"]) <= 1e-5
    if not base.encoder_layers:
        return
    enc_len = torch.tensor([16, 9, 12], dtype=torch.int32, device=cuda)
    steps = {}
    for impl in ("kernel", "plain"):
        cfg = base.replace(attention_impl=impl)
        state = api.init_decode_state(cfg, B, 8, enc_len=16, device=cuda)
        with torch.no_grad():
            state = api.encode_for_decode(params, state,
                                          batch["frontend_embeds"], enc_len,
                                          cfg)
            out = []
            for t in range(4):
                build.reset_counts()
                lg, state = api.decode_step(
                    params, state, batch["tokens"][:, t],
                    torch.full((B,), t, dtype=torch.int32, device=cuda),
                    cfg)
                name = "decode" if impl == "kernel" else "decode_plain"
                assert dict(build.COUNTS) == {name: base.decoder_layers}
                out.append(lg)
        steps[impl] = torch.stack(out)
    assert rel_err(steps["kernel"], steps["plain"]) <= 1e-5


@pytest.mark.cuda
def test_flash_kernel_checks_shared_memory_before_launch(cuda, monkeypatch):
    """A shape whose shared memory a block exceeds the card's raises
    ValueError through the kernel's own query (``flash_smem``), before any
    launch: here a card that allows one byte less than D 128 at 512-wide
    tiles needs."""
    from repro_torch.kernels.flash import flash
    need = flash.smem_bytes(128, 512)
    assert need == 124928 and flash.smem_bytes(64, 512) == 100352
    # 96 and 112 stage V rows at 128 features; 256 fits one block an SM
    assert [flash.smem_bytes(d, 512) for d in (96, 112, 256)] == \
        [120832, 122880, 174080]
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
@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_serving_kernels_at_gemma_head_dims_match_plain(cuda, D, kv, variant,
                                                        q_dtype):
    """The four serving kernels at gemma-7b's head dims (32 smoke, 256
    full) and its 16 / 16 heads (``checks.head_dim_cases``): lengths across
    the decode's 256-wide and the prefill's 512-wide tiles, an idle row, a
    chunk with no valid token."""
    for name, run, case, idle, label in head_dim_cases(
            np.random.default_rng(D), D, kv=kv, q_dtype=q_dtype,
            device=cuda):
        got = run(case, variant)
        ref = run(case, variant, plain=True)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= kernel_tol(variant, q_dtype), name
        for i in idle:
            assert float(got[i].abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_serving_kernels_at_head_dim_256_group_4_match_plain(cuda, kv,
                                                             variant):
    for name, run, case, idle, label in head_dim_cases(
            np.random.default_rng(4), 256, kv=kv, group=4,
            q_dtype=torch.bfloat16, device=cuda):
        got = run(case, variant)
        ref = run(case, variant, plain=True)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= kernel_tol(variant, torch.bfloat16), name


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 7, 32])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_serving_kernels_at_head_dim_128_match_plain(cuda, group, kv,
                                                     variant):
    """The four serving kernels at arctic-480b's head dim 128, over GQA
    groups 1 (8 / 8 heads), 7 (56 / 8, arctic's, bfloat16 q) and 32 (32 /
    1) and ``head_dim_cases``' lengths. A group whose rows do not fit one
    block's shared memory (32 over float32 and bfloat16 pools in the paged
    decode) runs split into parts of one launch."""
    q_dtype = torch.bfloat16 if group == 7 else torch.float32
    for name, run, case, idle, label in head_dim_cases(
            np.random.default_rng(group), 128, kv=kv, q_dtype=q_dtype,
            group=group, H=8 * group if group < 32 else 32, device=cuda):
        got = run(case, variant)
        ref = run(case, variant, plain=True)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= kernel_tol(variant, q_dtype), name
        for i in idle:
            assert float(got[i].abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SERVING_KERNELS)
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_serving_kernels_at_head_dim_128_keep_plain_nonfinite_rows(
        cuda, kernel, kv):
    """A poisoned page (or the rows past the length) at head dim 128: the
    kernel's non-finite output rows are its plain version's, its finite
    rows within ``kernel_tol``."""
    for spot in POISON_SPOTS:
        case, run = poisoned_case(np.random.default_rng(11), kernel, spot,
                                  kv=kv, D=128, device=cuda)
        for variant in ("exact", "expmul"):
            got = run(case, variant)
            ref = run(case, variant, plain=True)
            torch.cuda.synchronize()
            assert not bool(torch.isfinite(ref[0]).all()), spot
            assert bool(torch.isfinite(ref[1:]).all()), spot
            assert rows_rel_err(got, ref) <= kernel_tol(
                variant, torch.float32), (spot, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_serving_kernels_at_head_dim_112_match_plain(cuda, group, kv,
                                                     variant, dyadic):
    """The four serving kernels at kimi-k2-1t-a32b's head dim 112 (28
    feature groups: the prefills' value side padded to 128, the contiguous
    decode's K rows in two depth steps of 56), over GQA groups 1 (8 / 8
    heads, float32 q) and 8 (64 / 8, kimi's, bfloat16 q) and
    ``head_dim_cases``' lengths."""
    q_dtype = torch.bfloat16 if group == 8 else torch.float32
    for name, run, case, idle, label in head_dim_cases(
            np.random.default_rng(group), 112, kv=kv, q_dtype=q_dtype,
            group=group, H=8 * group, dyadic=dyadic, device=cuda):
        before = build.COUNTS[name]
        got = run(case, variant)
        ref = run(case, variant, plain=True)
        torch.cuda.synchronize()
        assert build.COUNTS[name] == before + 1
        assert got.shape[-1] == 112
        assert rel_err(got, ref) <= kernel_tol(variant, q_dtype), name
        for i in idle:
            assert float(got[i].abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SERVING_KERNELS)
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_serving_kernels_at_head_dim_112_keep_plain_nonfinite_rows(
        cuda, kernel, kv):
    """A poisoned page (or the rows past the length) at head dim 112: the
    kernel's non-finite output rows are its plain version's, its finite
    rows within ``kernel_tol``."""
    for spot in POISON_SPOTS:
        case, run = poisoned_case(np.random.default_rng(11), kernel, spot,
                                  kv=kv, D=112, device=cuda)
        for variant in ("exact", "expmul"):
            got = run(case, variant)
            ref = run(case, variant, plain=True)
            torch.cuda.synchronize()
            assert not bool(torch.isfinite(ref[0]).all()), spot
            assert bool(torch.isfinite(ref[1:]).all()), spot
            assert rows_rel_err(got, ref) <= kernel_tol(
                variant, torch.float32), (spot, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_contiguous_kernels_at_mla_head_dims_match_plain(cuda, kv, variant,
                                                         q_dtype, dyadic):
    """The contiguous decode and prefill at minicpm3-4b's head dims, 96 /
    64 (``checks.mla_cases``): lengths 0, 1, 300 and S, stale rows past
    each, a partial chunk and one with no valid token."""
    for name, run, case, idle, label in mla_cases(
            np.random.default_rng(13), kv=kv, q_dtype=q_dtype, dyadic=dyadic,
            device=cuda):
        before = build.COUNTS[name]
        got = run(case, variant)
        ref = run(case, variant, plain=True)
        torch.cuda.synchronize()
        assert build.COUNTS[name] == before + 1
        assert tuple(got.shape[-1:]) == (MLA_DIMS[1],)
        assert rel_err(got, ref) <= kernel_tol(variant, q_dtype), name
        for i in idle:
            assert float(got[i].abs().max()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("spot", POISON_SPOTS)
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_contiguous_kernels_at_mla_head_dims_keep_plain_nonfinite_rows(
        cuda, kernel, spot, variant):
    D, Dv = MLA_DIMS
    case, run = poisoned_case(np.random.default_rng(11), kernel, spot,
                              kv="bf16", D=D, Dv=Dv, H=4, Hkv=4, device=cuda)
    got = run(case, variant)
    ref = run(case, variant, plain=True)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref).all())
    assert rows_rel_err(got, ref) <= kernel_tol(variant, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("kv,dims", [("int8", MLA_DIMS), ("fp8", MLA_DIMS),
                                     ("f32", (64, 32)), ("bf16", (96, 96))])
def test_contiguous_kernels_refuse_unbuilt_pairs_before_launch(cuda, kernel,
                                                               kv, dims):
    """Codes at Dv != D and (D, Dv) pairs off the built widths, once
    refused, now launch and keep the plain version's numbers; V rows past
    256 raise a ValueError before any launch."""
    pf = dict(n_valid=[5, 5], chunk=5) if kernel == "prefill" else {}
    run = run_contiguous_prefill if kernel == "prefill" else \
        run_contiguous_decode
    for Dv, ok in ((dims[1], True), (257, False)):
        case = contiguous_case(np.random.default_rng(0), B=2, H=4, Hkv=4,
                               D=dims[0], Dv=Dv, S=64, lengths=[40, 7],
                               kv=kv, device=cuda, dyadic=False, **pf)
        before = dict(build.COUNTS)
        if not ok:
            with pytest.raises(ValueError, match="outside"):
                run(case, "expmul")
            assert dict(build.COUNTS) == before
            continue
        got = run(case, "expmul")
        assert build.COUNTS[kernel] == before.get(kernel, 0) + 1
        ref = run(case, "expmul", plain=True)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= kernel_tol("expmul", torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SERVING_KERNELS)
def test_serving_kernels_check_shared_memory_before_launch(cuda, kernel,
                                                           monkeypatch):
    """A launch whose shared memory a block exceeds the card's raises
    ValueError through the kernel's own query, before any launch: here a
    card that allows one byte less than head dim 256 needs; head dim 32,
    which needs less, still launches."""
    from repro_torch.kernels.decode import decode
    from repro_torch.kernels.flash import prefill
    need = {"paged_decode": lambda: decode.paged_decode_smem(
                1, 256, 16, 43, torch.float32),
            "decode": lambda: decode.contiguous_decode_smem(
                1, 256, 256, torch.float32),
            "paged_prefill": lambda: prefill.paged_prefill_smem(256),
            "prefill": lambda: prefill.contiguous_prefill_smem(256, 512)
            }[kernel]()
    assert 0 < need <= decode.card_smem_limit(cuda)
    monkeypatch.setattr(decode, "card_smem_limit", lambda device: need - 1)
    cases = {hd: {n: (run, case) for n, run, case, _, _ in head_dim_cases(
        np.random.default_rng(hd), hd, kv="f32", device=cuda)}
        for hd in (32, 256)}
    run, case = cases[256][kernel]
    before = build.COUNTS[kernel]
    with pytest.raises(ValueError, match="shared memory"):
        run(case, "expmul")
    assert build.COUNTS[kernel] == before
    run, case = cases[32][kernel]
    run(case, "expmul")
    assert build.COUNTS[kernel] == before + 1


@pytest.mark.cuda
def test_flash_kernel_refuses_an_unbuilt_head_dim(cuda):
    """A head dim past the kernel's limit (257) raises a ValueError before
    any launch; 80, off its built widths, launches and keeps the plain
    version's numbers."""
    rng = np.random.default_rng(0)
    case = flash_case(rng, B=1, H=2, Hkv=1, Sq=64, Sk=64, D=257, block_k=64,
                      device=cuda)
    before = build.COUNTS["flash"]
    with pytest.raises(ValueError, match="outside"):
        run_flash(case, "expmul")
    assert build.COUNTS["flash"] == before
    case = flash_case(rng, B=1, H=2, Hkv=1, Sq=64, Sk=64, D=80, block_k=64,
                      dyadic=False, device=cuda)
    got = run_flash(case, "expmul")
    assert build.COUNTS["flash"] == before + 1
    ref = run_flash(case, "expmul", plain=True)
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= kernel_tol("expmul", torch.float32)


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


# -- the shared-prefix cache through the paged kernels ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", SERVING_KERNELS)
@pytest.mark.parametrize("spot", POISON_SPOTS)
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_serving_kernels_keep_plain_nonfinite_rows(cuda, kernel, spot, kv,
                                                   variant):
    """A poisoned KV page (NaN values, or int8 codes of -128 with NaN
    scales) in the first, a middle or the last page sequence 0 reads, or
    in its rows past the length: the kernel's non-finite output rows are
    exactly its plain version's (the reference's maxima propagate NaN),
    and its finite rows within ``kernel_tol``."""
    case, run = poisoned_case(np.random.default_rng(11), kernel, spot, kv=kv,
                              device=cuda)
    before = build.COUNTS[kernel]
    got = run(case, variant)
    ref = run(case, variant, plain=True)
    torch.cuda.synchronize()
    assert build.COUNTS[kernel] == before + 1
    assert not bool(torch.isfinite(ref[0]).all())     # the fault shows
    assert bool(torch.isfinite(ref[1:]).all())        # and stays in its row
    assert rows_rel_err(got, ref) <= kernel_tol(variant, torch.float32)


def _smoke_engine(cuda, variant, kv_dtype, impl="kernel", **kw):
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32", attention_variant=variant)
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    return ServeEngine(params, cfg, kv_layout="paged", kv_dtype=kv_dtype,
                       attention_impl=impl, eager_ticks=impl == "plain",
                       device=cuda, **kw)


def _shared_prompts(shared_len, tails, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 200, shared_len).tolist()
    return shared, [shared + rng.integers(1, 200, n).tolist() for n in tails]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefix_cache_warm_equals_cold_on_kernels(cuda, variant, kv_dtype):
    """Warm temp-0 streams (prefix pages spliced from a seeding request)
    equal cold ones with every tick on the two paged kernels."""
    shared, prompts = _shared_prompts(40, (7, 7, 7, 7), 0)

    def run(warm):
        eng = _smoke_engine(cuda, variant, kv_dtype, slots=2, max_len=96,
                            chunk_size=8, page_size=4)
        assert eng.prefix_cache
        if warm:
            eng.submit(prompts[0][:43], 4, rid=-1)
            eng.run()
        build.reset_counts()
        reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
        eng.run()
        counts = build.launch_counts()
        assert counts.get("paged_prefill") and counts.get("paged_decode")
        assert set(counts) == {"paged_prefill", "paged_decode"}, counts
        eng.pool.check_consistency()
        return eng, [r.out for r in reqs]

    _, cold = run(False)
    warm_eng, warm = run(True)
    assert warm == cold
    assert warm_eng.memory_stats()["prefix_hit_tokens"] >= 4 * 40


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefix_cache_kernel_streams_equal_plain_on_cow_tables(
        cuda, variant, kv_dtype):
    """On spliced block tables with copied-on-write pages, a tight pool
    that reclaims cached blocks and preempts, the kernel engine's streams
    equal the plain engine's."""
    shared, prompts = _shared_prompts(22, (5, 9, 3, 11, 6), 7)
    kw = dict(slots=3, max_len=48, chunk_size=6, page_size=4,
              pool_blocks={"fp32": 14, "int8": 4}[kv_dtype])
    streams, stats = [], []
    for impl in ("kernel", "plain"):
        eng = _smoke_engine(cuda, variant, kv_dtype, impl, **kw)
        eng.submit(shared + [7], 2, rid=100)
        reqs = [eng.submit(p, 5, rid=i) for i, p in enumerate(prompts)]
        eng.run()
        eng.pool.check_consistency()
        streams.append([r.out for r in reqs])
        stats.append(eng.memory_stats())
    assert streams[0] == streams[1]
    assert stats[0]["cow_copies"] > 0 and stats[0]["preemptions"] > 0
    assert stats[0]["cow_copies"] == stats[1]["cow_copies"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_chaos_quarantines_only_the_victims_on_kernels(cuda, variant):
    """The chaos matrix's corruption faults through the two paged kernels
    (int8 pool): ``kv_corrupt`` on one request and ``logits`` on another
    fail exactly those two, the pool is scrubbed, consistent and empty
    after the run, every other stream equals the fault-free run's, and the
    whole outcome equals the plain engine's under the same schedule."""
    from repro_torch.serve.faults import ChaosInjector, install_fault_injector
    prompts = [list(np.random.default_rng(s).integers(1, 200, 12))
               for s in range(4)]
    kw = dict(slots=2, max_len=64, chunk_size=8, page_size=4,
              pool_blocks=24)

    def run(impl, schedule):
        eng = _smoke_engine(cuda, variant, "int8", impl, **kw)
        install_fault_injector(None if schedule is None
                               else ChaosInjector(**schedule))
        try:
            build.reset_counts()
            reqs = [eng.submit(p, 8, rid=i) for i, p in enumerate(prompts)]
            eng.run(max_steps=500)
        finally:
            install_fault_injector(None)
        counts = build.launch_counts()
        eng.pool.check_consistency()
        assert eng.pool.used_blocks == 0
        for cache in eng.state["caches"]:
            for leaf in cache.values():
                assert bool(torch.isfinite(leaf.float()).all())
        return ([(r.finish_reason, r.out) for r in reqs],
                eng.metrics_snapshot()["quarantined"], counts)

    base, _, _ = run("kernel", None)
    schedule = dict(at={"kv_corrupt": [4], "logits": [5]},
                    rids={"kv_corrupt": {2}, "logits": {0}})
    got, quarantined, counts = run("kernel", schedule)
    assert set(counts) == {"paged_prefill", "paged_decode"}, counts
    assert quarantined == 2
    assert [reason for reason, _ in got] == ["failed", "length", "failed",
                                             "length"]
    assert got[1] == base[1] and got[3] == base[3]
    assert run("plain", schedule)[:2] == (got, quarantined)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_snapshot_round_trip_on_kernels(cuda, layout, tmp_path):
    """A mid-flight snapshot restored into a fresh engine on the card
    continues every stream exactly, through the layout's two kernels."""
    from repro_torch.serve.snapshot import restore_engine
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    kw = dict(slots=2, max_len=64, chunk_size=8, kv_dtype="int8",
              device=cuda)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=4, pool_blocks=32)
    prompts = [list(np.random.default_rng(s).integers(1, 200, 12))
               for s in range(3)]

    oracle = ServeEngine(params, cfg, **kw)
    expect = [oracle.submit(p, 8).out for p in prompts]
    oracle.run()
    eng = ServeEngine(params, cfg, **kw)
    for p in prompts:
        eng.submit(p, 8)
    for _ in range(3):
        eng.tick()
    path = str(tmp_path / "engine.npz")
    eng.save_snapshot(path)
    restored = restore_engine(path, params, cfg, device=cuda)
    assert restored.state["caches"][0]["k"].device.type == "cuda"
    carried = [r for r in restored.requests if r is not None]
    carried += list(restored.queue)
    build.reset_counts()
    restored.run()
    pair = ({"paged_prefill", "paged_decode"} if layout == "paged"
            else {"prefill", "decode"})
    assert set(build.COUNTS) <= pair and build.COUNTS
    for r in carried:
        assert r.finish_reason == "length" and r.out == expect[r.rid]


# -- the compiled ticks: CUDA graphs against eager ticks ----------------------

GRAPH_CELLS = {
    "paged/int8": dict(kv_layout="paged", page_size=16, kv_dtype="int8"),
    "contiguous/fp32": dict(kv_layout="contiguous", kv_dtype="fp32"),
    "contiguous/int8": dict(kv_layout="contiguous", kv_dtype="int8"),
}


def _graph_run(cuda, cell, eager, prompts, fn_wrap=None, arch="qwen2-0.5b",
               cfg=None):
    """Serve ``prompts`` (8 new tokens each) on a smoke ``arch`` (bf16,
    ExpMul) engine, or on ``cfg``, over ``GRAPH_CELLS[cell]`` (or the
    paged fp32 pool of "paged/fp32"); returns (engine, streams, every
    tick's logits, the launch counts)."""
    cfg = cfg or get_config(arch, smoke=True)
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    layout = GRAPH_CELLS.get(cell) or dict(kv_layout="paged", page_size=16,
                                           kv_dtype="fp32")
    eng = ServeEngine(params, cfg, slots=4, max_len=128, chunk_size=32,
                      eager_ticks=eager, device=cuda, **layout)
    ticks = []
    chaos = eng._chaos_logits

    def hook(active, logits):
        ticks.append(logits.clone())
        return chaos(active, logits)

    eng._chaos_logits = hook
    build.reset_counts()
    reqs = [eng.submit(p, 8, rid=i) for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    return eng, [r.out for r in reqs], ticks, build.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/int8", "contiguous/fp32"])
def test_gemma_smoke_graph_ticks_equal_eager_ticks(cuda, cell):
    """gemma-7b's smoke config (head dim 32, GeGLU, scaled embeddings)
    served with CUDA-graph ticks: every tick's logits the eager engine's
    bit for bit, on the layout's two kernels alone."""
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts,
                                        arch="gemma-7b")
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             arch="gemma-7b")
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    assert gcounts == counts
    assert set(gcounts) == ({"paged_prefill", "paged_decode"}
                            if cell.startswith("paged") else
                            {"prefill", "decode"})
    assert eng.graph_stats()["decode"]["replays"] == eng.decode_steps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/int8", "contiguous/fp32"])
def test_mla_graph_ticks_equal_eager_ticks(cuda, cell):
    """A narrow MLA config with minicpm3-4b's head dims (qk 64 + 32, v 64;
    2 layers, 4 heads, d_model 64) served with CUDA-graph ticks: every
    tick's logits the eager engine's bit for bit, and on either layout the
    contiguous decode and prefill alone (the pool holds latents)."""
    cfg = get_config("minicpm3-4b", smoke=True).replace(
        mla=MLAConfig(q_lora_rank=24, kv_lora_rank=16, qk_rope_dim=32,
                      qk_nope_dim=64, v_head_dim=64))
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts, cfg=cfg)
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             cfg=cfg)
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    assert gcounts == counts and set(gcounts) == {"prefill", "decode"}
    st = eng.graph_stats()
    assert st["decode"]["replays"] == eng.decode_steps > 0
    assert st["decode"]["launches_per_replay"] == {"decode": cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/int8", "contiguous/fp32"])
def test_arctic_smoke_graph_ticks_equal_eager_ticks(cuda, cell):
    """arctic-480b's smoke config (4 experts, top-2, a dense residual, an
    untied head) at its full head dim, 128, served with CUDA-graph ticks:
    the MoE routes every row of a tick without a host read, so the ticks
    capture; every tick's logits the eager engine's bit for bit, on the
    layout's two kernels alone, one launch a layer a replay."""
    cfg = get_config("arctic-480b", smoke=True).replace(head_dim=128)
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts, cfg=cfg)
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             cfg=cfg)
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    pair = ({"paged_prefill", "paged_decode"} if cell.startswith("paged")
            else {"prefill", "decode"})
    assert gcounts == counts and set(gcounts) == pair
    st = eng.graph_stats()
    assert st["decode"]["replays"] == eng.decode_steps > 0
    assert st["prefill"]["replays"] == eng.prefill_steps > 0
    dec, pre = sorted(pair)
    assert build.launch_counts(
        st["decode"]["launches_per_replay"]) == {dec: cfg.num_layers}
    assert build.launch_counts(
        st["prefill"]["launches_per_replay"]) == {pre: cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/int8", "contiguous/fp32"])
def test_kimi_narrow_kernels_match_plain(cuda, cell):
    """kimi-k2-1t-a32b narrowed to 8 / 1 heads of its head dim 112 (GQA
    group 8) over 16 experts at top-8, float32, served through the kernels
    under CUDA graphs and through the plain versions with eager ticks:
    every tick's logits within 1e-4 of their magnitude and the streams
    equal, the kernel run on its layout's two kernels alone, one launch a
    layer a replay."""
    base = get_config("kimi-k2-1t-a32b", smoke=True, dtype="float32",
                      param_dtype="float32")
    cfg = base.replace(num_layers=2, d_model=896, num_heads=8,
                       num_kv_heads=1, vocab_size=256,
                       moe=MoEConfig(num_experts=16, top_k=8, d_ff=64))
    assert cfg.resolved_head_dim() == 112
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(
        cuda, cell, True, prompts, cfg=cfg.replace(attention_impl="plain"))
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             cfg=cfg)
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert rel_err(a, b) <= 1e-4, f"tick {i + 1}"
    pair = ({"paged_prefill", "paged_decode"} if cell.startswith("paged")
            else {"prefill", "decode"})
    assert set(gcounts) == pair and set(counts) == {f"{n}_plain"
                                                    for n in pair}
    st = eng.graph_stats()
    dec, pre = sorted(pair)
    assert build.launch_counts(
        st["decode"]["launches_per_replay"]) == {dec: cfg.num_layers}
    assert build.launch_counts(
        st["prefill"]["launches_per_replay"]) == {pre: cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/fp32", "contiguous/fp32"])
def test_recurrentgemma_smoke_graph_ticks_equal_eager_ticks(cuda, cell):
    """recurrentgemma-2b's smoke config (RG-LRU, RG-LRU, local attention
    over a window of 32; MQA; a softcap) served with CUDA-graph ticks over
    prompts past the window: every tick's logits the eager engine's bit
    for bit, on the layout's two kernels alone, one launch a replay in
    its one attention layer."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts, cfg=cfg)
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             cfg=cfg)
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    pair = ({"paged_prefill", "paged_decode"} if cell.startswith("paged")
            else {"prefill", "decode"})
    assert gcounts == counts and set(gcounts) == pair
    st = eng.graph_stats()
    assert st["decode"]["replays"] == eng.decode_steps > 0
    dec, pre = sorted(pair)
    assert build.launch_counts(
        st["decode"]["launches_per_replay"]) == {dec: 1}
    assert build.launch_counts(
        st["prefill"]["launches_per_replay"]) == {pre: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/fp32", "contiguous/fp32"])
def test_recurrent_state_is_written_in_place_by_replays(cuda, cell):
    """The engine's RG-LRU tensors are the ones the graphs write: after
    each replayed tick they hold the eager engine's values bit for bit
    (a step that rebound them would leave them at their admission zeros),
    at the addresses they had before the capture."""
    _state_written_in_place(cuda, cell,
                            get_config("recurrentgemma-2b", smoke=True))


def _state_written_in_place(cuda, cell, cfg):
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    layout = GRAPH_CELLS.get(cell) or dict(kv_layout="paged", page_size=16,
                                           kv_dtype="fp32")
    prompts = [list(np.random.default_rng(3).integers(1, 256, n))
               for n in (45, 9)]
    engines = [ServeEngine(params, cfg, slots=2, max_len=96, chunk_size=16,
                           eager_ticks=eager, device=cuda, **layout)
               for eager in (False, True)]
    addrs = [t.data_ptr() for t in engines[0]._recurrent]
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(p, 6, rid=i)
    moved = 0
    while any([e.tick() for e in engines]):     # both, in lockstep
        torch.cuda.synchronize()
        g, e = engines
        for a, b in zip(g._recurrent, e._recurrent):
            assert torch.equal(a, b)
        moved += any(bool(t.abs().sum() > 0) for t in g._recurrent)
    assert moved > 0
    assert [t.data_ptr() for t in engines[0]._recurrent] == addrs
    assert engines[0].graph_stats()["decode"]["replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/fp32", "contiguous/fp32"])
def test_xlstm_smoke_graph_ticks_equal_eager_ticks(cuda, cell):
    """xlstm-1.3b's smoke config (seven mLSTM blocks and one sLSTM block,
    no attention layer) served with CUDA-graph ticks: every tick's logits
    the eager engine's bit for bit, and no kernel launched (none lies on
    this path)."""
    cfg = get_config("xlstm-1.3b", smoke=True)
    prompts = [list(np.random.default_rng(2).integers(1, 256, n))
               for n in (40, 7, 66)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts, cfg=cfg)
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts,
                                             cfg=cfg)
    assert gout == out and len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    assert not any(gcounts.values()) and not any(counts.values())
    st = eng.graph_stats()
    assert st["decode"]["replays"] == eng.decode_steps > 0
    assert st["prefill"]["replays"] == eng.prefill_steps > 0
    assert st["decode"]["launches_per_replay"] == {}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged/fp32", "contiguous/fp32"])
def test_xlstm_state_is_written_in_place_by_replays(cuda, cell):
    """The engine's mLSTM and sLSTM tensors (``C``, ``n``, ``m``; ``c``,
    ``n``, ``h``, ``m``) are the ones the graphs write, as for RG-LRU."""
    _state_written_in_place(cuda, cell, get_config("xlstm-1.3b", smoke=True))


@pytest.mark.cuda
def test_xlstm_layouts_give_equal_ticks(cuda):
    """With no attention layer the two layouts run the same arithmetic:
    paged and contiguous graph ticks' logits equal bit for bit, and the
    streams."""
    cfg = get_config("xlstm-1.3b", smoke=True)
    prompts = [list(np.random.default_rng(4).integers(1, 256, n))
               for n in (21, 50, 9, 33)]
    _, pout, plogits, _ = _graph_run(cuda, "paged/fp32", False, prompts,
                                     cfg=cfg)
    _, cout, clogits, _ = _graph_run(cuda, "contiguous/fp32", False,
                                     prompts, cfg=cfg)
    assert pout == cout and len(plogits) == len(clogits) > 2
    for i, (a, b) in enumerate(zip(plogits, clogits)):
        assert torch.equal(a, b), f"tick {i + 1}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_serving_kernels_at_recurrentgemma_shapes_match_plain(cuda, kv,
                                                              variant,
                                                              q_dtype):
    """recurrentgemma-2b's local attention: GQA group 10 at head dim 256,
    a 2,048-token window over histories of 1,024-3,584 tokens (floors
    inside a page and a tile), a wrapped rolling buffer, an idle row."""
    rng = np.random.default_rng(21)
    for name, run, case, idle, label in windowed_cases(
            rng, kv=kv, q_dtype=q_dtype, dyadic=kv == "f32", device=cuda):
        got = run(case, variant)
        assert rel_err(got, run(case, variant, plain=True)) <= kernel_tol(
            variant, q_dtype), f"{name} {label}"
        assert all(float(got[i].abs().max()) == 0.0 for i in idle), name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(GRAPH_CELLS))
def test_graph_ticks_equal_eager_ticks(cuda, cell):
    """Temp-0 streams, and every tick's logits, of an engine replaying CUDA
    graphs are the eager engine's bit for bit (the same kernels, GEMMs and
    order; the first ticks are a prefill and, after it, decodes); the
    launch counts are equal, each replay's captured launches once."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 200, int(n)).tolist()
               for n in rng.integers(20, 90, 6)]
    _, out, logits, counts = _graph_run(cuda, cell, True, prompts)
    eng, gout, glogits, gcounts = _graph_run(cuda, cell, False, prompts)
    assert gout == out
    assert len(glogits) == len(logits) > 2
    for i, (a, b) in enumerate(zip(glogits, logits)):
        assert torch.equal(a, b), f"tick {i + 1}"
    assert gcounts == counts
    st = eng.graph_stats()
    pair = ({"paged_prefill", "paged_decode"} if cell.startswith("paged")
            else {"prefill", "decode"})
    want = {}
    for kind in ("prefill", "decode"):
        assert st[kind]["captured"] and st[kind]["replays"] > 0
        assert st[kind]["replays"] == getattr(eng, f"{kind}_steps")
        for name, n in build.launch_counts(
                st[kind]["launches_per_replay"]).items():
            want[name] = want.get(name, 0) + n * st[kind]["replays"]
    assert gcounts == want and set(gcounts) == pair
    dec, pre = sorted(pair)
    layers = eng.cfg.num_layers
    assert build.launch_counts(
        st["prefill"]["launches_per_replay"]) == {pre: layers}
    assert build.launch_counts(
        st["decode"]["launches_per_replay"]) == {dec: layers}


@pytest.mark.cuda
def test_plain_impl_needs_eager_ticks_on_the_card(cuda):
    cfg = get_config("qwen2-0.5b", smoke=True)
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    with pytest.raises(ValueError, match="eager_ticks"):
        ServeEngine(params, cfg, attention_impl="plain", device=cuda)
    eng = ServeEngine(params, cfg, attention_impl="plain", eager_ticks=True,
                      device=cuda)
    eng.submit([1, 2, 3], 2)
    eng.run()
    assert not eng.graph_stats()["prefill"]["captured"]


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A tick that reads a value on the host cannot be captured: the tick
    raises, and nothing runs it eagerly instead."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    eng = ServeEngine(params, cfg, kv_layout="paged", page_size=16,
                      device=cuda)
    fn = eng._prefill_graph.fn

    def syncing(**kw):
        out = fn(**kw)
        int(kw["lengths"].max())            # a host read: capture refuses it
        return out

    eng._prefill_graph.fn = syncing
    eng.submit([1, 2, 3, 4], 2)
    with pytest.raises(RuntimeError):
        eng.tick()
    assert eng.ticks == 0 and eng._prefill_graph.graph is None
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# training every arch on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b", "gemma-7b",
                                  "minicpm3-4b", "arctic-480b",
                                  "kimi-k2-1t-a32b", "recurrentgemma-2b",
                                  "xlstm-1.3b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_train_step_kernel_matches_plain(cuda, arch):
    """One train step of each arch's smoke config in float32 through the
    flash kernel against one through its plain version, from the same
    weights and batch (a frontend config with seeded frontend embeddings):
    the loss within 1e-5 and the grad norm within 1e-4 of their values;
    the kernel run launches flash twice an attention call (the forward and
    its recompute) and no plain version."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step, make_train_state

    cfg = get_config(arch, smoke=True, dtype="float32", param_dtype="float32")
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                        device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 80),
                                     generator=g, device=cuda)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            (2, cfg.frontend_tokens, cfg.frontend_dim), generator=g,
            device=cuda)
    calls = (cfg.pattern_for(cfg.encoder_layers).count("attn")
             + 2 * cfg.decoder_layers if cfg.encoder_layers
             else cfg.pattern_for().count("attn"))
    opt = adamw(1e-3, moment_dtype=cfg.opt_state_dtype)
    out = {}
    for impl in ("kernel", "plain"):
        build.reset_counts()
        step = build_train_step(cfg.replace(attention_impl=impl), opt)
        _, m = step(make_train_state(params, opt), batch)
        out[impl] = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        if impl == "kernel":
            assert {k: n for k, n in build.COUNTS.items() if n} == (
                {"flash": 2 * calls} if calls else {})
    assert abs(out["kernel"]["loss"] - out["plain"]["loss"]) <= \
        1e-5 * abs(out["plain"]["loss"])
    assert abs(out["kernel"]["grad_norm"] - out["plain"]["grad_norm"]) <= \
        1e-4 * abs(out["plain"]["grad_norm"])


CONTRACT_CASES = [
    (name, D, Dv, kv, group, ps) for D, Dv, kvs, group, pages, names
    in CONTRACT_SHAPES for kv in kvs for ps in pages for name in names]


@pytest.mark.cuda
@pytest.mark.parametrize("name,D,Dv,kv,group,ps", CONTRACT_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_serving_kernels_take_the_pallas_contract(cuda, name, D, Dv, kv,
                                                  group, ps, variant):
    """A serving kernel at a width off its builds, Dv != D over codes, a
    group split into parts or a page over 64 tokens: within
    ``kernel_tol`` of its plain version (bfloat16 q), its idle row 0. The
    paged pair on its general walk (some cases also qualify for the
    whole-row walk, which ``test_paged_whole_row_walk_*`` holds)."""
    run, case, idle = contract_case(np.random.default_rng(D + group + ps),
                                    name, D=D, Dv=Dv, kv=kv, group=group,
                                    page_size=ps, device=cuda)
    before = dict(build.COUNTS)
    with build.forced_walk("general"):
        got = run(case, variant)
    assert build.COUNTS[name] == before.get(name, 0) + 1
    assert build.COUNTS[name + build.WHOLE] == before.get(
        name + build.WHOLE, 0)
    ref = run(case, variant, plain=True)
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= kernel_tol(variant, torch.bfloat16)
    assert all(float(got[i].abs().max()) == 0.0 for i in idle)


@pytest.mark.cuda
@pytest.mark.parametrize("D", CONTRACT_FLASH_DIMS)
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_flash_kernel_takes_head_dims_off_its_builds(cuda, D, variant):
    case = flash_case(np.random.default_rng(D), B=2, H=4, Hkv=2, Sq=200,
                      Sk=256, D=D, dtype=torch.bfloat16, dyadic=False,
                      block_k=128, device=cuda)
    got = run_flash(case, variant)
    ref = run_flash(case, variant, plain=True)
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= kernel_tol(variant, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVING_KERNELS)
@pytest.mark.parametrize("what", ["D", "Dv", "page"])
def test_serving_kernels_refuse_past_the_contract(cuda, name, what):
    """D 257, Dv 257 or a page of 257 tokens: a ValueError naming the
    limit, before any launch (the contiguous kernels have no pages: D 257
    there once more)."""
    dims, ps = {"D": (dict(D=257, Dv=None), 16),
                "Dv": (dict(D=64, Dv=257), 16),
                "page": (dict(D=64, Dv=None), 257)}[what]
    if what == "page" and not name.startswith("paged"):
        dims, ps = dict(D=257, Dv=None), 16
    run, case, _ = contract_case(np.random.default_rng(0), name, kv="int8",
                                 page_size=ps, device=cuda, **dims)
    before = dict(build.COUNTS)
    with pytest.raises(ValueError, match="outside"):
        run(case, "expmul")
    assert dict(build.COUNTS) == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paged_decode", "paged_prefill"])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_whole_row_walk_is_the_general_walk_bit_for_bit(cuda, name, ps,
                                                              variant):
    """At the main shapes (D 64, int8 codes, 14 / 2 heads, bfloat16 q) a
    call takes the whole-row walk (its count moves), and its output is the
    forced general walk's bit for bit."""
    rng = np.random.default_rng(ps)
    common = dict(B=4, H=14, Hkv=2, D=64, page_size=ps,
                  max_blocks=2048 // ps, kv="int8", q_dtype=torch.bfloat16,
                  dyadic=False, device=cuda)
    if name == "paged_decode":
        run, case = run_decode, paged_case(rng, lengths=[1000, 0, 517, 1],
                                           **common)
    else:
        run, case = run_prefill, paged_case(
            rng, lengths=[700, 0, 0, 300], n_valid=[256, 0, 100, 17],
            chunk=256, **common)
    whole = name + build.WHOLE
    before = dict(build.COUNTS)
    got = run(case, variant)
    with build.forced_walk("general"):
        gen = run(case, variant)
    torch.cuda.synchronize()
    assert build.COUNTS[name] == before.get(name, 0) + 2
    assert build.COUNTS[whole] == before.get(whole, 0) + 1
    assert same_bits(got, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paged_decode", "paged_prefill"])
def test_paged_forced_whole_row_walk_off_the_builds_raises(cuda, name):
    """A forced whole-row walk at a contract shape off the built widths
    (D 80) is refused by the kernel before any launch and raises; the same
    call unforced launches on the general walk."""
    run, case, _ = contract_case(np.random.default_rng(0), name, D=80,
                                 kv="int8", device=cuda)
    before = dict(build.COUNTS)
    with build.forced_walk("whole"), pytest.raises(RuntimeError,
                                                   match="cudaError"):
        run(case, "expmul")
    assert dict(build.COUNTS) == before
    run(case, "expmul")
    torch.cuda.synchronize()
    assert build.COUNTS[name] == before.get(name, 0) + 1
    assert build.COUNTS[name + build.WHOLE] == before.get(
        name + build.WHOLE, 0)
