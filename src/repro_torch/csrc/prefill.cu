// Contiguous chunked prefill: a chunk of C fresh queries per sequence against
// [per-slot KV cache ++ the chunk's own KV], with no concatenated copy, for
// fresh caches (slot j holds position j) and for rolling-window buffers.
//
// Replaces the Pallas TPU kernel kernels/flash/prefill.py:245
// (prefill_fwd_pallas, body _prefill_kernel at :107).
//
// What bounds it on the card: operations. Each chunk query scores every
// resident and earlier chunk key, ~4 * D operations per (query, key) pair:
// at qwen2-0.5b's serving shapes (8 sequences x 256-token chunks over 1k
// tokens of history, 14 heads of 64) that is ~8.5 GFLOP per layer against
// ~10 MB of bytes, far above the card's ridge.
//
// The exactness rule: the plain version's tile step (kernels/flash/tile.py)
// sums both products as fmaf chains, the scores in depth order and the
// values in column order (fma_chain). An ExpMul weight is a rounded function
// of its score, and a bfloat16 output is rounded too, so another summation
// order can fail the checks' 1e-5 (kernels/checks.py:kernel_tol): the scores
// on the tensor cores flip ExpMul weights, and the value product in another
// order flips bfloat16 outputs (tools/prefill_study.py measures both on the
// card, on its own copy of this kernel). So both products are fmaf chains in
// the plain version's order on the CUDA cores, register-tiled
// (tile_sm90.cuh: Stage, score_block, value_block, shared with
// csrc/paged_prefill.cu; the whole tile step, chunk_tile_step, shared with
// csrc/flash.cu).
//
// Design: one CTA of 128 threads per (sequence, query head, 32 chunk rows),
// two CTAs an SM. It walks the reference's KV tiles, bk = min(512, max(S,
// C, 1)) columns each (the ExpMul results depend on the width): cache tiles
// [0, bk), ... below min(length, S), then chunk tiles from the chunk start
// below n_valid and the block's last row; a tile reads only those columns,
// so stale rows are never read and nothing is padded. Each tile is staged
// in sub-tiles of 64 rows (K for the scores, then V for the values), the
// next sub-tile's 16-byte global loads in flight in registers while the
// current one is computed on, then converted to float32 in shared memory.
// The tile's scores (32 rows x bk, 64 KB) stay in shared memory, so the row
// max, the weights and the rescale are taken once per reference tile, as
// tile.py does. Scores: each thread a 4 x 4 block of (rows, columns);
// weights: four threads a row; values: each thread a 4 x 4 block of (rows,
// features), all in registers. Masks, per row:
//   cache, rolling = 0:  col < length (and length + row - col < window)
//   cache, rolling = 1:  pos = last - ((last - col) mod S), last = length - 1,
//                        valid iff pos >= 0 (and length + row - pos < window);
//                        the mod is Python's (never negative)
//   chunk:               col < n_valid, col <= row (and row - col < window)
// The query block (32 rows, not the reference's min(128, C)) changes only
// which wholly masked tiles are skipped.
#include <type_traits>

#include "tile_sm90.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;     // chunk rows per CTA (two CTAs an SM)
constexpr int kSub = kStageRows;      // KV rows staged at once
constexpr int kPad = kStagePad;       // floats of padding on staged rows
constexpr int kPLd = kScoreLd;        // row stride of the transposed scores

template <int D>
constexpr size_t smem_bytes(int bk) {
  return sizeof(float) * (kRows * (D + kPad) + static_cast<size_t>(bk) * kPLd +
                          kSub * (D + kPad) + kSub + bk + 2 * kRows);
}

// One tile of the walk: its first column (in the cache or in the chunk) and
// its width below the segment's end.
struct Tile {
  int c0, nr;
  bool chunk;
};

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const KV* __restrict__ kn, const KV* __restrict__ vn,
               const float* __restrict__ ksn, const float* __restrict__ vsn,
               const int* __restrict__ lens, const int* __restrict__ nvalid,
               void* __restrict__ out, int H, int Hkv, int C, int S, int bk, int window,
               int rolling, float scale, int act_dtype, int vec16) {
  constexpr bool QUANT = IsCode<KV>::value;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                             // [kRows][D + kPad]
  float* p_s = q_s + kRows * (D + kPad);         // [bk][kPLd]: scores, then weights
  float* x_s = p_s + bk * kPLd;                  // [kSub][D + kPad]: staged K or V
  float* sc_s = x_s + kSub * (D + kPad);         // [kSub]: its scale rows
  float* vt_s = sc_s + kSub;                     // [bk]: the tile's v scales
  float* r_s = vt_s + bk;                        // [kRows]: each row's rescale
  float* l_s = r_s + kRows;                      // [kRows]: each row's l

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - r0);
  const int tid = threadIdx.x;
  const int length = lens[b];
  const int n_valid = min(nvalid[b], C);
  const int64_t cache0 = static_cast<int64_t>(kvh) * S;
  const int64_t chunk0 = static_cast<int64_t>(kvh) * C;
  const int cache_end = min(length, S);
  const int chunk_end = min(n_valid, r0 + kRows);
  const int n_cache = (cache_end + bk - 1) / bk;
  const int n_cand = n_cache + (chunk_end + bk - 1) / bk;
  const int last = length - 1;

  // candidate tile i of the walk; false for a tile wholly below the window
  // of the block's lowest row
  const auto tile_at = [&](int i, Tile& t) {
    t.chunk = i >= n_cache;
    t.c0 = (t.chunk ? i - n_cache : i) * bk;
    t.nr = min(bk, (t.chunk ? chunk_end : cache_end) - t.c0);
    if (window <= 0) return true;
    if (t.chunk) return !(t.c0 + bk <= r0 - window);
    return rolling || !(t.c0 + bk <= length + r0 - window);
  };
  const auto valid = [&](const Tile& t, int r, int j) {
    const int col = t.c0 + j;
    if (t.chunk) {
      const int row = r0 + r;
      return col <= row && (window <= 0 || row - col < window);
    }
    int pos = col;  // fresh cache: col < length holds for the columns read
    if (rolling) {
      pos = last - py_mod(last - col, S);
      if (pos < 0) return false;
    }
    return window <= 0 || length + r0 + r - pos < window;
  };
  // staging step i: the K sub-tiles of a tile, then its V sub-tiles
  const auto step_at = [&](int i, const KV*& src, const float*& sc, int& nrows) {
    for (int ci = 0; ci < n_cand; ++ci) {
      Tile t;
      if (!tile_at(ci, t)) continue;
      const int ns = (t.nr + kSub - 1) / kSub;
      if (i < 2 * ns) {
        const bool is_v = i >= ns;
        const int sub = is_v ? i - ns : i;
        const int64_t r = (t.chunk ? chunk0 : cache0) + t.c0 + sub * kSub;
        src = (t.chunk ? (is_v ? vn : kn) : (is_v ? vc : kc)) + r * D;
        sc = QUANT ? (t.chunk ? (is_v ? vsn : ksn) : (is_v ? vsc : ksc)) + r : nullptr;
        nrows = min(kSub, t.nr - sub * kSub);
        return true;
      }
      i -= 2 * ns;
    }
    return false;
  };

  Stage<KV, D> stage;
  int step = 0;
  {
    const KV* src;
    const float* sc;
    int nrows;
    if (step_at(0, src, sc, nrows)) stage.fetch(src, sc, nrows, vec16);
  }
  // the staged rows of the current step into x_s, the next step's in flight
  const auto advance = [&]() {
    __syncthreads();  // the previous step's readers of x_s are done
    stage.commit(x_s, sc_s);
    __syncthreads();
    const KV* src;
    const float* sc;
    int nrows;
    if (step_at(++step, src, sc, nrows)) stage.fetch(src, sc, nrows, vec16);
  };

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * (D + kPad) + d] =
        r < rows ? load_act(q, (static_cast<int64_t>(bh) * C + r0 + r) * D + d, act_dtype)
                 : 0.0f;
  }
  __syncthreads();

  ChunkRows<D> st;
  for (int ci = 0; ci < n_cand; ++ci) {
    Tile t;
    if (!tile_at(ci, t)) continue;
    // a fresh cache without a window: every column read is valid
    const bool dense = !t.chunk && !rolling && window <= 0;
    const float* vscale = nullptr;
    if constexpr (QUANT) vscale = (t.chunk ? vsn + chunk0 : vsc + cache0) + t.c0;
    chunk_tile_step<D, EXPMUL, QUANT>(st, q_s, p_s, x_s, sc_s, vt_s, r_s, vscale, t.nr, scale,
                                      dense, advance,
                                      [&](int r, int j) { return valid(t, r, j); });
  }
  st.store(out, (static_cast<int64_t>(bh) * C + r0) * D, l_s, rows, act_dtype);
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* kc, const void* vc, const float* ksc, const float* vsc,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* lens,
           const int* nvalid, void* out, int B, int H, int Hkv, int C, int S, int bk,
           int window, int rolling, float scale, int act_dtype, cudaStream_t stream) {
  auto kernel = prefill_kernel<KV, D, EXPMUL>;
  static bool wide_smem = false;  // once per instantiation: room for the widest tile
  if (!wide_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxTile)));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem = true;
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc) |
                        reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn);
  const dim3 grid(B * H, (C + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem_bytes<D>(bk), stream>>>(
      q, static_cast<const KV*>(kc), static_cast<const KV*>(vc), ksc, vsc,
      static_cast<const KV*>(kn), static_cast<const KV*>(vn), ksn, vsn, lens, nvalid, out, H,
      Hkv, C, S, bk, window, rolling, scale, act_dtype, (any & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const void* kn, const void* vn, const float* ksn,
           const float* vsn, const int* lens, const int* nvalid, void* out, int B, int H,
           int Hkv, int C, int S, int bk, int window, int rolling, float scale, int act_dtype,
           cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                    \
  return expmul ? launch<KV, DIM, true>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid, \
                                        out, B, H, Hkv, C, S, bk, window, rolling, scale,   \
                                        act_dtype, s)                                       \
                : launch<KV, DIM, false>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens,       \
                                         nvalid, out, B, H, Hkv, C, S, bk, window, rolling, \
                                         scale, act_dtype, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 64: REPRO_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (B*H, C, D) f32/bf16; cache kc/vc (B*Hkv, S, D) of kv_dtype and its
// scale rows ksc/vsc (B*Hkv, S) f32 for codes; chunk kn/vn (B*Hkv, C, D) of
// kv_dtype and ksn/vsn (B*Hkv, C) f32 for codes; lens / nvalid (B,) i32;
// bk the KV tile width (<= kMaxTile); window <= 0: none; rolling: the cache
// is a rolling buffer of span S; out (B*H, C, D) in q's dtype. With
// rolling = 0 the caller keeps length <= S. Returns the cudaError_t of the
// launch.
extern "C" int contiguous_prefill(const void* q, const void* kc, const void* vc,
                                  const float* ksc, const float* vsc, const void* kn,
                                  const void* vn, const float* ksn, const float* vsn,
                                  const int* lens, const int* nvalid, void* out, int B, int H,
                                  int Hkv, int C, int D, int S, int bk, int window, int rolling,
                                  float scale, int expmul, int act_dtype, int kv_dtype,
                                  void* stream) {
  if (B <= 0 || C <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bk <= 0 || bk > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid, out,
                           B, H, Hkv, C, S, bk, window, rolling, scale, act_dtype, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens,
                                   nvalid, out, B, H, Hkv, C, S, bk, window, rolling, scale,
                                   act_dtype, s);
    case kI8:
      return by_dim<int8_t>(D, expmul, q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid,
                            out, B, H, Hkv, C, S, bk, window, rolling, scale, act_dtype, s);
    case kFP8:
      return by_dim<__nv_fp8_e4m3>(D, expmul, q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens,
                                   nvalid, out, B, H, Hkv, C, S, bk, window, rolling, scale,
                                   act_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that contiguous_prefill gives each CTA
// at tile width bk (independent of S and C); -1 for an unsupported D.
extern "C" long long contiguous_prefill_smem(int D, int bk) {
  switch (D) {
    case 16: return static_cast<long long>(smem_bytes<16>(bk));
    case 64: return static_cast<long long>(smem_bytes<64>(bk));
    default: return -1;
  }
}
