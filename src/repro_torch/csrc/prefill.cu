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
// two CTAs an SM (one at head dims 112, 128 and 256: 124,928, 126,976 and
// 176,128 B of shared memory a CTA). It walks the reference's KV tiles,
// bk = min(512, max(S, C, 1)) columns each (the ExpMul results depend on the
// width): cache tiles [0, bk), ... below min(length, S), then chunk tiles
// from the chunk start below n_valid and the block's last row. A cache tile
// reads all its columns (to S), its stale rows past the length too, weighed
// 0 into the value product as the plain version does (so a NaN row there
// reaches the output); a chunk tile reads only the columns below its end,
// and nothing is padded. Each tile is staged
// in sub-tiles of 64 rows (K for the scores, then V for the values), the
// next sub-tile's 16-byte global loads in flight in registers while the
// current one is computed on, then converted to float32 in shared memory
// (at head dim 256, float32 and bfloat16 rows are loaded and converted when
// their step begins: a thread's accumulators take 128 registers there).
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
//
// K rows may be wider than V rows (MLA's expanded latents: DK 96, DV 64, as
// the reference's kernel takes them): q is staged at DK, both K and V
// sub-tiles at one stride of staged_width(DK, DV) + 4 floats (the x_s
// buffer holds either), the scores walk DK features, the values and the output DV.
// Built for (W, W) with W in {16, 32, 64, 112, 128, 256} over every KV dtype,
// and for (96, 64) over float32 and bfloat16 KV only. A call at any head dims
// D, Dv <= 256 runs the narrowest build that holds them (by_dims): it reads D
// K and Dv V features a row, stages zeros in the rest of the built width
// (Stage, RowBytes), and stores Dv output features; the zeros add fmaf(0, 0,
// acc) = acc to every chain, so the result is the plain version's at (D, Dv).
// At D 112 (kimi-k2-1t-a32b: 28 feature groups, which do not
// share out over 128 threads) the staged rows are 128 floats wide, the 16
// past D zero, and the value side runs D 128's layout, storing only the
// first 112 features (tile_sm90.cuh:value_width): 14% more value fmafs and
// staged floats, every stored output the plain version's chain.
#include <type_traits>

#include "tile_sm90.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;     // chunk rows per CTA (two CTAs an SM)
constexpr int kSub = kStageRows;      // KV rows staged at once
constexpr int kPad = kStagePad;       // floats of padding on staged rows
constexpr int kPLd = kScoreLd;        // row stride of the transposed scores

template <int DK, int DV>
constexpr size_t smem_bytes(int bk) {
  constexpr int DS = staged_width(DK, DV);  // the staged rows' width
  return sizeof(float) * (kRows * (DK + kPad) + static_cast<size_t>(bk) * kPLd +
                          kSub * (DS + kPad) + kSub + bk + 2 * kRows);
}

// One tile of the walk: its first column (in the cache or in the chunk) and
// its width below the segment's end.
struct Tile {
  int c0, nr;
  bool chunk;
};

template <typename KV, int DK, int DV, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const KV* __restrict__ kn, const KV* __restrict__ vn,
               const float* __restrict__ ksn, const float* __restrict__ vsn,
               const int* __restrict__ lens, const int* __restrict__ nvalid,
               void* __restrict__ out, int H, int Hkv, int C, int S, int bk, int window,
               int rolling, float scale, int act_dtype, int dq, int dv, RowBytes rb) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int DS = staged_width(DK, DV);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                             // [kRows][DK + kPad]
  float* p_s = q_s + kRows * (DK + kPad);        // [bk][kPLd]: scores, then weights
  float* x_s = p_s + bk * kPLd;                  // [kSub][DS + kPad]: staged K or V
  float* sc_s = x_s + kSub * (DS + kPad);        // [kSub]: its scale rows
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
    t.nr = min(bk, (t.chunk ? chunk_end : S) - t.c0);
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
    int pos = col;
    if (rolling) {
      pos = last - py_mod(last - col, S);
      if (pos < 0) return false;
    } else if (col >= length) {
      return false;  // a stale row past the length
    }
    return window <= 0 || length + r0 + r - pos < window;
  };
  // staging step i: the K sub-tiles of a tile, then its V sub-tiles
  const auto step_at = [&](int i, const KV*& src, const float*& sc, int& nrows,
                           bool& is_v) {
    for (int ci = 0; ci < n_cand; ++ci) {
      Tile t;
      if (!tile_at(ci, t)) continue;
      const int ns = (t.nr + kSub - 1) / kSub;
      if (i < 2 * ns) {
        is_v = i >= ns;
        const int sub = is_v ? i - ns : i;
        const int64_t r = (t.chunk ? chunk0 : cache0) + t.c0 + sub * kSub;
        src = (t.chunk ? (is_v ? vn : kn) : (is_v ? vc : kc)) + r * (is_v ? dv : dq);
        sc = QUANT ? (t.chunk ? (is_v ? vsn : ksn) : (is_v ? vsc : ksc)) + r : nullptr;
        nrows = min(kSub, t.nr - sub * kSub);
        return true;
      }
      i -= 2 * ns;
    }
    return false;
  };

  using St = Stage<KV, DK, DV>;
  St stage;
  int step = 0;
  // staging step i: in flight in registers, or (St::kSync) straight into x_s
  const auto stage_step = [&](int i) {
    const KV* src;
    const float* sc;
    int nrows;
    bool is_v;
    if (!step_at(i, src, sc, nrows, is_v)) return;
    if constexpr (St::kSync) {
      stage.load(x_s, sc_s, src, sc, nrows, rb, is_v);
    } else {
      stage.fetch(src, sc, nrows, rb, is_v);
    }
  };
  if constexpr (!St::kSync) stage_step(0);
  // the current step's rows into x_s (the next step's in flight)
  const auto advance = [&]() {
    __syncthreads();  // the previous step's readers of x_s are done
    if constexpr (St::kSync) {
      stage_step(step++);
      __syncthreads();
    } else {
      stage.commit(x_s, sc_s);
      __syncthreads();
      stage_step(++step);
    }
  };

  for (int i = tid; i < kRows * DK; i += kThreads) {
    const int r = i / DK, d = i - r * DK;
    q_s[r * (DK + kPad) + d] =
        r < rows && d < dq
            ? load_act(q, (static_cast<int64_t>(bh) * C + r0 + r) * dq + d, act_dtype)
            : 0.0f;
  }
  zero_value_pad<DK, DV>(x_s);
  __syncthreads();

  ChunkRows<DV> st;
  for (int ci = 0; ci < n_cand; ++ci) {
    Tile t;
    if (!tile_at(ci, t)) continue;
    // a fresh cache without a window, below the length: every column valid
    const bool dense = !t.chunk && !rolling && window <= 0 && t.c0 + t.nr <= length;
    const float* vscale = nullptr;
    if constexpr (QUANT) vscale = (t.chunk ? vsn + chunk0 : vsc + cache0) + t.c0;
    chunk_tile_step<DK, EXPMUL, QUANT>(st, q_s, p_s, x_s, sc_s, vt_s, r_s, vscale, t.nr, scale,
                                      dense, advance,
                                      [&](int r, int j) { return valid(t, r, j); });
  }
  st.store(out, (static_cast<int64_t>(bh) * C + r0) * dv, l_s, rows, act_dtype, dv);
}

template <typename KV, int DK, int DV, bool EXPMUL>
int launch(const void* q, const void* kc, const void* vc, const float* ksc, const float* vsc,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* lens,
           const int* nvalid, void* out, int B, int H, int Hkv, int C, int S, int bk,
           int window, int rolling, float scale, int act_dtype, int dq, int dv,
           cudaStream_t stream) {
  auto kernel = prefill_kernel<KV, DK, DV, EXPMUL>;
  static bool wide_smem = false;  // once per instantiation: room for the widest tile
  if (!wide_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<DK, DV>(kMaxTile)));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem = true;
  }
  const RowBytes rb{dq * static_cast<int>(sizeof(KV)), dv * static_cast<int>(sizeof(KV)), 0};
  const RowBytes rbp{rb.k, rb.v,
                     piece_of(reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc) |
                              reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn) |
                              static_cast<uintptr_t>(rb.k) | static_cast<uintptr_t>(rb.v))};
  const dim3 grid(B * H, (C + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem_bytes<DK, DV>(bk), stream>>>(
      q, static_cast<const KV*>(kc), static_cast<const KV*>(vc), ksc, vsc,
      static_cast<const KV*>(kn), static_cast<const KV*>(vn), ksn, vsn, lens, nvalid, out, H,
      Hkv, C, S, bk, window, rolling, scale, act_dtype, dq, dv, rbp);
  return static_cast<int>(cudaGetLastError());
}

// The build a call at (D, Dv) runs: (96, 64) for float KV at 64 < D <= 96
// and Dv <= 64 (MLA's expanded latents), else the narrowest square width
// holding both; {0, 0} past kMaxHeadDim.
template <typename KV>
Dims built_dims(int D, int Dv) {
  if (!IsCode<KV>::value && D > 64 && D <= 96 && Dv <= 64) return Dims{96, 64};
  const int w = square_width(D > Dv ? D : Dv);
  return Dims{w, w};
}

}  // namespace

namespace prefill_part {

// one call of the C entry contiguous_prefill, as the parts pass it on
struct Call {
  const void *q, *kc, *vc;
  const float *ksc, *vsc;
  const void *kn, *vn;
  const float *ksn, *vsn;
  const int *lens, *nvalid;
  void* out;
  int B, H, Hkv, C, D, Dv, S, bk, window, rolling;
  float scale;
  int expmul, act_dtype;
  cudaStream_t stream;
};

// each KV dtype's launches, defined in that dtype's part of the build
int run_f32(const Call& c);
int run_bf16(const Call& c);
int run_i8(const Call& c);
int run_fp8(const Call& c);

}  // namespace prefill_part

namespace {

using prefill_part::Call;

template <typename KV>
int by_dims(const Call& c) {
#define REPRO_LAUNCH(DK, DV)                                                                  \
  return c.expmul                                                                            \
             ? launch<KV, DK, DV, true>(c.q, c.kc, c.vc, c.ksc, c.vsc, c.kn, c.vn, c.ksn,    \
                                        c.vsn, c.lens, c.nvalid, c.out, c.B, c.H, c.Hkv,     \
                                        c.C, c.S, c.bk, c.window, c.rolling, c.scale,        \
                                        c.act_dtype, c.D, c.Dv, c.stream)                    \
             : launch<KV, DK, DV, false>(c.q, c.kc, c.vc, c.ksc, c.vsc, c.kn, c.vn, c.ksn,   \
                                         c.vsn, c.lens, c.nvalid, c.out, c.B, c.H, c.Hkv,    \
                                         c.C, c.S, c.bk, c.window, c.rolling, c.scale,       \
                                         c.act_dtype, c.D, c.Dv, c.stream)
  const Dims w = built_dims<KV>(c.D, c.Dv);
  if constexpr (!IsCode<KV>::value) {
    if (w.k == 96 && w.v == 64) REPRO_LAUNCH(96, 64);
  }
  switch (w.k) {
    case 16: REPRO_LAUNCH(16, 16);
    case 32: REPRO_LAUNCH(32, 32);
    case 64: REPRO_LAUNCH(64, 64);
    case 112: REPRO_LAUNCH(112, 112);
    case 128: REPRO_LAUNCH(128, 128);
    case 256: REPRO_LAUNCH(256, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

#if REPRO_IN_PART(REPRO_PART_F32)
int prefill_part::run_f32(const Call& c) { return by_dims<float>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_BF16)
int prefill_part::run_bf16(const Call& c) { return by_dims<__nv_bfloat16>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_I8)
int prefill_part::run_i8(const Call& c) { return by_dims<int8_t>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_FP8)
int prefill_part::run_fp8(const Call& c) { return by_dims<__nv_fp8_e4m3>(c); }
#endif

#if REPRO_IN_PART(REPRO_PART_F32)
// q (B*H, C, D) f32/bf16; cache kc (B*Hkv, S, D) and vc (B*Hkv, S, Dv) of
// kv_dtype and its scale rows ksc/vsc (B*Hkv, S) f32 for codes; chunk kn
// (B*Hkv, C, D) and vn (B*Hkv, C, Dv) of kv_dtype and ksn/vsn (B*Hkv, C) f32
// for codes; lens / nvalid (B,) i32; bk the KV tile width (<= kMaxTile);
// window <= 0: none; rolling: the cache is a rolling buffer of span S; out
// (B*H, C, Dv) in q's dtype. With rolling = 0 the caller keeps length <= S.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a (D, Dv)
// pair or KV dtype not built).
extern "C" int contiguous_prefill(const void* q, const void* kc, const void* vc,
                                  const float* ksc, const float* vsc, const void* kn,
                                  const void* vn, const float* ksn, const float* vsn,
                                  const int* lens, const int* nvalid, void* out, int B, int H,
                                  int Hkv, int C, int D, int Dv, int S, int bk, int window,
                                  int rolling, float scale, int expmul, int act_dtype,
                                  int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bk <= 0 || bk > kMaxTile ||
      D <= 0 || D > kMaxHeadDim || Dv <= 0 || Dv > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, kc, vc, ksc, vsc,    kn,   vn,    ksn,    vsn,       lens,
               nvalid, out, B, H, Hkv, C, D, Dv, S, bk, window, rolling, scale, expmul,
               act_dtype, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kF32: return prefill_part::run_f32(c);
    case kBF16: return prefill_part::run_bf16(c);
    case kI8: return prefill_part::run_i8(c);
    case kFP8: return prefill_part::run_fp8(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that contiguous_prefill gives each CTA
// at tile width bk (independent of S and C) for head dims (D, Dv) over
// kv_dtype; -1 past kMaxHeadDim or for an unknown dtype.
extern "C" long long contiguous_prefill_smem(int D, int Dv, int bk, int kv_dtype) {
  if (D <= 0 || D > kMaxHeadDim || Dv <= 0 || Dv > kMaxHeadDim || kv_dtype < kF32 ||
      kv_dtype > kFP8)
    return -1;
  const Dims w = kv_dtype <= kBF16 ? built_dims<float>(D, Dv) : built_dims<int8_t>(D, Dv);
  if (w.k == 96) return static_cast<long long>(smem_bytes<96, 64>(bk));
  switch (w.k) {
    case 16: return static_cast<long long>(smem_bytes<16, 16>(bk));
    case 32: return static_cast<long long>(smem_bytes<32, 32>(bk));
    case 64: return static_cast<long long>(smem_bytes<64, 64>(bk));
    case 112: return static_cast<long long>(smem_bytes<112, 112>(bk));
    case 128: return static_cast<long long>(smem_bytes<128, 128>(bk));
    case 256: return static_cast<long long>(smem_bytes<256, 256>(bk));
    default: return -1;
  }
}
#endif
