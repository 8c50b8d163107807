// A study copy of csrc/prefill.cu (the contiguous chunked prefill), built
// only by tools/prefill_study.py and never by the port. With no macro set it
// is that kernel, line for line in its arithmetic; each macro changes one
// thing, so the study can time and check what the kernel does not do:
//
//   STUDY_TC_SCORES  the score product on the tensor cores (mma.sync
//                    m16n8k16, bf16 in, float32 accumulate) where q is bf16
//                    and the keys are codes or bf16 values: one pass, all
//                    operands exact in bf16;
//   STUDY_TC_VALUES  the value product on the tensor cores: the weights
//                    (times vs for codes) split into three bf16 parts
//                    hi + mid + lo whose sum is the float32 weight, the
//                    values (exact in bf16 for codes and bf16 values, else
//                    split too), the partial products of order <= 2 summed
//                    (hi*hi, hi*mid, mid*hi, hi*lo, lo*hi, mid*mid; only
//                    terms below 2^-24 of the largest are dropped);
//   STUDY_KO_SCORES, STUDY_KO_WEIGHTS, STUDY_KO_VALUES
//                    the phase does no work (its loop runs zero times), so
//                    the build times the rest; its outputs are wrong.
//
// csrc/prefill.cu states the kernel's design and masks.
#include <type_traits>

#include "tile_sm90.cuh"

using namespace repro;

#ifndef STUDY_TC_SCORES
#define STUDY_TC_SCORES 0
#endif
#ifndef STUDY_TC_VALUES
#define STUDY_TC_VALUES 0
#endif
#ifndef STUDY_KO_SCORES
#define STUDY_KO_SCORES 0
#endif
#ifndef STUDY_KO_WEIGHTS
#define STUDY_KO_WEIGHTS 0
#endif
#ifndef STUDY_KO_VALUES
#define STUDY_KO_VALUES 0
#endif

namespace {

// Two float32 values, each exact in bf16, packed as one bf16x2 register
// (lo in the low half: the lower column or depth index of a fragment).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col), one warp.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + mid + lo, each a bf16 value (round to nearest each time): exact
// for every finite float32 x whose exponent leaves room for the low parts.
__device__ __forceinline__ void split3(float x, float (&part)[3]) {
  part[0] = __bfloat162float(__float2bfloat16_rn(x));
  part[1] = __bfloat162float(__float2bfloat16_rn(x - part[0]));
  part[2] = __bfloat162float(__float2bfloat16_rn(x - part[0] - part[1]));
}

constexpr int kThreads = 128;
constexpr int kRows = 32;             // chunk rows per CTA (two CTAs an SM)
constexpr int kSub = 64;              // KV rows staged at once
constexpr int kPad = 4;               // floats of padding on staged rows
constexpr int kPLd = kRows + kPad;    // row stride of the transposed scores

// Raw bytes of one staged sub-tile (kSub rows of D elements of KV) in
// flight in registers: 16-byte pieces, kPer a thread, and one scale row.
template <typename KV, int D>
struct Stage {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kPieces = kSub * kPerRow;
  static constexpr int kPer = (kPieces + kThreads - 1) / kThreads;
  uint4 raw[kPer];
  float sc;

  __device__ __forceinline__ void fetch(const KV* src, const float* scale, int nrows,
                                        bool vec16) {
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int r = i / kPerRow;
      raw[c] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kPieces && r < nrows) {
        const unsigned char* p = base + static_cast<int64_t>(i) * 16;
        if (vec16) {
          raw[c] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const unsigned* w = reinterpret_cast<const unsigned*>(p);
          raw[c] = make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
        }
      }
    }
    sc = 0.0f;
    if (scale != nullptr && static_cast<int>(threadIdx.x) < nrows) sc = __ldg(scale + threadIdx.x);
  }

  // the sub-tile as float32 rows x_s[r * (D + kPad) + d], zeros past nrows
  __device__ __forceinline__ void commit(float* x_s, float* sc_s) const {
    constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i >= kPieces) continue;
      const int r = i / kPerRow, e0 = (i - r * kPerRow) * kElems;
      float4* dst = reinterpret_cast<float4*>(x_s + r * (D + kPad) + e0);
      const unsigned w[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
      if constexpr (std::is_same<KV, float>::value) {
        dst[0] = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                             __uint_as_float(w[2]), __uint_as_float(w[3]));
      } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[h] = make_float4(__uint_as_float(w[2 * h] << 16),
                               __uint_as_float(w[2 * h] & 0xFFFF0000u),
                               __uint_as_float(w[2 * h + 1] << 16),
                               __uint_as_float(w[2 * h + 1] & 0xFFFF0000u));
      } else {
#pragma unroll
        for (int h = 0; h < 4; ++h) dst[h] = codes4<KV>(w[h]);
      }
    }
    if (threadIdx.x < kSub) sc_s[threadIdx.x] = sc;
  }
};

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

template <typename KV, int D, bool EXPMUL, bool QBF16>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const KV* __restrict__ kn, const KV* __restrict__ vn,
               const float* __restrict__ ksn, const float* __restrict__ vsn,
               const int* __restrict__ lens, const int* __restrict__ nvalid,
               void* __restrict__ out, int H, int Hkv, int C, int S, int bk, int window,
               int rolling, float scale, int act_dtype, int vec16) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr bool kTensorScores = STUDY_TC_SCORES && QBF16 && !std::is_same<KV, float>::value;
  constexpr bool kTensorValues = STUDY_TC_VALUES && D == 64;
  constexpr int DG = D / 4;                      // 4-feature groups
  constexpr int RPT = kRows * DG / kThreads;     // value rows a thread (4 or 1)
  static_assert(RPT == 4 || RPT == 1, "head dims 16 and 64");
  static_assert(kRows / 4 * 16 == kThreads && kRows * 4 == kThreads, "thread mappings");
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
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
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

  // mma fragments: lane (g, cq); warp: rows 16 wr.., column or feature half wc
  constexpr int kK = D / 16;
  const int g = lane >> 2, cq = lane & 3;
  const int wr = warp % (kRows / 16), wc = warp / (kRows / 16);
  unsigned qa[kTensorScores ? kK : 1][4];
  if constexpr (kTensorScores) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float* q0 = q_s + (16 * wr + g) * (D + kPad) + kk * 16 + 2 * cq;
      const float* q8 = q0 + 8 * (D + kPad);
      qa[kk][0] = pack_bf16x2(q0[0], q0[1]);
      qa[kk][1] = pack_bf16x2(q8[0], q8[1]);
      qa[kk][2] = pack_bf16x2(q0[8], q0[9]);
      qa[kk][3] = pack_bf16x2(q8[8], q8[9]);
    }
  }

  // the scores of one staged K sub-tile (ncols columns) into p_s[sub * kSub + j][row]
  const auto scores = [&](int sub, int ncols) {
    if constexpr (kTensorScores) {
      if (STUDY_KO_SCORES) return;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n0 = 32 * wc + 8 * nt;
        if (n0 >= ncols) break;  // warp-uniform
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* kr = x_s + (n0 + g) * (D + kPad) + 2 * cq;
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          mma_bf16_16816(c, qa[kk], pack_bf16x2(kr[kk * 16], kr[kk * 16 + 1]),
                         pack_bf16x2(kr[kk * 16 + 8], kr[kk * 16 + 9]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 2 * cq + (e & 1), row = 16 * wr + g + 8 * (e >> 1);
          if (col < ncols) {
            float s = c[e] * scale;
            if (QUANT) s *= sc_s[col];
            p_s[(sub * kSub + col) * kPLd + row] = s;
          }
        }
      }
      return;
    }
    // a 4 x 4 block a thread: rows 4 rg.., columns cg + 16 c
    const int rg = tid / 16, cg = tid % 16;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < (STUDY_KO_SCORES ? 0 : D); d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (4 * rg + r) * (D + kPad) + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(x_s + (cg + 16 * c) * (D + kPad) + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(qv[r].x, kv[c].x, acc[r][c]);
          acc[r][c] = fmaf(qv[r].y, kv[c].y, acc[r][c]);
          acc[r][c] = fmaf(qv[r].z, kv[c].z, acc[r][c]);
          acc[r][c] = fmaf(qv[r].w, kv[c].w, acc[r][c]);
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = cg + 16 * c;
      if (col >= ncols) continue;
      const float ks = QUANT ? sc_s[col] : 1.0f;
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[r] = acc[r][c] * scale;
        if (QUANT) s[r] *= ks;
      }
      *reinterpret_cast<float4*>(p_s + (sub * kSub + col) * kPLd + 4 * rg) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  };

  // the running state: (m, l) of row tid / 4 in its four weight threads;
  // acc of RPT rows x 4 features in each thread
  const int wrow = tid / 4, wpart = tid % 4;
  float m_run = kMaskValue, l_run = 0.0f;
  const int vrg = tid / DG, vdg = tid % DG;
  float acc[RPT][4], dsum[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  // the tensor-core value product: warp (wr, wc) holds rows 16 wr.. and
  // features 32 wc.. as four 16 x 8 accumulator fragments
  float tacc[4][4], tsum[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tacc[nt][e] = 0.0f;

  for (int ci = 0; ci < n_cand; ++ci) {
    Tile t;
    if (!tile_at(ci, t)) continue;
    const int ns = (t.nr + kSub - 1) / kSub;
    for (int sub = 0; sub < ns; ++sub) {
      advance();
      scores(sub, min(kSub, t.nr - sub * kSub));
    }
    // the tile's v scales, then per row: the max, the weights, their sum
    if constexpr (QUANT) {
      const float* vsrc = (t.chunk ? vsn + chunk0 : vsc + cache0) + t.c0;
      for (int j = tid; j < t.nr; j += kThreads) vt_s[j] = vsrc[j];
    }
    __syncthreads();
    {
      // a fresh cache without a window: every column read is valid
      const bool dense = !t.chunk && !rolling && window <= 0;
      float mx = kMaskValue;
#pragma unroll 4
      for (int j = wpart; j < (STUDY_KO_WEIGHTS ? 0 : t.nr); j += 4)
        if (dense || valid(t, wrow, j)) mx = fmaxf(mx, p_s[j * kPLd + wrow]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float ps = 0.0f;
#pragma unroll 4
      for (int j = wpart; j < (STUDY_KO_WEIGHTS ? 0 : t.nr); j += 4) {
        float* pj = p_s + j * kPLd + wrow;
        const float p =
            dense || valid(t, wrow, j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
        ps += p;
        *pj = QUANT ? p * vt_s[j] : p;  // the weight the value product takes
      }
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      const float r = rescale_factor<EXPMUL>(m_run, m_new);
      l_run = rescale<EXPMUL>(l_run, r) + ps;
      m_run = m_new;
      if (wpart == 0) r_s[wrow] = r;
    }
    if constexpr (kTensorValues) {
      constexpr int kWParts = (QUANT || !EXPMUL) ? 3 : 1;  // ExpMul weights are powers of two
      constexpr int kVParts = std::is_same<KV, float>::value ? 3 : 1;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tsum[nt][e] = 0.0f;
      for (int sub = 0; sub < ns; ++sub) {
        advance();
        if (STUDY_KO_VALUES) continue;
        const int ncols = min(kSub, t.nr - sub * kSub);
        for (int k0 = 0; k0 < ncols; k0 += 16) {
          // A: the weights of rows 16 wr + (g, g + 8), columns k0 + 2 cq (+1, +8, +9)
          float w[4][2][3];  // [register][half][part]
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * wr + g + 8 * (a & 1);
              const int col = k0 + 2 * cq + h + 8 * (a >> 1);
              const float x = col < ncols ? p_s[(sub * kSub + col) * kPLd + row] : 0.0f;
              split3(x, w[a][h]);
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // B: values of depth k0 + 2 cq (+1, +8, +9), feature 32 wc + 8 nt + g
            const float* vp = x_s + (k0 + 2 * cq) * (D + kPad) + 32 * wc + 8 * nt + g;
            float vb[4][3];
            split3(vp[0], vb[0]);
            split3(vp[D + kPad], vb[1]);
            split3(vp[8 * (D + kPad)], vb[2]);
            split3(vp[9 * (D + kPad)], vb[3]);
#pragma unroll
            for (int pa = 0; pa < kWParts; ++pa)
#pragma unroll
              for (int pb = 0; pb < kVParts; ++pb) {
                if (pa + pb > 2) continue;
                const unsigned a[4] = {pack_bf16x2(w[0][0][pa], w[0][1][pa]),
                                       pack_bf16x2(w[1][0][pa], w[1][1][pa]),
                                       pack_bf16x2(w[2][0][pa], w[2][1][pa]),
                                       pack_bf16x2(w[3][0][pa], w[3][1][pa])};
                mma_bf16_16816(tsum[nt], a, pack_bf16x2(vb[0][pb], vb[1][pb]),
                               pack_bf16x2(vb[2][pb], vb[3][pb]));
              }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = r_s[16 * wr + g + 8 * (e >> 1)];
          tacc[nt][e] = rescale<EXPMUL>(tacc[nt][e], f) + tsum[nt][e];
        }
      continue;
    }
    // the values: dsum[r][e] = sum_j w_rj v_j[4 vdg + e], in column order
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[r][e] = 0.0f;
    for (int sub = 0; sub < ns; ++sub) {
      advance();
      const int ncols = min(kSub, t.nr - sub * kSub);
      const float* pw = p_s + sub * kSub * kPLd + RPT * vrg;
      const float* xv = x_s + 4 * vdg;
#pragma unroll 4
      for (int j = 0; j < (STUDY_KO_VALUES ? 0 : ncols); ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(xv + j * (D + kPad));
        float w[RPT];
        if (RPT == 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(pw + j * kPLd);
          w[0] = w4.x;
          w[RPT > 1 ? 1 : 0] = w4.y;
          w[RPT > 2 ? 2 : 0] = w4.z;
          w[RPT > 3 ? 3 : 0] = w4.w;
        } else {
          w[0] = pw[j * kPLd];
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          dsum[r][0] = fmaf(w[r], v4.x, dsum[r][0]);
          dsum[r][1] = fmaf(w[r], v4.y, dsum[r][1]);
          dsum[r][2] = fmaf(w[r], v4.z, dsum[r][2]);
          dsum[r][3] = fmaf(w[r], v4.w, dsum[r][3]);
        }
      }
    }
    // the online-softmax update, once per tile
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float f = r_s[RPT * vrg + r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = rescale<EXPMUL>(acc[r][e], f) + dsum[r][e];
    }
  }

  if (wpart == 0) l_s[wrow] = l_run;
  __syncthreads();
  if constexpr (kTensorValues) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * wr + g + 8 * (e >> 1), d = 32 * wc + 8 * nt + 2 * cq + (e & 1);
        if (row >= rows) continue;
        const float l = l_s[row];
        store_act(out, (static_cast<int64_t>(bh) * C + r0 + row) * D + d,
                  tacc[nt][e] / (l == 0.0f ? 1.0f : l), act_dtype);
      }
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = RPT * vrg + r;
    if (row >= rows) continue;
    const float l = l_s[row];
    const float den = l == 0.0f ? 1.0f : l;
    const int64_t o = (static_cast<int64_t>(bh) * C + r0 + row) * D + 4 * vdg;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_act(out, o + e, acc[r][e] / den, act_dtype);
  }
}

template <typename KV, int D, bool EXPMUL, bool QBF16>
int launch(const void* q, const void* kc, const void* vc, const float* ksc, const float* vsc,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* lens,
           const int* nvalid, void* out, int B, int H, int Hkv, int C, int S, int bk,
           int window, int rolling, float scale, int act_dtype, cudaStream_t stream) {
  auto kernel = prefill_kernel<KV, D, EXPMUL, QBF16>;
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

template <typename KV, int D, bool EXPMUL>
int by_act(const void* q, const void* kc, const void* vc, const float* ksc, const float* vsc,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* lens,
           const int* nvalid, void* out, int B, int H, int Hkv, int C, int S, int bk,
           int window, int rolling, float scale, int act_dtype, cudaStream_t s) {
  if (act_dtype == kBF16)
    return launch<KV, D, EXPMUL, true>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid,
                                       out, B, H, Hkv, C, S, bk, window, rolling, scale,
                                       act_dtype, s);
  return launch<KV, D, EXPMUL, false>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid, out,
                                      B, H, Hkv, C, S, bk, window, rolling, scale, act_dtype, s);
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const void* kn, const void* vn, const float* ksn,
           const float* vsn, const int* lens, const int* nvalid, void* out, int B, int H,
           int Hkv, int C, int S, int bk, int window, int rolling, float scale, int act_dtype,
           cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                    \
  return expmul ? by_act<KV, DIM, true>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid, \
                                        out, B, H, Hkv, C, S, bk, window, rolling, scale,   \
                                        act_dtype, s)                                       \
                : by_act<KV, DIM, false>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens,       \
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

// The port's contiguous_prefill entry (csrc/prefill.cu), at Dv == D only.
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
                                  int Hkv, int C, int D, int Dv, int S, int bk, int window,
                                  int rolling, float scale, int expmul, int act_dtype,
                                  int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bk <= 0 || bk > kMaxTile ||
      Dv != D)
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

// The port's contiguous_prefill_smem query, at Dv == D only.
extern "C" long long contiguous_prefill_smem(int D, int Dv, int bk) {
  if (Dv != D) return -1;
  switch (D) {
    case 16: return static_cast<long long>(smem_bytes<16>(bk));
    case 64: return static_cast<long long>(smem_bytes<64>(bk));
    default: return -1;
  }
}
