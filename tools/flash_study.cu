// A study copy of csrc/flash.cu (the full-sequence flash forward), built
// only by tools/flash_study.py and never by the port. It takes float32 and
// bf16 q, k and v, as flash.cu. With no macro set it is that kernel with a
// wider register block: K and V staged in 128-row sub-tiles and a 4 x 8
// block of (rows, columns) of the scores a thread, in place of 64-row
// sub-tiles and a 4 x 4 block (its shared memory leaves room for one CTA an
// SM at head dim 64, two for the port's build). Each output's chains keep
// the plain version's depth and column order, so it must give the port's
// numbers. The macros:
//
//   STUDY_SUB_ROWS=64  the port's 64-row sub-tiles and 4 x 4 block: the
//                      port's kernel, output for output;
//   STUDY_WARP_LSUM    each row's weight sum l of a tile in the order of
//                      the kernel flash.cu replaced: 32 lane partials over
//                      the columns j = lane (mod 32), each in column order,
//                      summed by the warp butterfly (lane xor 16, 8, 4, 2,
//                      1), where flash.cu takes 4 partials over j = part
//                      (mod 4) summed by xor 1, then 2. Nothing else
//                      differs.
//
// csrc/flash.cu states the kernel's design and masks.
#include <type_traits>

#include "tile_sm90.cuh"

using namespace repro;

#ifndef STUDY_SUB_ROWS
#define STUDY_SUB_ROWS 128
#endif
#ifndef STUDY_WARP_LSUM
#define STUDY_WARP_LSUM 0
#endif

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;     // query rows per CTA
constexpr int kSub = STUDY_SUB_ROWS;  // KV rows staged at once
constexpr int kCB = kSub / 16;        // score columns a thread
static_assert(kSub == 64 || kSub == 128, "sub-tile rows");
constexpr int kPad = kStagePad;
constexpr int kPLd = kScoreLd;

// tile_sm90.cuh's Stage at kSub rows, for float32 and bf16 (no codes)
template <typename T, int D>
struct WideStage {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kPieces = kSub * kPerRow;
  static constexpr int kPer = (kPieces + kThreads - 1) / kThreads;
  uint4 raw[kPer];

  __device__ __forceinline__ void fetch(const T* src, int nrows, bool vec16) {
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int r = i / kPerRow;
      raw[c] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kPieces && r < nrows) {
        const unsigned char* p = base + static_cast<int64_t>(r) * kRowBytes +
                                 (i - r * kPerRow) * 16;
        if (vec16) {
          raw[c] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const unsigned* w = reinterpret_cast<const unsigned*>(p);
          raw[c] = make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
        }
      }
    }
  }

  __device__ __forceinline__ void commit(float* x_s) const {
    constexpr int kElems = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i >= kPieces) continue;
      const int r = i / kPerRow, e0 = (i - r * kPerRow) * kElems;
      float4* dst = reinterpret_cast<float4*>(x_s + r * (D + kPad) + e0);
      const unsigned w[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
      if constexpr (std::is_same<T, float>::value) {
        dst[0] = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                             __uint_as_float(w[2]), __uint_as_float(w[3]));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[h] = make_float4(__uint_as_float(w[2 * h] << 16),
                               __uint_as_float(w[2 * h] & 0xFFFF0000u),
                               __uint_as_float(w[2 * h + 1] << 16),
                               __uint_as_float(w[2 * h + 1] & 0xFFFF0000u));
      }
    }
  }
};

// tile_sm90.cuh's score_block with kCB columns a thread: rows 4 rg..,
// columns cg + 16 c
template <int D>
__device__ __forceinline__ void wide_score_block(const float* q_s, const float* x_s, float* p_s,
                                                 int ncols, float scale) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[4][kCB];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCB; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], kv[kCB];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qv[r] = *reinterpret_cast<const float4*>(q_s + (4 * rg + r) * (D + kPad) + d);
#pragma unroll
    for (int c = 0; c < kCB; ++c)
      kv[c] = *reinterpret_cast<const float4*>(x_s + (cg + 16 * c) * (D + kPad) + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        acc[r][c] = fmaf(qv[r].x, kv[c].x, acc[r][c]);
        acc[r][c] = fmaf(qv[r].y, kv[c].y, acc[r][c]);
        acc[r][c] = fmaf(qv[r].z, kv[c].z, acc[r][c]);
        acc[r][c] = fmaf(qv[r].w, kv[c].w, acc[r][c]);
      }
  }
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    const int col = cg + 16 * c;
    if (col >= ncols) continue;
    *reinterpret_cast<float4*>(p_s + col * kPLd + 4 * rg) =
        make_float4(acc[0][c] * scale, acc[1][c] * scale, acc[2][c] * scale, acc[3][c] * scale);
  }
}

// tile_sm90.cuh's chunk_tile_step at kSub-row sub-tiles, without codes
template <int D, bool EXPMUL, typename Advance, typename Valid>
__device__ __forceinline__ void wide_tile_step(ChunkRows<D>& st, const float* q_s, float* p_s,
                                               const float* x_s, float* r_s, int nr, float scale,
                                               bool dense, Advance advance, Valid valid) {
  constexpr int RPT = ChunkRows<D>::RPT, DG = ChunkRows<D>::kGroups;
  const int tid = threadIdx.x;
  const int wrow = tid / 4, wpart = tid % 4;
  const int vrg = tid / DG, vdg = tid % DG;
  const int ns = (nr + kSub - 1) / kSub;
  for (int sub = 0; sub < ns; ++sub) {
    advance();
    wide_score_block<D>(q_s, x_s, p_s + sub * kSub * kPLd, min(kSub, nr - sub * kSub), scale);
  }
  __syncthreads();
  {
    float mx = kMaskValue;
#pragma unroll 4
    for (int j = wpart; j < nr; j += 4)
      if (dense || valid(wrow, j)) mx = fmaxf(mx, p_s[j * kPLd + wrow]);
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(st.m, mx);
#if STUDY_WARP_LSUM
    // part[i]: the partial of lane wpart + 4 i of a 32-lane warp
    float part[8] = {};
    for (int j0 = wpart; j0 < nr; j0 += 32) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = j0 + 4 * i;
        if (j >= nr) break;
        float* pj = p_s + j * kPLd + wrow;
        const float p = dense || valid(wrow, j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
        part[i] += p;
        *pj = p;
      }
    }
    const float a0 = part[0] + part[4], a1 = part[1] + part[5];  // lane xor 16
    const float a2 = part[2] + part[6], a3 = part[3] + part[7];
    float ps = (a0 + a2) + (a1 + a3);                              // xor 8, then 4
    ps += __shfl_xor_sync(kFull, ps, 2);
    ps += __shfl_xor_sync(kFull, ps, 1);
#else
    float ps = 0.0f;
#pragma unroll 4
    for (int j = wpart; j < nr; j += 4) {
      float* pj = p_s + j * kPLd + wrow;
      const float p = dense || valid(wrow, j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
      ps += p;
      *pj = p;
    }
    ps += __shfl_xor_sync(kFull, ps, 1);
    ps += __shfl_xor_sync(kFull, ps, 2);
#endif
    const float r = rescale_factor<EXPMUL>(st.m, m_new);
    st.l = rescale<EXPMUL>(st.l, r) + ps;
    st.m = m_new;
    if (wpart == 0) r_s[wrow] = r;
  }
  float dsum[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsum[r][e] = 0.0f;
  for (int sub = 0; sub < ns; ++sub) {
    advance();
    value_block<D, RPT>(dsum, p_s + sub * kSub * kPLd + RPT * vrg, x_s + 4 * vdg,
                        min(kSub, nr - sub * kSub));
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float f = r_s[RPT * vrg + r];
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[r][e] = rescale<EXPMUL>(st.acc[r][e], f) + dsum[r][e];
  }
}

template <int D>
constexpr size_t smem_bytes(int bk) {
  return sizeof(float) * (kRows * (D + kPad) + static_cast<size_t>(bk) * kPLd +
                          kSub * (D + kPad) + 2 * kRows);
}

template <typename T, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int Hkv, int Sq, int Sk, int bk, int kv_len,
             int causal, int window, float scale, int vec16) {
  constexpr int kAct = sizeof(T) == sizeof(float) ? kF32 : kBF16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* p_s = q_s + kRows * (D + kPad);
  float* x_s = p_s + bk * kPLd;
  float* r_s = x_s + kSub * (D + kPad);
  float* l_s = r_s + kRows;

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = qb * kRows;
  const int rows = min(kRows, Sq - r0);
  const int col_end = causal ? min(kv_len, r0 + rows) : kv_len;
  const int t_lo = window > 0 && r0 > window ? (r0 - window) / bk : 0;
  const int t_hi = (col_end + bk - 1) / bk;
  const int steps_full = 2 * ((bk + kSub - 1) / kSub);
  const int64_t kv0 = static_cast<int64_t>(kvh) * Sk;

  const auto step_at = [&](int i, const T*& src, int& nrows) {
    const int t = t_lo + i / steps_full;
    if (t >= t_hi) return false;
    const int nr = min(bk, col_end - t * bk);
    const int ns = (nr + kSub - 1) / kSub;
    const int w = i % steps_full;
    if (w >= 2 * ns) return false;
    const bool is_v = w >= ns;
    const int sub = is_v ? w - ns : w;
    src = (is_v ? v : k) + (kv0 + t * bk + sub * kSub) * D;
    nrows = min(kSub, nr - sub * kSub);
    return true;
  };

  WideStage<T, D> stage;
  int step = 0;
  {
    const T* src;
    int nrows;
    if (step_at(0, src, nrows)) stage.fetch(src, nrows, vec16);
  }
  const auto advance = [&]() {
    __syncthreads();
    stage.commit(x_s);
    __syncthreads();
    const T* src;
    int nrows;
    if (step_at(++step, src, nrows)) stage.fetch(src, nrows, vec16);
  };

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * (D + kPad) + d] =
        r < rows ? to_f32(q[(static_cast<int64_t>(bh) * Sq + r0 + r) * D + d]) : 0.0f;
  }

  ChunkRows<D> st;
  const bool dense = !causal && window <= 0;
  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * bk;
    wide_tile_step<D, EXPMUL>(st, q_s, p_s, x_s, r_s, min(bk, col_end - c0), scale, dense,
                              advance, [&](int r, int j) {
                                const int row = r0 + r, col = c0 + j;
                                return (!causal || col <= row) &&
                                       (window <= 0 || row - col < window);
                              });
  }
  st.store(out, (static_cast<int64_t>(bh) * Sq + r0) * D, l_s, rows, kAct);
}

template <typename T, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int H, int Hkv,
           int Sq, int Sk, int bk, int kv_len, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, EXPMUL>;
  const int smem = static_cast<int>(smem_bytes<D>(bk));
  static int granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, bk, kv_len, causal, window, scale,
      (any & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, void* out, int BH,
           int H, int Hkv, int Sq, int Sk, int bk, int kv_len, int causal, int window,
           float scale, cudaStream_t s) {
#define STUDY_LAUNCH(DIM)                                                                  \
  return expmul ? launch<T, DIM, true>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,      \
                                       causal, window, scale, s)                          \
                : launch<T, DIM, false>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,     \
                                        causal, window, scale, s)
  switch (D) {
    case 16: STUDY_LAUNCH(16);
    case 32: STUDY_LAUNCH(32);
    case 64: STUDY_LAUNCH(64);
    case 128: STUDY_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STUDY_LAUNCH
}

}  // namespace

// csrc/flash.cu's C interface, so the study can swap this build in for the
// port's flash library.
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out, int BH,
                             int H, int Hkv, int Sq, int Sk, int D, int bk, int kv_len,
                             int causal, int window, float scale, int expmul, int dtype,
                             void* stream) {
  if (BH <= 0 || Sq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || bk <= 0 ||
      bk > kMaxTile || kv_len < 0 || kv_len > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len, causal,
                           window, scale, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,
                                   causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long flash_smem(int D, int bk) {
  switch (D) {
    case 16: return static_cast<long long>(smem_bytes<16>(bk));
    case 32: return static_cast<long long>(smem_bytes<32>(bk));
    case 64: return static_cast<long long>(smem_bytes<64>(bk));
    case 128: return static_cast<long long>(smem_bytes<128>(bk));
    default: return -1;
  }
}
