// Hopper building blocks of the attention kernels (csrc/decode.cu,
// csrc/prefill.cu, csrc/paged_decode.cu, csrc/paged_prefill.cu,
// csrc/flash.cu): asynchronous copies into shared memory, the
// thread-block-cluster barrier, conversions of staged KV codes, the
// online-softmax weight and rescale of one tile, and the register-tiled
// CUDA-core tile step of the prefill and flash kernels.
//
// The arithmetic is tile.cuh's (numerics/log2exp.py for ExpMul), operation
// for operation: a weight is expf(s - m) or 2^-lhat(s - m), a rescale is
// x * expf(m_old - m_new) or pow2scale(x, lhat(m_old - m_new)).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_fp16.h>

#include "tile.cuh"

namespace repro {

// ---- asynchronous copies (cp.async, sm_80+) -------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of `row_bytes` bytes (a multiple of 4) from global memory,
// row r starting at src_row(r), to shared dst (rows `dst_stride` bytes
// apart), in 16-byte pieces when both sides allow it, else in 4-byte
// pieces. Called by every thread of the CTA; the caller commits and waits.
template <typename SrcRow>
__device__ __forceinline__ void copy_rows_async_at(unsigned char* dst, int dst_stride, int rows,
                                                   int row_bytes, bool vec16, SrcRow src_row) {
  const int piece = vec16 ? 16 : 4;
  const int per_row = row_bytes / piece;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * piece;
    unsigned char* d = dst + r * dst_stride + c;
    const unsigned char* s = src_row(r) + c;
    if (vec16) {
      cp_async16(d, s);
    } else {
      cp_async4(d, s);
    }
  }
}

// The same for rows contiguous in global memory from src.
__device__ __forceinline__ void copy_rows_async(unsigned char* dst, int dst_stride,
                                                const unsigned char* src, int rows,
                                                int row_bytes, bool vec16) {
  copy_rows_async_at(dst, dst_stride, rows, row_bytes, vec16,
                     [=](int r) { return src + static_cast<int64_t>(r) * row_bytes; });
}

// ---- thread-block clusters (sm_90) ----------------------------------------
// The split arrive / wait of the cluster barrier. A CTA may write another
// CTA's shared memory only once that CTA has started: arrive at entry, wait
// before the first remote store.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- staged values and codes to float32 ------------------------------------
// Four consecutive staged elements of type KV, starting at p, as float32
// (exact for every type: codes, bf16 values, float32 values).
template <typename KV>
__device__ __forceinline__ float4 load4(const KV* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
}

// Four int8 or fp8 codes packed in one 32-bit word (the first in the low
// byte) as float32, exactly. int8: the byte b as 2^23 + (b + 128) in a
// float's bits, minus 2^23 + 128 (no integer-to-float instruction); fp8
// e4m3: through half precision, which holds every e4m3 value.
template <typename KV>
__device__ __forceinline__ float4 codes4(unsigned w);

template <>
__device__ __forceinline__ float4 codes4<int8_t>(unsigned w) {
  w ^= 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - bias,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - bias);
}

template <>
__device__ __forceinline__ float4 codes4<__nv_fp8_e4m3>(unsigned w) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <>
__device__ __forceinline__ float4 load4<int8_t>(const int8_t* p) {
  return codes4<int8_t>(*reinterpret_cast<const unsigned*>(p));
}

template <>
__device__ __forceinline__ float4 load4<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p) {
  return codes4<__nv_fp8_e4m3>(*reinterpret_cast<const unsigned*>(p));
}

// ---- the online-softmax weight and rescale ---------------------------------
template <bool EXPMUL>
__device__ __forceinline__ float softmax_weight(float s, float m) {
  return EXPMUL ? pow2_neg(log2exp_lhat(s - m)) : expf(s - m);
}

// x rescaled from the running max m_old to m_new: the factor is carried as
// `r`, an L_hat (ExpMul, as int bits in a float) or expf(m_old - m_new).
template <bool EXPMUL>
__device__ __forceinline__ float rescale_factor(float m_old, float m_new) {
  return EXPMUL ? __int_as_float(log2exp_lhat(m_old - m_new)) : expf(m_old - m_new);
}

template <bool EXPMUL>
__device__ __forceinline__ float rescale(float x, float r) {
  return EXPMUL ? apply_pow2_scale(x, __float_as_int(r)) : x * r;
}

// ---- the CUDA-core layout of the prefill and flash kernels ------------------
// One CTA of kChunkThreads threads per (sequence, query head, kChunkRows
// query rows), q in shared memory as float32 rows of D + kStagePad; KV staged in
// sub-tiles of kStageRows rows (the next one's 16-byte loads in flight in
// registers while the current one is computed on), converted to float32
// rows of D + kStagePad in shared memory; the scores transposed,
// p_s[col * kScoreLd + row]. Both products are fmaf chains in the plain
// version's order (kernels/flash/tile.py:fma_chain): the scores in depth
// order, the values in column order.
constexpr int kChunkThreads = 128;
constexpr int kChunkRows = 32;
constexpr int kStageRows = 64;
constexpr int kStagePad = 4;
constexpr int kScoreLd = kChunkRows + kStagePad;

// Raw bytes of one staged sub-tile (kStageRows rows of D elements of KV) in
// flight in registers: 16-byte pieces, kPer a thread, and one scale row.
template <typename KV, int D>
struct Stage {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kPieces = kStageRows * kPerRow;
  static constexpr int kPer = (kPieces + kChunkThreads - 1) / kChunkThreads;
  uint4 raw[kPer];
  float sc;

  // rows r < nrows, row r from src_row(r) (its first byte) and, for codes,
  // its scale from sc_row(r); zeros past nrows
  template <typename SrcRow, typename ScRow>
  __device__ __forceinline__ void fetch_at(SrcRow src_row, ScRow sc_row, int nrows,
                                           bool vec16) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kChunkThreads;
      const int r = i / kPerRow;
      raw[c] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kPieces && r < nrows) {
        const unsigned char* p = src_row(r) + (i - r * kPerRow) * 16;
        if (vec16) {
          raw[c] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const unsigned* w = reinterpret_cast<const unsigned*>(p);
          raw[c] = make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
        }
      }
    }
    sc = 0.0f;
    if (IsCode<KV>::value && static_cast<int>(threadIdx.x) < nrows)
      sc = __ldg(sc_row(static_cast<int>(threadIdx.x)));
  }

  // the same for rows contiguous from src, scales from scale (codes only)
  __device__ __forceinline__ void fetch(const KV* src, const float* scale, int nrows,
                                        bool vec16) {
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
    fetch_at([=](int r) { return base + static_cast<int64_t>(r) * kRowBytes; },
             [=](int r) { return scale + r; }, nrows, vec16);
  }

  // the sub-tile as float32 rows x_s[r * (D + kStagePad) + d], zeros past nrows
  __device__ __forceinline__ void commit(float* x_s, float* sc_s) const {
    constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kChunkThreads;
      if (i >= kPieces) continue;
      const int r = i / kPerRow, e0 = (i - r * kPerRow) * kElems;
      float4* dst = reinterpret_cast<float4*>(x_s + r * (D + kStagePad) + e0);
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
    if (threadIdx.x < kStageRows) sc_s[threadIdx.x] = sc;
  }
};

// The scores of one staged K sub-tile (x_s, its scale rows sc_s) for the
// CTA's query rows (q_s): p_s[j * kScoreLd + row] = (q_row . k_j) * scale
// [* sc_s[j]] for the columns j < ncols. A 4 x 4 block of (rows, columns) a
// thread: rows 4 rg.., columns cg + 16 c.
template <int D, bool QUANT>
__device__ __forceinline__ void score_block(const float* q_s, const float* x_s,
                                            const float* sc_s, float* p_s, int ncols,
                                            float scale) {
  static_assert(kChunkRows / 4 * 16 == kChunkThreads && kStageRows == 64, "thread mapping");
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qv[r] = *reinterpret_cast<const float4*>(q_s + (4 * rg + r) * (D + kStagePad) + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      kv[c] = *reinterpret_cast<const float4*>(x_s + (cg + 16 * c) * (D + kStagePad) + d);
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
    *reinterpret_cast<float4*>(p_s + col * kScoreLd + 4 * rg) = make_float4(s[0], s[1], s[2], s[3]);
  }
}

// dsum[r][e] += sum_{j < ncols} w_j[r] v_j[e], in column order, for a
// thread's RPT rows (1, 2, 4 or 8: head dims 16, 32, 64, 128) and 4
// features: pw points at the first column's weights of those rows (p_s +
// col * kScoreLd + RPT * row group), xv at the first column's features (x_s
// + col * (D + kStagePad) + 4 * feature group).
template <int D, int RPT>
__device__ __forceinline__ void value_block(float (&dsum)[RPT][4], const float* pw,
                                            const float* xv, int ncols) {
  static_assert(RPT == 1 || RPT == 2 || RPT == 4 || RPT == 8, "value rows a thread");
#pragma unroll 4
  for (int j = 0; j < ncols; ++j) {
    const float4 v4 = *reinterpret_cast<const float4*>(xv + j * (D + kStagePad));
    float w[RPT];
    if constexpr (RPT >= 4) {
#pragma unroll
      for (int h = 0; h < RPT / 4; ++h) {
        const float4 w4 = *reinterpret_cast<const float4*>(pw + j * kScoreLd + 4 * h);
        w[4 * h] = w4.x;
        w[4 * h + 1] = w4.y;
        w[4 * h + 2] = w4.z;
        w[4 * h + 3] = w4.w;
      }
    } else if constexpr (RPT == 2) {
      const float2 w2 = *reinterpret_cast<const float2*>(pw + j * kScoreLd);
      w[0] = w2.x;
      w[1] = w2.y;
    } else {
      w[0] = pw[j * kScoreLd];
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

// The running state of the CTA's kChunkRows rows: (m, l) of row tid / 4 in
// its four weight threads; acc of RPT rows x 4 features in each thread, rows
// RPT * (tid / (D / 4)) + r, features 4 * (tid % (D / 4)) + e.
template <int D>
struct ChunkRows {
  static constexpr int kGroups = D / 4;                              // 4-feature groups
  static constexpr int RPT = kChunkRows * kGroups / kChunkThreads;  // value rows a thread
  static_assert(kChunkRows * 4 == kChunkThreads, "four weight threads a row");
  float m = kMaskValue, l = 0.0f, acc[RPT][4] = {};

  // acc / l of the rows below `rows` into out[base + row * D + feature] as
  // act_dtype; a row with no valid column (l == 0) gives 0. l_s holds
  // kChunkRows floats.
  __device__ __forceinline__ void store(void* out, int64_t base, float* l_s, int rows,
                                        int act_dtype) const {
    const int tid = threadIdx.x;
    if (tid % 4 == 0) l_s[tid / 4] = l;
    __syncthreads();
    const int vrg = tid / kGroups, vdg = tid % kGroups;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = RPT * vrg + r;
      if (row >= rows) continue;
      const float ls = l_s[row];
      const float den = ls == 0.0f ? 1.0f : ls;
      const int64_t o = base + static_cast<int64_t>(row) * D + 4 * vdg;
#pragma unroll
      for (int e = 0; e < 4; ++e) store_act(out, o + e, acc[r][e] / den, act_dtype);
    }
  }
};

// One reference tile of nr columns for the CTA's rows (q_s), called by every
// thread of the CTA: its K sub-tiles of kStageRows rows, each staged into
// x_s (scales sc_s) by advance(), scored into p_s; then, once for the whole
// tile, each row's max, weights (in place of the scores), their sum and the
// rescale of (m, l), four threads a row, the factor passed to the value
// threads through r_s (kChunkRows floats); then its V sub-tiles, staged by
// advance(), multiplied by the weights in column order from a fresh chain,
// and folded into acc.
// valid(r, j) is the mask of column j < nr of row r; dense says that every
// column read is valid. For codes, vscale points at the tile's v scale
// rows, which the weights take (staged through vt_s, nr floats).
template <int D, bool EXPMUL, bool QUANT, typename Advance, typename Valid>
__device__ __forceinline__ void chunk_tile_step(ChunkRows<D>& st, const float* q_s, float* p_s,
                                                const float* x_s, const float* sc_s,
                                                float* vt_s, float* r_s,
                                                const float* __restrict__ vscale, int nr,
                                                float scale, bool dense, Advance advance,
                                                Valid valid) {
  constexpr int RPT = ChunkRows<D>::RPT, DG = ChunkRows<D>::kGroups;
  const int tid = threadIdx.x;
  const int wrow = tid / 4, wpart = tid % 4;
  const int vrg = tid / DG, vdg = tid % DG;
  const int ns = (nr + kStageRows - 1) / kStageRows;
  for (int sub = 0; sub < ns; ++sub) {
    advance();
    score_block<D, QUANT>(q_s, x_s, sc_s, p_s + sub * kStageRows * kScoreLd,
                          min(kStageRows, nr - sub * kStageRows), scale);
  }
  if constexpr (QUANT) {
    for (int j = tid; j < nr; j += kChunkThreads) vt_s[j] = vscale[j];
  }
  __syncthreads();
  {
    float mx = kMaskValue;
#pragma unroll 4
    for (int j = wpart; j < nr; j += 4)
      if (dense || valid(wrow, j)) mx = fmaxf(mx, p_s[j * kScoreLd + wrow]);
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(st.m, mx);
    float ps = 0.0f;
#pragma unroll 4
    for (int j = wpart; j < nr; j += 4) {
      float* pj = p_s + j * kScoreLd + wrow;
      const float p = dense || valid(wrow, j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
      ps += p;
      *pj = QUANT ? p * vt_s[j] : p;  // the weight the value product takes
    }
    ps += __shfl_xor_sync(kFull, ps, 1);
    ps += __shfl_xor_sync(kFull, ps, 2);
    const float r = rescale_factor<EXPMUL>(st.m, m_new);
    st.l = rescale<EXPMUL>(st.l, r) + ps;
    st.m = m_new;
    if (wpart == 0) r_s[wrow] = r;
  }
  // the values: dsum[r][e] = sum_j w_rj v_j[4 vdg + e], in column order
  float dsum[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsum[r][e] = 0.0f;
  for (int sub = 0; sub < ns; ++sub) {
    advance();  // its first barrier also publishes the weights and r_s
    value_block<D, RPT>(dsum, p_s + sub * kStageRows * kScoreLd + RPT * vrg, x_s + 4 * vdg,
                        min(kStageRows, nr - sub * kStageRows));
  }
  // the online-softmax update, once per tile
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float f = r_s[RPT * vrg + r];
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[r][e] = rescale<EXPMUL>(st.acc[r][e], f) + dsum[r][e];
  }
}

}  // namespace repro
