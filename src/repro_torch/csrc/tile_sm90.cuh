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

// The rows as they lie in device memory: the bytes of a K row and of a V
// row (the call's true head dims, at most the built widths') and the widest
// piece, 16, 4 or 1 bytes, that every row start and row length allows. A row
// of D 20 in bfloat16 (40 bytes) or of D 40 in int8 puts every row after the
// first off a 16-byte boundary, so such rows are read in narrower pieces.
struct RowBytes {
  int k, v, piece;
};

// the widest piece (16, 4 or 1 bytes) that divides every address or length
// or-ed into `bits`
__host__ __device__ constexpr int piece_of(uintptr_t bits) {
  return bits % 16 == 0 ? 16 : (bits % 4 == 0 ? 4 : 1);
}

// ---- the paged kernels' two walks (csrc/paged_decode.cu, paged_prefill.cu) --
// Each paged kernel is instantiated twice a (KV dtype, width, variant): the
// general walk takes every call of the contract; the whole-row walk takes
// only calls at D == Dv == the built width, rows in 16-byte pieces and pages
// the kernel stages at once, every test of the contract a constant. The host
// chooses, never the kernel: `walk` is kWalkAuto (the whole-row walk where
// the call qualifies), kWalkGeneral or kWalkWhole. Returns the walk taken,
// or -1 for a forced whole-row walk on a call that does not qualify.
enum : int { kWalkAuto = -1, kWalkGeneral = 0, kWalkWhole = 1 };

inline int choose_walk(int walk, bool whole_fits) {
  if (walk == kWalkAuto) return whole_fits ? kWalkWhole : kWalkGeneral;
  if (walk == kWalkGeneral) return kWalkGeneral;
  return walk == kWalkWhole && whole_fits ? kWalkWhole : -1;
}

// A source built in parts, one a KV dtype (kernels/build.py compiles it with
// -DREPRO_PART=<the dtype's code>, the REPRO_PART_* below), keeps only its
// part's kernels; the float32 part also holds the C entries, which reach
// the other parts through declared functions. Without REPRO_PART one object
// holds them all.
#define REPRO_PART_F32 0
#define REPRO_PART_BF16 1
#define REPRO_PART_I8 2
#define REPRO_PART_FP8 3
static_assert(REPRO_PART_F32 == kF32 && REPRO_PART_BF16 == kBF16 && REPRO_PART_I8 == kI8 &&
                  REPRO_PART_FP8 == kFP8,
              "a part's number is its dtype's code");
#ifdef REPRO_PART
#define REPRO_IN_PART(P) (REPRO_PART == (P))
#else
#define REPRO_IN_PART(P) 1
#endif

// Copy `rows` rows of `row_bytes` bytes from global memory, row r starting at
// src_row(r), to shared dst (rows `dst_stride` bytes apart), in pieces of
// `piece` bytes (16 or 4 by cp.async; 1 by plain loads and stores, which the
// caller's barrier publishes), then zero bytes [row_bytes, fill_bytes) of each
// row: the features past the call's head dim that the fmaf chains walk at the
// built width. `piece` divides row_bytes, dst_stride and every src_row(r).
// Called by every thread of the CTA; the caller commits and waits.
template <typename SrcRow>
__device__ __forceinline__ void copy_rows_async_at(unsigned char* dst, int dst_stride, int rows,
                                                   int row_bytes, int fill_bytes, int piece,
                                                   SrcRow src_row) {
  const int per_row = row_bytes / piece;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * piece;
    unsigned char* d = dst + r * dst_stride + c;
    const unsigned char* s = src_row(r) + c;
    if (piece == 16) {
      cp_async16(d, s);
    } else if (piece == 4) {
      cp_async4(d, s);
    } else {
      *d = __ldg(s);
    }
  }
  // the zero tail: up to three bytes to a word boundary, then words
  const int z0 = (row_bytes + 3) & ~3;
  const int nb = z0 < fill_bytes ? z0 - row_bytes : fill_bytes - row_bytes;
  for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
    const int r = i / nb;
    dst[r * dst_stride + row_bytes + (i - r * nb)] = 0;
  }
  const int nw = (fill_bytes - z0) / 4;
  for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
    const int r = i / nw;
    *reinterpret_cast<unsigned*>(dst + r * dst_stride + z0 + 4 * (i - r * nw)) = 0u;
  }
}

// The same for rows contiguous in global memory from src, `row_bytes` apart.
__device__ __forceinline__ void copy_rows_async(unsigned char* dst, int dst_stride,
                                                const unsigned char* src, int rows,
                                                int row_bytes, int fill_bytes, int piece) {
  copy_rows_async_at(dst, dst_stride, rows, row_bytes, fill_bytes, piece,
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
// query rows), q in shared memory as float32 rows of DK + kStagePad; KV staged in
// sub-tiles of kStageRows rows (the next one's 16-byte loads in flight in
// registers while the current one is computed on), converted to float32
// rows in shared memory; the scores transposed, p_s[col * kScoreLd + row].
// K rows hold DK features and V rows DV (MLA: DK 96, DV 64); both are staged
// at one row stride, max(DK, DV) + kStagePad floats. Both products are fmaf
// chains in the plain version's order (kernels/flash/tile.py:fma_chain): the
// scores in depth order, the values in column order.
constexpr int kChunkThreads = 128;
constexpr int kChunkRows = 32;
constexpr int kStageRows = 64;
constexpr int kStagePad = 4;
constexpr int kScoreLd = kChunkRows + kStagePad;

// The value side's feature width: the least power of two (from 16) at or
// above dv, so that the kChunkRows rows of width / 4 feature groups share out
// evenly over the kChunkThreads threads. At head dim 112 (kimi-k2-1t-a32b,
// 28 feature groups) it is 128: the staged rows are padded to 128 features,
// the padding zero (zero_value_pad), and the padded features' accumulators
// are summed and never stored. Each output feature is its own fmaf chain
// over the columns, so the 112 real ones keep the plain version's bits.
__host__ __device__ constexpr int value_width(int dv) {
  int w = 16;
  while (w < dv) w *= 2;
  return w;
}

// the staged rows' width in floats (their stride is this + kStagePad): K rows
// of dk features, V rows of value_width(dv)
__host__ __device__ constexpr int staged_width(int dk, int dv) {
  return dk > value_width(dv) ? dk : value_width(dv);
}

// Zero the padded features [max(DK, DV), staged_width(DK, DV)) of the
// kStageRows staged rows at x_s once, before the first barrier: no staging
// writes them, and the padded value accumulators read them.
template <int DK, int DV>
__device__ __forceinline__ void zero_value_pad(float* x_s) {
  constexpr int kLo = DK > DV ? DK : DV, kHi = staged_width(DK, DV), kN = kHi - kLo;
  if constexpr (kN > 0) {
    for (int i = threadIdx.x; i < kStageRows * kN; i += kChunkThreads) {
      const int r = i / kN;
      x_s[r * (kHi + kStagePad) + kLo + (i - r * kN)] = 0.0f;
    }
  }
}

// Raw bytes of one staged sub-tile (kStageRows rows of DK elements of KV, or
// of DV for V rows: the `v` argument of fetch and load) in flight in
// registers: 16-byte pieces, kPer a thread, and one scale row. Rows land at
// a stride of DS + kStagePad floats, DS = staged_width(DK, DV). A call at
// narrower head dims (RowBytes: the rows' true bytes in device memory) reads
// only those bytes and stages zeros in the rest of the built width, so every
// fmaf chain over the padding adds fmaf(0, 0, acc) = acc: the call's bits.
// At D 256 a thread's value accumulators take 128 registers (ChunkRows<256>
// has RPT 16): there rows of more than 8 pieces a thread (float32 and
// bfloat16) are not held in flight (kSync): load() reads and converts them
// straight into shared memory when the step begins.
template <typename KV, int DK, int DV = DK>
struct Stage {
  static constexpr int DS = staged_width(DK, DV);
  static constexpr int kRowBytes = DK * static_cast<int>(sizeof(KV));
  static constexpr int kVRowBytes = DV * static_cast<int>(sizeof(KV));
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kVPerRow = kVRowBytes / 16;
  static constexpr int kPieces = kStageRows * (kPerRow > kVPerRow ? kPerRow : kVPerRow);
  static constexpr int kPer = (kPieces + kChunkThreads - 1) / kChunkThreads;
  static constexpr bool kSync = DS >= 256 && kPer > 8;
  uint4 raw[kSync ? 1 : kPer];
  float sc;
  bool v_rows = false;  // the rows in flight are V rows (read only when DV != DK)

  __device__ __forceinline__ static constexpr int per_row(bool v) {
    return DV != DK && v ? kVPerRow : kPerRow;
  }

  // the 16 bytes at p of which the first n (<= 0: none) lie in the row,
  // zeros past them, read in pieces of `piece` bytes (RowBytes::piece):
  // one 16-byte load, up to four 4-byte ones, or (a row off a 4-byte
  // boundary: D 20 in bfloat16, D 40 in int8) a byte loop kept rolled, so
  // the unrolled staging loops stay small
  __device__ __forceinline__ static uint4 piece(const unsigned char* p, int n, int piece) {
    if (n <= 0) return make_uint4(0u, 0u, 0u, 0u);
    if (piece == 16) return __ldg(reinterpret_cast<const uint4*>(p));
    if (piece == 4) {
      const unsigned* w = reinterpret_cast<const unsigned*>(p);
      return make_uint4(__ldg(w), n > 4 ? __ldg(w + 1) : 0u, n > 8 ? __ldg(w + 2) : 0u,
                        n > 12 ? __ldg(w + 3) : 0u);
    }
    unsigned long long lo = 0ull, hi = 0ull;
#pragma unroll 1
    for (int b = 0; b < n && b < 16; ++b) {
      const unsigned long long x = __ldg(p + b);
      if (b < 8) {
        lo |= x << (8 * b);
      } else {
        hi |= x << (8 * (b - 8));
      }
    }
    return make_uint4(static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
                      static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32));
  }

  // piece i of the sub-tile (its raw bytes raw_i, rows of pr pieces) as
  // float32 in its row of x_s
  __device__ __forceinline__ static void put(float* x_s, int i, uint4 raw_i, int pr) {
    constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
    const int r = i / pr, e0 = (i - r * pr) * kElems;
    float4* dst = reinterpret_cast<float4*>(x_s + r * (DS + kStagePad) + e0);
    const unsigned w[4] = {raw_i.x, raw_i.y, raw_i.z, raw_i.w};
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

  // rows r < nrows, row r from src_row(r) (its first byte; rb.k or rb.v
  // bytes of it read) and, for codes, its scale from sc_row(r); zeros past
  // nrows and past the row's bytes
  template <typename SrcRow, typename ScRow>
  __device__ __forceinline__ void fetch_at(SrcRow src_row, ScRow sc_row, int nrows,
                                           const RowBytes& rb, bool v = false) {
    static_assert(!kSync, "loaded at the step, not fetched ahead");
    v_rows = v;
    const int pr = per_row(v), pieces = kStageRows * pr, bytes = v ? rb.v : rb.k;
    if (rb.piece == 16 && bytes == pr * 16) {  // rows of whole 16-byte pieces
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int i = threadIdx.x + c * kChunkThreads;
        const int r = i / pr;
        raw[c] = make_uint4(0u, 0u, 0u, 0u);
        if (i < pieces && r < nrows)
          raw[c] = __ldg(reinterpret_cast<const uint4*>(src_row(r) + (i - r * pr) * 16));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int i = threadIdx.x + c * kChunkThreads;
        const int r = i / pr, b0 = (i - r * pr) * 16;
        raw[c] = make_uint4(0u, 0u, 0u, 0u);
        if (i < pieces && r < nrows) raw[c] = piece(src_row(r) + b0, bytes - b0, rb.piece);
      }
    }
    sc = 0.0f;
    if (IsCode<KV>::value && static_cast<int>(threadIdx.x) < nrows)
      sc = __ldg(sc_row(static_cast<int>(threadIdx.x)));
  }

  // the same for rows contiguous from src (rb.k or rb.v bytes apart),
  // scales from scale (codes only)
  __device__ __forceinline__ void fetch(const KV* src, const float* scale, int nrows,
                                        const RowBytes& rb, bool v = false) {
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
    const int64_t row = v ? rb.v : rb.k;
    fetch_at([=](int r) { return base + static_cast<int64_t>(r) * row; },
             [=](int r) { return scale + r; }, nrows, rb, v);
  }

  // the sub-tile as float32 rows x_s[r * (DS + kStagePad) + d], zeros past nrows
  __device__ __forceinline__ void commit(float* x_s, float* sc_s) const {
    static_assert(!kSync, "loaded at the step, not fetched ahead");
    const int pr = per_row(v_rows), pieces = kStageRows * pr;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * kChunkThreads;
      if (i < pieces) put(x_s, i, raw[c], pr);
    }
    if (threadIdx.x < kStageRows) sc_s[threadIdx.x] = sc;
  }

  // kSync: the rows of fetch_at straight into x_s and sc_s, as commit puts
  // them (the caller's barriers fence x_s)
  template <typename SrcRow, typename ScRow>
  __device__ __forceinline__ void load_at(float* x_s, float* sc_s, SrcRow src_row,
                                          ScRow sc_row, int nrows, const RowBytes& rb,
                                          bool v = false) const {
    const int pr = per_row(v), pieces = kStageRows * pr, bytes = v ? rb.v : rb.k;
#pragma unroll 4
    for (int i = threadIdx.x; i < pieces; i += kChunkThreads) {
      const int r = i / pr, b0 = (i - r * pr) * 16;
      put(x_s, i,
          r < nrows ? piece(src_row(r) + b0, bytes - b0, rb.piece)
                    : make_uint4(0u, 0u, 0u, 0u),
          pr);
    }
    if (threadIdx.x < kStageRows)
      sc_s[threadIdx.x] = IsCode<KV>::value && static_cast<int>(threadIdx.x) < nrows
                              ? __ldg(sc_row(static_cast<int>(threadIdx.x)))
                              : 0.0f;
  }

  __device__ __forceinline__ void load(float* x_s, float* sc_s, const KV* src,
                                       const float* scale, int nrows, const RowBytes& rb,
                                       bool v = false) const {
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
    const int64_t row = v ? rb.v : rb.k;
    load_at(x_s, sc_s, [=](int r) { return base + static_cast<int64_t>(r) * row; },
            [=](int r) { return scale + r; }, nrows, rb, v);
  }
};

// The scores of one staged K sub-tile (x_s, rows XLD floats apart; its scale
// rows sc_s) for the CTA's query rows (q_s, rows D + kStagePad apart):
// p_s[j * kScoreLd + row] = (q_row . k_j) * scale [* sc_s[j]] for the
// columns j < ncols. A 4 x 4 block of (rows, columns) a thread: rows 4 rg..,
// columns cg + 16 c.
template <int D, bool QUANT, int XLD = D + kStagePad>
__device__ __forceinline__ void score_block(const float* q_s, const float* x_s,
                                            const float* sc_s, float* p_s, int ncols,
                                            float scale) {
  static_assert(kChunkRows / 4 * 16 == kChunkThreads && kStageRows == 64, "thread mapping");
  static_assert(D % 4 == 0, "the depth loop's step of 4 must divide D: every feature scored");
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
      kv[c] = *reinterpret_cast<const float4*>(x_s + (cg + 16 * c) * XLD + d);
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
// thread's RPT rows (1, 2, 4, 8 or 16: value widths 16, 32, 64, 128, 256) and 4
// features: pw points at the first column's weights of those rows (p_s +
// col * kScoreLd + RPT * row group), xv at the first column's features (x_s
// + col * XLD + 4 * feature group; rows XLD floats apart).
template <int D, int RPT, int XLD = D + kStagePad>
__device__ __forceinline__ void value_block(float (&dsum)[RPT][4], const float* pw,
                                            const float* xv, int ncols) {
  static_assert(RPT == 1 || RPT == 2 || RPT == 4 || RPT == 8 || RPT == 16,
                "value rows a thread");
#pragma unroll 4
  for (int j = 0; j < ncols; ++j) {
    const float4 v4 = *reinterpret_cast<const float4*>(xv + j * XLD);
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
// RPT * (tid / kGroups) + r, features 4 * (tid % kGroups) + e (those at or
// past D are value_width's padding, never stored).
template <int D>
struct ChunkRows {
  static constexpr int kGroups = value_width(D) / 4;                 // 4-feature groups
  static constexpr int RPT = kChunkRows * kGroups / kChunkThreads;  // value rows a thread
  static_assert(kChunkRows * 4 == kChunkThreads, "four weight threads a row");
  float m = kMaskValue, l = 0.0f, acc[RPT][4] = {};

  // acc / l of the rows below `rows` and the features below dv (the call's
  // value head dim, at most D) into out[base + row * dv + feature] as
  // act_dtype; a row with no valid column (l == 0) gives 0. l_s holds
  // kChunkRows floats.
  __device__ __forceinline__ void store(void* out, int64_t base, float* l_s, int rows,
                                        int act_dtype, int dv = D) const {
    const int tid = threadIdx.x;
    if (tid % 4 == 0) l_s[tid / 4] = l;
    __syncthreads();
    const int vrg = tid / kGroups, vdg = tid % kGroups;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = RPT * vrg + r;
      if (row >= rows || 4 * vdg >= dv) continue;
      const float ls = l_s[row];
      const float den = ls == 0.0f ? 1.0f : ls;
      const int64_t o = base + static_cast<int64_t>(row) * dv + 4 * vdg;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * vdg + e < dv) store_act(out, o + e, acc[r][e] / den, act_dtype);
    }
  }
};

// One reference tile of nr columns for the CTA's rows (q_s, D features), called
// by every thread of the CTA: its K sub-tiles of kStageRows rows, each staged
// into x_s (rows staged_width(D, DV) + kStagePad floats apart; scales sc_s) by
// advance(), scored into p_s; then, once for the whole
// tile, each row's max, weights (in place of the scores), their sum and the
// rescale of (m, l), four threads a row, the factor passed to the value
// threads through r_s (kChunkRows floats); then its V sub-tiles, staged by
// advance(), multiplied by the weights in column order from a fresh chain,
// and folded into acc.
// valid(r, j) is the mask of column j < nr of row r; dense says that every
// column read is valid. For codes, vscale points at the tile's v scale
// rows, which the weights take (staged through vt_s, nr floats).
template <int D, bool EXPMUL, bool QUANT, int DV, typename Advance, typename Valid>
__device__ __forceinline__ void chunk_tile_step(ChunkRows<DV>& st, const float* q_s, float* p_s,
                                                const float* x_s, const float* sc_s,
                                                float* vt_s, float* r_s,
                                                const float* __restrict__ vscale, int nr,
                                                float scale, bool dense, Advance advance,
                                                Valid valid) {
  constexpr int RPT = ChunkRows<DV>::RPT, DG = ChunkRows<DV>::kGroups;
  constexpr int XLD = staged_width(D, DV) + kStagePad;  // staged rows' stride
  const int tid = threadIdx.x;
  const int wrow = tid / 4, wpart = tid % 4;
  const int vrg = tid / DG, vdg = tid % DG;
  const int ns = (nr + kStageRows - 1) / kStageRows;
  for (int sub = 0; sub < ns; ++sub) {
    advance();
    score_block<D, QUANT, XLD>(q_s, x_s, sc_s, p_s + sub * kStageRows * kScoreLd,
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
      if (dense || valid(wrow, j)) mx = max_nan(mx, p_s[j * kScoreLd + wrow]);
    mx = max_nan(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = max_nan(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = max_nan(st.m, mx);
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
    value_block<DV, RPT, XLD>(dsum, p_s + sub * kStageRows * kScoreLd + RPT * vrg, x_s + 4 * vdg,
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
