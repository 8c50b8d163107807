// The shared online-softmax tile step of the attention kernels.
//
// Replaces kernels/flash/tile.py:28 (online_softmax_tile) and :79
// (finalize_tiles) of the JAX package: the ExpMul numerics, the warp
// reductions and, for csrc/flash.cu,
//
//  - wide_tile_step: a KV tile of up to kMaxTile
//    columns (the reference's block_k, at most 512). The tile is
//    staged in sub-tiles of kSubRows rows, lane j scoring columns j, j + 32,
//    ... into shared memory; the row max, the rescale and the weight sum
//    are taken once for the whole tile, as tile.py does, then the value
//    product runs over all of its columns. Splitting a tile into narrower
//    steps would change ExpMul results (lhat is rounded per step).
//
// The arithmetic is that of tile.py, operation for operation:
//
//   s   = (q . k) * scale [* k_scale]        masked columns -> MASK_VALUE
//   m'  = max(m, max_j s_j)                  m starts at MASK_VALUE
//   exact:  alpha = expf(m - m');  p_j = expf(s_j - m')
//           l' = l * alpha + sum p;  acc' = acc * alpha + sum_j p_j v_scale_j v_j
//   expmul: lr = lhat(m - m');  p_j = 2^-lhat(s_j - m')
//           l' = pow2scale(l, lr) + sum p;  acc' = pow2scale(acc, lr) + sum_j ...
//   masked p_j = 0;  finalize: acc / (l == 0 ? 1 : l)
//
// lhat, pow2scale and 2^-L are the bit-level ExpMul contract of
// numerics/log2exp.py: rintf-style rounding (__float2int_rn), arithmetic
// shifts on int32, and a flush to +0 when the biased exponent reaches <= 0.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kMaskValue = -1e30f;
constexpr int kWarp = 32;
constexpr int kMaxPage = 32;  // a KV tile (one page) is at most one warp wide
constexpr int kMaxTile = 512;  // widest contiguous KV tile (the prefill's)
constexpr int kSubRows = 64;   // KV rows staged at once by wide_tile_step
constexpr unsigned kFull = 0xffffffffu;

// dtype codes shared with the Python wrappers (kernels/build.py users)
enum : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

template <typename T> struct IsCode { static constexpr bool value = false; };
template <> struct IsCode<int8_t> { static constexpr bool value = true; };
template <> struct IsCode<__nv_fp8_e4m3> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// q and the output are float32 or bfloat16 (a runtime flag: read once)
__device__ __forceinline__ float load_act(const void* p, int64_t i, int dtype) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_act(void* p, int64_t i, float x, int dtype) {
  if (dtype == kF32) {
    static_cast<float*>(p)[i] = x;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
}

// ---- ExpMul numerics (numerics/log2exp.py) --------------------------------
// A NaN x gives 0, as the reference's clip-then-cast does (fminf/fmaxf
// would drop the NaN and clamp it to -15).
__device__ __forceinline__ int log2exp_lhat(float x) {
  if (x != x) return 0;
  const float xc = fminf(fmaxf(x, -15.0f), 0.0f);
  const int xfix = __float2int_rn(xc * 1024.0f);  // round half to even
  const int acc = xfix + (xfix >> 1) - (xfix >> 4);  // arithmetic shifts
  return (512 - acc) >> 10;                          // round half up
}

__device__ __forceinline__ float apply_pow2_scale(float v, int lhat) {
  const int bits = __float_as_int(v);
  const int e = ((bits >> 23) & 0xFF) - lhat;
  if (e <= 0) return 0.0f;  // underflow, denormals and -0 flush to +0
  return __int_as_float((bits & ~(0xFF << 23)) | (e << 23));
}

__device__ __forceinline__ float pow2_neg(int lhat) {
  const int e = 127 - lhat;
  return e <= 0 ? 0.0f : __int_as_float(e << 23);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Running (m, l, acc) of one query row, held by its warp: m and l are the
// same in every lane, lane i holds acc[d] for d = i + 32 * t.
template <int D>
struct RowState {
  static constexpr int kPerLane = (D + kWarp - 1) / kWarp;
  float m, l, acc[kPerLane];

  __device__ __forceinline__ void init() {
    m = kMaskValue;
    l = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[t] = 0.0f;
  }

  // acc / l into out[base + d]; a row with no valid column (l == 0) gives 0
  __device__ __forceinline__ void finalize(void* out, int64_t base, int dtype,
                                           int lane) const {
    const float den = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int d = lane + kWarp * t;
      if (d < D) store_act(out, base + d, acc[t] / den, dtype);
    }
  }
};

// One KV tile of up to kMaxTile columns for the R query rows of each warp
// (row w * R + i of the CTA for warp w), called by every thread of the CTA.
//
// q_s[row * D + d] holds the CTA's query rows in float32; s_s (row stride
// s_ld >= the tile width) receives the scores and then the weights;
// kv_s[kSubRows * (D + 1)] and sc_s[kSubRows] stage the sub-tiles. k, v
// point at the tile's first KV row (rows of D contiguous values or codes),
// ks, vs at its scale rows (codes only). Only the first nr columns are read:
// every later column of the tile must be masked for every row, which the
// callers guarantee (columns at or past the length, the span or the chunk's
// valid count). valid(row, j) is the mask of the columns j < nr. Rows at or
// past `rows` are left untouched.
//
// Skipping the masked columns is exact: a masked column contributes no
// weight, and the running max starts at kMaskValue, which is also the score
// of a masked column.
template <int D, int R, bool EXPMUL, bool QUANT, typename KV, typename Valid>
__device__ __forceinline__ void wide_tile_step(RowState<D> (&st)[R], const float* q_s,
                                               float* s_s, int s_ld, float* kv_s,
                                               float* sc_s, const KV* __restrict__ k,
                                               const KV* __restrict__ v,
                                               const float* __restrict__ ks,
                                               const float* __restrict__ vs, int nr,
                                               int rows, float scale, Valid valid) {
  constexpr int P = RowState<D>::kPerLane;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  __syncthreads();  // the previous tile's readers of s_s, kv_s and sc_s are done
  // 1. scores: s_s[row][j] = (q . k_j) * scale [* ks_j], masked -> kMaskValue
  for (int j0 = 0; j0 < nr; j0 += kSubRows) {
    const int m = min(kSubRows, nr - j0);
    for (int i = threadIdx.x; i < m * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      kv_s[r * (D + 1) + d] = to_f32(k[static_cast<int64_t>(j0 + r) * D + d]);
    }
    if (QUANT) {
      for (int r = threadIdx.x; r < m; r += blockDim.x) sc_s[r] = ks[j0 + r];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSubRows / kWarp; ++u) {
      const int jl = lane + kWarp * u;
      if (jl >= m) break;
      float dot[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dot[i] = 0.0f;
      const float* kr = kv_s + jl * (D + 1);
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < R; ++i) dot[i] = fmaf(q_s[(warp * R + i) * D + d], kd, dot[i]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = warp * R + i;
        if (row >= rows) continue;
        float sc = dot[i] * scale;
        if (QUANT) sc *= sc_s[jl];
        s_s[row * s_ld + j0 + jl] = valid(row, j0 + jl) ? sc : kMaskValue;
      }
    }
    __syncthreads();  // kv_s is consumed
  }

  // 2. per row: the tile max, the weights (in place of the scores), their sum
  float m_new[R], psum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = warp * R + i;
    m_new[i] = st[i].m;
    psum[i] = 0.0f;
    if (row >= rows) continue;  // warp-uniform
    float* sr = s_s + row * s_ld;
    float mx = kMaskValue;
    for (int j = lane; j < nr; j += kWarp) mx = fmaxf(mx, sr[j]);
    m_new[i] = fmaxf(st[i].m, warp_max(mx));
    float ps = 0.0f;
    for (int j = lane; j < nr; j += kWarp) {
      const float s = sr[j];
      float p = 0.0f;
      if (valid(row, j)) p = EXPMUL ? pow2_neg(log2exp_lhat(s - m_new[i])) : expf(s - m_new[i]);
      sr[j] = p;
      ps += p;
    }
    psum[i] = warp_sum(ps);
  }

  // 3. values: dsum[row][d] = sum_j (p_j [* vs_j]) v_j[d]
  float dsum[R][P];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < P; ++t) dsum[i][t] = 0.0f;
  for (int j0 = 0; j0 < nr; j0 += kSubRows) {
    const int m = min(kSubRows, nr - j0);
    for (int i = threadIdx.x; i < m * D; i += blockDim.x)
      kv_s[i] = to_f32(v[static_cast<int64_t>(j0) * D + i]);
    if (QUANT) {
      for (int r = threadIdx.x; r < m; r += blockDim.x) sc_s[r] = vs[j0 + r];
    }
    __syncthreads();  // also publishes step 2's weights to the whole warp
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = warp * R + i;
      if (row >= rows) continue;
      const float* pr = s_s + row * s_ld + j0;
      for (int jj = 0; jj < m; ++jj) {
        float w = pr[jj];
        if (QUANT) w *= sc_s[jj];
        const float* vr = kv_s + jj * D;
#pragma unroll
        for (int t = 0; t < P; ++t) {
          const int d = lane + kWarp * t;
          if (d < D) dsum[i][t] = fmaf(w, vr[d], dsum[i][t]);
        }
      }
    }
    __syncthreads();  // kv_s is consumed
  }

  // 4. the online-softmax update, once per tile
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (warp * R + i >= rows) continue;
    if (EXPMUL) {
      const int lr = log2exp_lhat(st[i].m - m_new[i]);
      st[i].l = apply_pow2_scale(st[i].l, lr) + psum[i];
#pragma unroll
      for (int t = 0; t < P; ++t) st[i].acc[t] = apply_pow2_scale(st[i].acc[t], lr) + dsum[i][t];
    } else {
      const float alpha = expf(st[i].m - m_new[i]);
      st[i].l = st[i].l * alpha + psum[i];
#pragma unroll
      for (int t = 0; t < P; ++t) st[i].acc[t] = st[i].acc[t] * alpha + dsum[i][t];
    }
    st[i].m = m_new[i];
  }
}

// Python's `a % n` (never negative for n > 0); C's % truncates toward zero.
__device__ __forceinline__ int py_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

}  // namespace repro
