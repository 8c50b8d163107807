// The shared online-softmax tile step of the paged decode and prefill kernels.
//
// Replaces kernels/flash/tile.py:28 (online_softmax_tile) and :79
// (finalize_tiles) of the JAX package. One warp owns one query row: lane j
// scores column j of the KV tile (a tile is one page, at most 32 columns),
// the row max and weight sum are warp reductions, and lane i accumulates
// output features i, i + 32, ... in registers. The arithmetic is that of
// tile.py, operation for operation:
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
__device__ __forceinline__ int log2exp_lhat(float x) {
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

// One KV tile for one query row. The tile sits in shared memory as float32:
// k_t[j * (D + 1) + d] (rows padded by one word so that the lanes' column
// reads fall in distinct banks), v_t[j * D + d], and for codes the per-row
// scales ks_t[j], vs_t[j]. n <= 32 is the tile width; `valid` is this lane's
// column mask (false for lanes >= n).
template <int D, bool EXPMUL, bool QUANT>
__device__ __forceinline__ void row_tile_step(RowState<D>& st, const float* q_row,
                                              const float* k_t, const float* v_t,
                                              const float* ks_t, const float* vs_t,
                                              int n, bool valid, float scale, int lane) {
  constexpr int P = RowState<D>::kPerLane;
  float s = kMaskValue;
  if (lane < n) {
    const float* kr = k_t + lane * (D + 1);
    float dot = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot = fmaf(q_row[d], kr[d], dot);
    float sc = dot * scale;
    if (QUANT) sc *= ks_t[lane];
    s = valid ? sc : kMaskValue;
  }
  const float m_new = fmaxf(st.m, warp_max(s));

  float p, alpha = 1.0f;
  int lr = 0;
  if (EXPMUL) {
    lr = log2exp_lhat(st.m - m_new);
    p = valid ? pow2_neg(log2exp_lhat(s - m_new)) : 0.0f;
  } else {
    alpha = expf(st.m - m_new);
    p = valid ? expf(s - m_new) : 0.0f;
  }
  const float psum = warp_sum(p);
  const float pv = (QUANT && lane < n) ? p * vs_t[lane] : p;

  float dsum[P];
#pragma unroll
  for (int t = 0; t < P; ++t) dsum[t] = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float w = __shfl_sync(kFull, pv, j);
    const float* vr = v_t + j * D;
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int d = lane + kWarp * t;
      if (d < D) dsum[t] = fmaf(w, vr[d], dsum[t]);
    }
  }

  if (EXPMUL) {
    st.l = apply_pow2_scale(st.l, lr) + psum;
#pragma unroll
    for (int t = 0; t < P; ++t) st.acc[t] = apply_pow2_scale(st.acc[t], lr) + dsum[t];
  } else {
    st.l = st.l * alpha + psum;
#pragma unroll
    for (int t = 0; t < P; ++t) st.acc[t] = st.acc[t] * alpha + dsum[t];
  }
  st.m = m_new;
}

}  // namespace repro
