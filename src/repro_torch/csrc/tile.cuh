// The shared numerics of the attention kernels' online-softmax tile step.
//
// Replaces kernels/flash/tile.py:28 (online_softmax_tile) and :79
// (finalize_tiles) of the JAX package, with tile_sm90.cuh (the tile step
// itself): the ExpMul numerics, the warp reductions, the type conversions.
// A tile's row max, rescale and weight sum are taken once for the whole
// tile (up to kMaxTile columns, the reference's block_k), as tile.py does:
// splitting a tile into narrower steps would change ExpMul results (lhat
// is rounded per step).
//
// The arithmetic is that of tile.py, operation for operation:
//
//   s   = (q . k) * scale [* k_scale]        masked columns -> MASK_VALUE
//   m'  = max(m, max_j s_j)                  m starts at MASK_VALUE; NaN wins
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
constexpr int kMaxPage = 256;  // widest page (a paged kernel's KV tile)
constexpr int kMaxTile = 512;  // widest contiguous KV tile (the prefill's)
constexpr int kMaxHeadDim = 256;  // widest q / K / V row a kernel takes

// the built widths of a kernel's K and V rows
struct Dims {
  int k, v;
};

// The serving kernels' built square widths: a call at head dims (D, Dv)
// runs the narrowest W >= max(D, Dv), reading D and Dv features and staging
// zeros in the rest (0 past kMaxHeadDim: no kernel).
__host__ __device__ constexpr int square_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 112 ? 112 : d <= 128 ? 128
       : d <= kMaxHeadDim ? 256 : 0;
}
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

// The running maximum as the reference takes it (jnp.maximum, and
// torch.maximum in the plain versions): a NaN in either operand gives NaN.
// fmaxf would drop it, leaving m finite under a NaN score; ExpMul's
// lhat(NaN) = 0 then weighs the NaN column 1.0 with l finite, and a later
// rescale by lhat > 0 subtracts from the NaN's exponent field and makes a
// finite number of it. With m NaN every later lhat is 0 and the NaN stays.
// One instruction, as fmaxf is: PTX max.NaN (sm_80 and later) returns the
// canonical NaN when either operand is NaN, fmaxf's result otherwise.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = max_nan(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Python's `a % n` (never negative for n > 0); C's % truncates toward zero.
__device__ __forceinline__ int py_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

}  // namespace repro
