// Hopper building blocks of the contiguous decode and prefill kernels
// (csrc/decode.cu, csrc/prefill.cu): asynchronous copies into shared
// memory, the thread-block-cluster barrier, conversions of staged KV codes,
// and the online-softmax weight and rescale of one tile.
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

// Copy `rows` rows of `row_bytes` bytes (a multiple of 4) from global src
// (rows contiguous) to shared dst (rows `dst_stride` bytes apart), in
// 16-byte pieces when both sides allow it, else in 4-byte pieces. Called by
// every thread of the CTA; the caller commits and waits.
__device__ __forceinline__ void copy_rows_async(unsigned char* dst, int dst_stride,
                                                const unsigned char* src, int rows,
                                                int row_bytes, bool vec16) {
  const int piece = vec16 ? 16 : 4;
  const int per_row = row_bytes / piece;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * piece;
    unsigned char* d = dst + r * dst_stride + c;
    const unsigned char* s = src + static_cast<int64_t>(r) * row_bytes + c;
    if (vec16) {
      cp_async16(d, s);
    } else {
      cp_async4(d, s);
    }
  }
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

}  // namespace repro
