// Contiguous flash-decode: one query token per sequence against per-slot KV
// caches, each sequence's cache a contiguous (S, D) block per KV head.
//
// Replaces the Pallas TPU kernel kernels/decode/decode.py:144
// (decode_fwd_pallas, body _decode_kernel at :67).
//
// What bounds it on the card: the bytes it must read, i.e. the values (or
// codes and scale rows) of every resident token; the arithmetic is
// ~4 * group * D operations per token, far below the H100's ~295 operations
// per byte. A decode step of qwen2-0.5b at 8 sequences x 1k context reads
// ~2 MB per layer, under a microsecond at 3.35 TB/s, so in practice latency
// (the chain of tile loads of one sequence) bounds this simple version.
//
// Design: one CTA per (sequence, KV head), holding the GQA group of query
// rows (one warp per row, the state in registers). The TPU grid's
// sequential KV axis is a loop inside the CTA over tiles of bk = min(256, S)
// columns, the reference's tile width (the ExpMul results depend on it),
// each applied with the shared wide-tile step (tile.cuh). The walk stops at
// min(length, S), and a tile reads only its columns below that bound: the
// rows past the length (a previous occupant's, or zeros) are never read,
// and no padded copy of the cache is needed. Split-KV across CTAs (more
// CTAs than 2 x batch) is left for a later change: merging partial ExpMul
// states is not the reference's sequential walk.
#include "tile.cuh"

using namespace repro;

namespace {

template <typename KV, int D, bool EXPMUL>
__global__ void decode_kernel(const void* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, const int* __restrict__ lens,
                              void* __restrict__ out, int Hkv, int group, int S, int bk,
                              float scale, int act_dtype) {
  constexpr bool QUANT = IsCode<KV>::value;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [group][D]
  float* s_s = q_s + group * D;             // [group][bk]
  float* kv_s = s_s + group * bk;           // [kSubRows][D + 1]
  float* sc_s = kv_s + kSubRows * (D + 1);  // [kSubRows]

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int length = min(lens[b], S);

  for (int i = threadIdx.x; i < group * D; i += blockDim.x)
    q_s[i] = load_act(q, static_cast<int64_t>(bh) * group * D + i, act_dtype);

  RowState<D> st[1];
  st[0].init();
  const int64_t row0 = static_cast<int64_t>(bh) * S;  // this (sequence, head)'s cache
  // the decode mask is `col < length`: exactly the columns a tile reads
  const auto all = [](int, int) { return true; };
  for (int c0 = 0; c0 < length; c0 += bk) {
    const int64_t r = row0 + c0;
    wide_tile_step<D, 1, EXPMUL, QUANT>(st, q_s, s_s, bk, kv_s, sc_s, k + r * D, v + r * D,
                                        QUANT ? ks + r : nullptr, QUANT ? vs + r : nullptr,
                                        min(bk, length - c0), group, scale, all);
  }
  if (warp < group)
    st[0].finalize(out, (static_cast<int64_t>(bh) * group + warp) * D, act_dtype, lane);
}

template <int D>
size_t smem_bytes(int group, int bk) {
  return sizeof(float) * (group * D + group * bk + kSubRows * (D + 1) + kSubRows);
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* lens, void* out, int B, int Hkv, int group, int S, int bk, float scale,
           int act_dtype, cudaStream_t stream) {
  const int warps = group < 4 ? 4 : group;
  const size_t smem = smem_bytes<D>(group, bk);
  auto kernel = decode_kernel<KV, D, EXPMUL>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<B * Hkv, warps * kWarp, smem, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, lens, out, Hkv, group,
      S, bk, scale, act_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* lens, void* out, int B, int Hkv, int group, int S,
           int bk, float scale, int act_dtype, cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                 \
  return expmul ? launch<KV, DIM, true>(q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, \
                                        scale, act_dtype, s)                             \
                : launch<KV, DIM, false>(q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, \
                                         scale, act_dtype, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 64: REPRO_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (B*Hkv, group, D) f32/bf16; caches k/v (B*Hkv, S, D) of kv_dtype; scale
// rows ks/vs (B*Hkv, S) f32 for codes (else unused); lens (B,) i32, the
// tokens to attend (columns >= min(len, S) are masked); bk the KV tile width
// (<= kMaxTile); out (B*Hkv, group, D) in q's dtype. Returns the cudaError_t
// of the launch.
extern "C" int contiguous_decode(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, const int* lens, void* out, int B, int Hkv,
                                 int group, int D, int S, int bk, float scale, int expmul,
                                 int act_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || group <= 0 || group > 32 || S <= 0 || bk <= 0 || bk > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, scale,
                           act_dtype, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S,
                                   bk, scale, act_dtype, s);
    case kI8:
      return by_dim<int8_t>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk,
                            scale, act_dtype, s);
    case kFP8:
      return by_dim<__nv_fp8_e4m3>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S,
                                   bk, scale, act_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
