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
// ~5 MB of bytes, far above the card's ridge. This simple version runs the
// products on the float32 CUDA cores, not the tensor cores (wgmma), so it
// sits far from that bound.
//
// Design: one CTA per (sequence, query head, block of kQBlock chunk rows);
// eight warps, each owning kRowsPerWarp query rows with their (m, l, acc)
// in registers and q in shared memory. The CTA walks the reference's KV
// tiles, bk = min(512, max(S, C, 1)) columns each (the ExpMul results depend
// on the width), with the shared wide-tile step (tile.cuh): cache tiles
// [0, bk), [bk, 2bk), ... below min(length, S), then chunk tiles counted
// from the chunk start, below n_valid and the block's last row. A tile
// reads only the columns that can be valid for some row of the block, so
// neither the cache nor the chunk needs a padded copy, and stale rows past
// the length are never read. Masks, per row:
//   cache, rolling = 0:  col < length (and length + row - col < window)
//   cache, rolling = 1:  pos = last - ((last - col) mod S), last = length - 1,
//                        valid iff pos >= 0 (and length + row - pos < window);
//                        the mod is Python's (never negative), so columns
//                        past `last` get pos < 0 and stay masked
//   chunk:               col < n_valid, col <= row (and row - col < window)
// The query block is smaller than the reference's (32 rows, not
// min(128, C)); that changes only which wholly masked tiles are skipped.
#include "tile.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kQBlock = kWarps * kRowsPerWarp;

template <int D>
constexpr size_t smem_bytes(int bk) {
  return sizeof(float) * (kQBlock * D + kQBlock * bk + kSubRows * (D + 1) + kSubRows);
}

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kWarps * kWarp)
prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const KV* __restrict__ kn, const KV* __restrict__ vn,
               const float* __restrict__ ksn, const float* __restrict__ vsn,
               const int* __restrict__ lens, const int* __restrict__ nvalid,
               void* __restrict__ out, int H, int Hkv, int C, int S, int bk, int window,
               int rolling, float scale, int act_dtype) {
  constexpr bool QUANT = IsCode<KV>::value;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kQBlock][D]
  float* s_s = q_s + kQBlock * D;           // [kQBlock][bk]
  float* kv_s = s_s + kQBlock * bk;         // [kSubRows][D + 1]
  float* sc_s = kv_s + kSubRows * (D + 1);  // [kSubRows]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int r0 = blockIdx.y * kQBlock;
  const int rows = min(kQBlock, C - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int length = lens[b];
  const int n_valid = min(nvalid[b], C);

  for (int i = threadIdx.x; i < kQBlock * D; i += blockDim.x) {
    q_s[i] = i < rows * D ? load_act(q, (static_cast<int64_t>(bh) * C + r0) * D + i, act_dtype)
                          : 0.0f;
  }

  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  // -- the cache segment: tiles below min(length, S) ----------------------
  const int64_t cache0 = static_cast<int64_t>(kvh) * S;
  const int cache_end = min(length, S);
  const int last = length - 1;
  for (int c0 = 0; c0 < cache_end; c0 += bk) {
    // fresh caches: whole tiles below the window floor of the block's lowest row
    if (!rolling && window > 0 && c0 + bk <= length + r0 - window) continue;
    const auto valid = [=](int r, int j) {
      const int col = c0 + j;
      int pos = col;  // fresh cache: col < length holds for the columns read
      if (rolling) {
        pos = last - py_mod(last - col, S);
        if (pos < 0) return false;
      }
      return window <= 0 || length + r0 + r - pos < window;
    };
    const int64_t r = cache0 + c0;
    wide_tile_step<D, kRowsPerWarp, EXPMUL, QUANT>(
        st, q_s, s_s, bk, kv_s, sc_s, kc + r * D, vc + r * D, QUANT ? ksc + r : nullptr,
        QUANT ? vsc + r : nullptr, min(bk, cache_end - c0), rows, scale, valid);
  }

  // -- the chunk segment: tiles from the chunk start, below n_valid and the
  // block's last row ------------------------------------------------------
  const int64_t chunk0 = static_cast<int64_t>(kvh) * C;
  const int chunk_end = min(n_valid, r0 + kQBlock);
  for (int j0 = 0; j0 < chunk_end; j0 += bk) {
    if (window > 0 && j0 + bk <= r0 - window) continue;
    const auto valid = [=](int r, int j) {
      const int row = r0 + r, col = j0 + j;
      return col <= row && (window <= 0 || row - col < window);
    };
    const int64_t r = chunk0 + j0;
    wide_tile_step<D, kRowsPerWarp, EXPMUL, QUANT>(
        st, q_s, s_s, bk, kv_s, sc_s, kn + r * D, vn + r * D, QUANT ? ksn + r : nullptr,
        QUANT ? vsn + r : nullptr, min(bk, chunk_end - j0), rows, scale, valid);
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < rows) st[i].finalize(out, (static_cast<int64_t>(bh) * C + r0 + r) * D, act_dtype, lane);
  }
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* kc, const void* vc, const float* ksc, const float* vsc,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* lens,
           const int* nvalid, void* out, int B, int H, int Hkv, int C, int S, int bk,
           int window, int rolling, float scale, int act_dtype, cudaStream_t stream) {
  auto kernel = prefill_kernel<KV, D, EXPMUL>;
  static bool wide_smem = false;  // once per instantiation: room for the widest tile
  if (!wide_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxTile)));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem = true;
  }
  const dim3 grid(B * H, (C + kQBlock - 1) / kQBlock);
  kernel<<<grid, kWarps * kWarp, smem_bytes<D>(bk), stream>>>(
      q, static_cast<const KV*>(kc), static_cast<const KV*>(vc), ksc, vsc,
      static_cast<const KV*>(kn), static_cast<const KV*>(vn), ksn, vsn, lens, nvalid, out, H,
      Hkv, C, S, bk, window, rolling, scale, act_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const void* kn, const void* vn, const float* ksn,
           const float* vsn, const int* lens, const int* nvalid, void* out, int B, int H,
           int Hkv, int C, int S, int bk, int window, int rolling, float scale, int act_dtype,
           cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                    \
  return expmul ? launch<KV, DIM, true>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens, nvalid, \
                                        out, B, H, Hkv, C, S, bk, window, rolling, scale,   \
                                        act_dtype, s)                                       \
                : launch<KV, DIM, false>(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lens,       \
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
                                  int Hkv, int C, int D, int S, int bk, int window, int rolling,
                                  float scale, int expmul, int act_dtype, int kv_dtype,
                                  void* stream) {
  if (B <= 0 || C <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bk <= 0 || bk > kMaxTile)
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
