// Full-sequence FlashAttention-2 forward, exact and ExpMul variants: every
// query row of a sequence against that sequence's keys, causal or not, with
// an optional local window, for GQA/MQA through the KV-head fold. This is
// the forward of the training path.
//
// Replaces the Pallas TPU kernel kernels/flash/flash.py:143
// (flash_fwd_pallas, body _fwd_kernel at :40).
//
// What bounds it on the card: operations. Each valid (query, key) pair
// costs ~4 * D operations against 2 * D * 4 bytes of q and o per query and
// the same per key: at qwen2-0.5b's training shapes (8 x 1024 tokens, 14
// heads over 2 KV heads of 64, causal, float32) that is ~15 GFLOP against
// 67 MB. This simple version runs both products on the float32 CUDA cores
// (no wgmma), so it sits far from that bound.
//
// Design: one CTA per (batch x query head, block of kQBlock query rows);
// eight warps, each owning kRowsPerWarp rows with their (m, l, acc) in
// registers and q in shared memory. The CTA walks the reference's KV tiles,
// bk columns each from column 0 of the padded K (the ExpMul results depend
// on the width, so bk is the caller's block_k, at most kMaxTile), with the
// shared wide-tile step of tile.cuh (one max and one rescale per tile).
// A tile reads only its columns below kv_len and, when causal, at or below
// the block's last row: every later column is masked for every row of the
// block. Tiles that are wholly masked for every row of the block (past the
// diagonal, or below the window of the block's first row) are skipped,
// which is exact: such a tile leaves (m, l, acc) as they were. Masks, per
// row: col < kv_len, and col <= row when causal, and row - col < window.
// The reference's query blocks are min(128, Sq) rows; the row blocking
// changes only which wholly masked tiles are skipped.
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

// Two CTAs share an SM (their shared memory allows no more), so each thread
// may take up to 128 registers.
template <typename T, int D, bool EXPMUL>
__global__ void __launch_bounds__(kWarps * kWarp, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int Hkv, int Sq, int Sk, int bk, int kv_len,
             int causal, int window, float scale) {
  constexpr int kAct = sizeof(T) == sizeof(float) ? kF32 : kBF16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kQBlock][D]
  float* s_s = q_s + kQBlock * D;           // [kQBlock][bk]
  float* kv_s = s_s + kQBlock * bk;         // [kSubRows][D + 1]
  float* sc_s = kv_s + kSubRows * (D + 1);  // [kSubRows], unused: no codes

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int r0 = blockIdx.y * kQBlock;
  const int rows = min(kQBlock, Sq - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  for (int i = threadIdx.x; i < kQBlock * D; i += blockDim.x) {
    q_s[i] = i < rows * D ? to_f32(q[(static_cast<int64_t>(bh) * Sq + r0) * D + i]) : 0.0f;
  }

  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  // the last column any row of the block may read
  const int col_end = causal ? min(kv_len, r0 + rows) : kv_len;
  const int64_t kv0 = static_cast<int64_t>(kvh) * Sk;
  for (int c0 = 0; c0 < col_end; c0 += bk) {
    if (window > 0 && c0 + bk <= r0 - window) continue;  // below every row's window
    const auto valid = [=](int r, int j) {
      const int row = r0 + r, col = c0 + j;
      return (!causal || col <= row) && (window <= 0 || row - col < window);
    };
    const int64_t kr = kv0 + c0;
    wide_tile_step<D, kRowsPerWarp, EXPMUL, false>(
        st, q_s, s_s, bk, kv_s, sc_s, k + kr * D, v + kr * D, nullptr, nullptr,
        min(bk, col_end - c0), rows, scale, valid);
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < rows)
      st[i].finalize(out, (static_cast<int64_t>(bh) * Sq + r0 + r) * D, kAct, lane);
  }
}

template <typename T, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int H, int Hkv,
           int Sq, int Sk, int bk, int kv_len, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, EXPMUL>;
  static bool wide_smem = false;  // once per instantiation: room for the widest tile
  if (!wide_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxTile)));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem = true;
  }
  const dim3 grid(BH, (Sq + kQBlock - 1) / kQBlock);
  kernel<<<grid, kWarps * kWarp, smem_bytes<D>(bk), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, bk, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, void* out, int BH,
           int H, int Hkv, int Sq, int Sk, int bk, int kv_len, int causal, int window,
           float scale, cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                  \
  return expmul ? launch<T, DIM, true>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,      \
                                       causal, window, scale, s)                          \
                : launch<T, DIM, false>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,     \
                                        causal, window, scale, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 128: REPRO_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (BH = B*H, Sq, D), k and v (B*Hkv, Sk, D), out (BH, Sq, D), all of
// `dtype` (kF32 or kBF16) and contiguous; bk the KV tile width (<= kMaxTile);
// kv_len <= Sk the valid keys; window <= 0: none. Returns the cudaError_t of
// the launch.
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
