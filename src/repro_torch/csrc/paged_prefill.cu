// Paged chunked prefill: a chunk of C fresh queries per sequence against
// [paged history ++ the chunk's own KV], with no concatenated copy.
//
// Replaces the Pallas TPU kernel kernels/flash/prefill.py:433
// (paged_prefill_fwd_pallas, body _paged_prefill_kernel at :263).
//
// What bounds it on the card: operations. Each chunk query scores every
// resident and earlier chunk key, ~4 * D operations per (query, key) pair:
// at qwen2-0.5b's serving shapes (8 sequences x 256-token chunks over 1k
// tokens of history, 14 heads of 64) that is ~8.5 GFLOP per layer against
// ~10 MB of bytes, ~850 operations per byte, above the card's ridge. This
// simple version runs the products on the float32 CUDA cores, not the
// tensor cores (wgmma), so it sits far from that bound.
//
// Design: one CTA per (sequence, query head, block of kQBlock chunk rows);
// eight warps, each owning kRowsPerWarp query rows with their (m, l, acc)
// in registers and q in shared memory. The CTA walks the KV tiles in the
// reference order: history pages 0, 1, ... of the block table up to the
// sequence length (so sentinel entries are never read), then chunk tiles
// [0, ps), [ps, 2ps), ... counted from the chunk start, up to n_valid and
// to the block's last row (later tiles are fully masked for every row of
// the block). Each tile is staged in shared memory as float32 and applied
// to every row of the block with the shared tile step (tile.cuh); masks are
// per row: history columns < length (and within the window), chunk columns
// < n_valid and <= the row.
#include "tile.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kQBlock = kWarps * kRowsPerWarp;

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kWarps * kWarp)
paged_prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                     const KV* __restrict__ vpool, const float* __restrict__ kspool,
                     const float* __restrict__ vspool, const KV* __restrict__ kn,
                     const KV* __restrict__ vn, const float* __restrict__ ksn,
                     const float* __restrict__ vsn, const int* __restrict__ bt,
                     const int* __restrict__ lens, const int* __restrict__ nvalid,
                     void* __restrict__ out, int H, int Hkv, int C, int nblk, int ps, int MB,
                     int window, float scale, int act_dtype) {
  constexpr bool QUANT = IsCode<KV>::value;
  __shared__ float q_s[kQBlock * D];
  __shared__ float k_s[kMaxPage * (D + 1)];
  __shared__ float v_s[kMaxPage * D];
  __shared__ float ks_s[kMaxPage];
  __shared__ float vs_s[kMaxPage];

  const int bh = blockIdx.x;
  const int b = bh / H, h = (bh % H) / (H / Hkv);
  const int r0 = blockIdx.y * kQBlock;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int length = lens[b], n_valid = nvalid[b];

  for (int i = threadIdx.x; i < kQBlock * D; i += blockDim.x) {
    const int r = r0 + i / D;
    q_s[i] = r < C ? load_act(q, (static_cast<int64_t>(bh) * C + r0) * D + i, act_dtype)
                   : 0.0f;
  }

  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  // stop at the length (and at the table's width, as the Pallas grid does)
  const int n_hist = min((length + ps - 1) / ps, MB);
  const int chunk_end = min(n_valid, r0 + kQBlock);
  const int n_tiles = n_hist + (chunk_end + ps - 1) / ps;
  const int64_t chunk_base = static_cast<int64_t>(b * Hkv + h) * C;
  for (int t = 0; t < n_tiles; ++t) {
    const bool hist = t < n_hist;
    const int c0 = (hist ? t : t - n_hist) * ps;
    // tiles wholly below the window floor of the block's lowest row
    if (window > 0 && c0 + ps <= (hist ? length : 0) + r0 - window) continue;
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    if (hist) {
      const int blk = min(bt[b * MB + t], nblk - 1);
      const int64_t row0 = static_cast<int64_t>(blk) * ps;
      for (int i = threadIdx.x; i < ps * D; i += blockDim.x) {
        const int r = i / D, d = i - r * D;
        const int64_t src = ((row0 + r) * Hkv + h) * D + d;
        k_s[r * (D + 1) + d] = to_f32(kpool[src]);
        v_s[r * D + d] = to_f32(vpool[src]);
      }
      if (QUANT && threadIdx.x < ps) {
        ks_s[threadIdx.x] = kspool[(row0 + threadIdx.x) * Hkv + h];
        vs_s[threadIdx.x] = vspool[(row0 + threadIdx.x) * Hkv + h];
      }
    } else {
      for (int i = threadIdx.x; i < ps * D; i += blockDim.x) {
        const int r = i / D, d = i - r * D;
        const bool in = c0 + r < C;
        const int64_t src = (chunk_base + c0 + r) * D + d;
        k_s[r * (D + 1) + d] = in ? to_f32(kn[src]) : 0.0f;
        v_s[r * D + d] = in ? to_f32(vn[src]) : 0.0f;
      }
      if (QUANT && threadIdx.x < ps) {
        const bool in = c0 + threadIdx.x < C;
        ks_s[threadIdx.x] = in ? ksn[chunk_base + c0 + threadIdx.x] : 0.0f;
        vs_s[threadIdx.x] = in ? vsn[chunk_base + c0 + threadIdx.x] : 0.0f;
      }
    }
    __syncthreads();
    const int col = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp * kRowsPerWarp + i;
      const int r = r0 + rl;
      if (r >= C) continue;  // warp-uniform
      bool valid;
      if (hist) {
        valid = lane < ps && col < length && (window <= 0 || length + r - col < window);
      } else {
        valid = lane < ps && col < n_valid && r >= col && (window <= 0 || r - col < window);
      }
      row_tile_step<D, EXPMUL, QUANT>(st[i], q_s + rl * D, k_s, v_s, ks_s, vs_s, ps, valid,
                                      scale, lane);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    if (r < C) st[i].finalize(out, (static_cast<int64_t>(bh) * C + r) * D, act_dtype, lane);
  }
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* bt,
           const int* lens, const int* nvalid, void* out, int B, int H, int Hkv, int C,
           int nblk, int ps, int MB, int window, float scale, int act_dtype,
           cudaStream_t stream) {
  const dim3 grid(B * H, (C + kQBlock - 1) / kQBlock);
  paged_prefill_kernel<KV, D, EXPMUL><<<grid, kWarps * kWarp, 0, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      static_cast<const KV*>(kn), static_cast<const KV*>(vn), ksn, vsn, bt, lens, nvalid, out,
      H, Hkv, C, nblk, ps, MB, window, scale, act_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const void* kn, const void* vn, const float* ksn, const float* vsn,
           const int* bt, const int* lens, const int* nvalid, void* out, int B, int H, int Hkv,
           int C, int nblk, int ps, int MB, int window, float scale, int act_dtype,
           cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                    \
  return expmul ? launch<KV, DIM, true>(q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens, nvalid, \
                                        out, B, H, Hkv, C, nblk, ps, MB, window, scale,     \
                                        act_dtype, s)                                       \
                : launch<KV, DIM, false>(q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens,       \
                                         nvalid, out, B, H, Hkv, C, nblk, ps, MB, window,   \
                                         scale, act_dtype, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 64: REPRO_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (B*H, C, D) f32/bf16; pools (nblk, ps, Hkv, D) of kv_dtype and their
// scale pools (nblk, ps, Hkv) f32 for codes; chunk kn/vn (B*Hkv, C, D) of
// kv_dtype and ksn/vsn (B*Hkv, C) f32 for codes; bt (B, MB) i32;
// lens / nvalid (B,) i32; out (B*H, C, D) in q's dtype. window <= 0: none.
// Returns the cudaError_t of the launch.
extern "C" int paged_prefill(const void* q, const void* k, const void* v, const float* ks,
                             const float* vs, const void* kn, const void* vn, const float* ksn,
                             const float* vsn, const int* bt, const int* lens,
                             const int* nvalid, void* out, int B, int H, int Hkv, int C, int D,
                             int nblk, int ps, int MB, int window, float scale, int expmul,
                             int act_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0 || ps <= 0 || ps > kMaxPage)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens, nvalid, out,
                           B, H, Hkv, C, nblk, ps, MB, window, scale, act_dtype, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens,
                                   nvalid, out, B, H, Hkv, C, nblk, ps, MB, window, scale,
                                   act_dtype, s);
    case kI8:
      return by_dim<int8_t>(D, expmul, q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens, nvalid,
                            out, B, H, Hkv, C, nblk, ps, MB, window, scale, act_dtype, s);
    case kFP8:
      return by_dim<__nv_fp8_e4m3>(D, expmul, q, k, v, ks, vs, kn, vn, ksn, vsn, bt, lens,
                                   nvalid, out, B, H, Hkv, C, nblk, ps, MB, window, scale,
                                   act_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
