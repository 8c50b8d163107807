// Paged flash-decode: one query token per sequence against the paged KV pool.
//
// Replaces the Pallas TPU kernel kernels/decode/decode.py:285
// (paged_decode_fwd_pallas, body _paged_decode_kernel at :162).
//
// What bounds it on the card: the bytes it must read, i.e. the pool codes
// (or values) and scale rows of every resident token, plus the block tables;
// the arithmetic is ~4 * group * D operations per token and byte, far below
// the H100's ~295 operations per byte. A lone decode step of qwen2-0.5b at
// 8 sequences x 1k context reads ~2 MB per layer, well under a microsecond
// at 3.35 TB/s, so in practice latency (the chain of page loads of one
// sequence) bounds this simple version.
//
// Design: one CTA per (sequence, KV head), holding the GQA group of query
// rows (one warp per row, the state in registers). The page walk of the
// TPU's sequential grid axis is a loop inside the CTA over pages 0, 1, ...
// of the block table, stopping at the sequence length (or the table's
// width), so entries past the length are never read. A sentinel entry
// within the length is clamped to the last pool block, as the Pallas kernel
// does: the engine's idle decode slots carry length 1 over an all-sentinel
// table, so they read that block, and their output is discarded. Each step
// stages up to kStageRows pool rows (several pages) in shared memory as
// float32 with one barrier pair, so the latency of a load is paid once per
// stage, not once per page; the tiles are then applied page by page, in
// order, as tile.py requires for the ExpMul results. Split-KV across CTAs (more CTAs than 2 x batch) is left
// for a later change: merging partial ExpMul states is not the reference's
// sequential walk.
#include "tile.cuh"

using namespace repro;

namespace {

constexpr int kStageRows = 64;

template <typename KV, int D, bool EXPMUL>
__global__ void paged_decode_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                                    const KV* __restrict__ vpool,
                                    const float* __restrict__ kspool,
                                    const float* __restrict__ vspool,
                                    const int* __restrict__ bt, const int* __restrict__ lens,
                                    void* __restrict__ out, int Hkv, int group, int nblk,
                                    int ps, int MB, int window, float scale, int act_dtype) {
  constexpr bool QUANT = IsCode<KV>::value;
  extern __shared__ float smem[];
  float* q_s = smem;                            // [group][D]
  float* k_s = q_s + group * D;                 // [kStageRows][D + 1]
  float* v_s = k_s + kStageRows * (D + 1);      // [kStageRows][D]
  float* ks_s = v_s + kStageRows * D;           // [kStageRows]
  float* vs_s = ks_s + kStageRows;              // [kStageRows]

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int length = lens[b];

  for (int i = threadIdx.x; i < group * D; i += blockDim.x)
    q_s[i] = load_act(q, static_cast<int64_t>(bh) * group * D + i, act_dtype);

  RowState<D> st;
  st.init();
  // stop at the length (and at the table's width, as the Pallas grid does)
  const int n_pages = min((length + ps - 1) / ps, MB);
  const int pages_per_stage = kStageRows / ps;
  for (int p0 = 0; p0 < n_pages; p0 += pages_per_stage) {
    const int np = min(pages_per_stage, n_pages - p0);
    __syncthreads();  // the previous stage is consumed (and q_s is written)
    for (int i = threadIdx.x; i < np * ps * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const int page = p0 + r / ps;
      const int blk = min(bt[b * MB + page], nblk - 1);
      const int64_t src = (static_cast<int64_t>(blk * ps + r % ps) * Hkv + h) * D + d;
      k_s[r * (D + 1) + d] = to_f32(kpool[src]);
      v_s[r * D + d] = to_f32(vpool[src]);
    }
    if (QUANT) {
      for (int r = threadIdx.x; r < np * ps; r += blockDim.x) {
        const int blk = min(bt[b * MB + p0 + r / ps], nblk - 1);
        const int64_t src = static_cast<int64_t>(blk * ps + r % ps) * Hkv + h;
        ks_s[r] = kspool[src];
        vs_s[r] = vspool[src];
      }
    }
    __syncthreads();
    if (warp < group) {
      for (int pi = 0; pi < np; ++pi) {
        const int c0 = (p0 + pi) * ps;
        // pages wholly below the window floor contribute nothing
        if (window > 0 && c0 + ps <= length - window) continue;
        const int col = c0 + lane;
        const bool valid = lane < ps && col < length && (window <= 0 || col >= length - window);
        row_tile_step<D, EXPMUL, QUANT>(st, q_s + warp * D, k_s + pi * ps * (D + 1),
                                        v_s + pi * ps * D, ks_s + pi * ps, vs_s + pi * ps,
                                        ps, valid, scale, lane);
      }
    }
  }
  if (warp < group)
    st.finalize(out, (static_cast<int64_t>(bh) * group + warp) * D, act_dtype, lane);
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* bt, const int* lens, void* out, int B, int Hkv, int group, int nblk,
           int ps, int MB, int window, float scale, int act_dtype, cudaStream_t stream) {
  const int warps = group < 4 ? 4 : group;
  const size_t smem =
      sizeof(float) * (group * D + kStageRows * (2 * D + 1) + 2 * kStageRows);
  auto kernel = paged_decode_kernel<KV, D, EXPMUL>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<B * Hkv, warps * kWarp, smem, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, bt, lens, out, Hkv,
      group, nblk, ps, MB, window, scale, act_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* bt, const int* lens, void* out, int B, int Hkv,
           int group, int nblk, int ps, int MB, int window, float scale, int act_dtype,
           cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                  \
  return expmul ? launch<KV, DIM, true>(q, k, v, ks, vs, bt, lens, out, B, Hkv, group,    \
                                        nblk, ps, MB, window, scale, act_dtype, s)        \
                : launch<KV, DIM, false>(q, k, v, ks, vs, bt, lens, out, B, Hkv, group,   \
                                         nblk, ps, MB, window, scale, act_dtype, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 64: REPRO_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (B*Hkv, group, D) f32/bf16; pools (nblk, ps, Hkv, D) of kv_dtype; scale
// pools (nblk, ps, Hkv) f32 for codes (else unused); bt (B, MB) i32;
// lens (B,) i32; out (B*Hkv, group, D) in q's dtype. window <= 0: none.
// Returns the cudaError_t of the launch.
extern "C" int paged_decode(const void* q, const void* k, const void* v, const float* ks,
                            const float* vs, const int* bt, const int* lens, void* out, int B,
                            int Hkv, int group, int D, int nblk, int ps, int MB, int window,
                            float scale, int expmul, int act_dtype, int kv_dtype,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || group <= 0 || group > 32 || ps <= 0 || ps > kMaxPage)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, ks, vs, bt, lens, out, B, Hkv, group, nblk, ps,
                           MB, window, scale, act_dtype, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, ks, vs, bt, lens, out, B, Hkv, group,
                                   nblk, ps, MB, window, scale, act_dtype, s);
    case kI8:
      return by_dim<int8_t>(D, expmul, q, k, v, ks, vs, bt, lens, out, B, Hkv, group, nblk,
                            ps, MB, window, scale, act_dtype, s);
    case kFP8:
      return by_dim<__nv_fp8_e4m3>(D, expmul, q, k, v, ks, vs, bt, lens, out, B, Hkv, group,
                                   nblk, ps, MB, window, scale, act_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
