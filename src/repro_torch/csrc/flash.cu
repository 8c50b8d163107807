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
// 67 MB. Both products run on the float32 CUDA cores as fmaf chains in the
// plain version's order (kernels/flash/tile.py:fma_chain: the scores in
// depth order, the values in column order), since an ExpMul weight is a
// rounded function of its score and the checks hold the kernel within 1e-5
// of the plain version (kernels/checks.py:kernel_tol); tensor-core products
// sum in another order.
//
// Design: the register-tiled CUDA-core layout of the prefill kernels
// (tile_sm90.cuh). One CTA of 128 threads per (batch x query head, 32 query
// rows), two CTAs an SM where the shared memory allows (head dims up to 64;
// one from 96); causal row blocks launch heaviest first (the last block of
// the sequence first), so the wave tail holds the light ones. q is staged
// once as float32 rows. The CTA walks the reference's KV tiles, bk columns
// each from column 0 of the padded K (the ExpMul results depend on the
// width, so bk is the caller's block_k, at most kMaxTile), with
// chunk_tile_step, the contiguous prefill's tile step: K then V staged in
// 64-row sub-tiles (the next sub-tile's 16-byte loads in flight in
// registers while the current one is computed on, converted to float32 in
// shared memory; at D 256 loaded and converted when the step begins, as the
// prefills do: a thread's value accumulators take 128 registers there),
// the scores in 4 x 4 (rows, columns) register blocks into
// the tile's transposed scores, then the row max, the weights, their sum
// and the rescale once per tile (four threads a row), then the values from
// a fresh chain per tile in RPT x 4 (rows, features) register blocks
// (RPT = D / 16), folded into (m, l, acc) in registers. A tile reads only
// its columns below kv_len and, when causal, at or below the block's last
// row: every later column is masked for every row of the block. Tiles
// wholly below the window of the block's first row are skipped, which is
// exact: such a tile leaves (m, l, acc) as they were. Masks, per row:
// col < kv_len, and col <= row when causal, and row - col < window, where
// row is the query's global row: its index in q plus q_offset (a call on
// rows q_offset.. of a sequence, as a rank of a query-split call holds
// them; the keys are the whole sequence's). The reference's query blocks
// are min(128, Sq) rows; the row blocking changes only which wholly masked
// tiles are skipped.
//
// Head dims 16, 32, 64, 96, 112, 128 and 256. At 96 (minicpm3-4b's qk
// width, V zero-padded to it by the caller) and 112 (kimi-k2-1t-a32b) the
// 24 or 28 float4 feature groups do not share out over 128 threads: the
// staged rows are 128 floats wide, the padding zeroed once
// (tile_sm90.cuh:value_width, zero_value_pad), the value side runs D 128's
// layout and stores the first D features. The scores still walk all D
// features (score_block steps by 4, which divides every D built), and each
// stored output feature keeps its own fmaf chain over the columns.
#include "tile_sm90.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;  // query rows per CTA
constexpr int kSub = kStageRows;   // KV rows staged at once
constexpr int kPad = kStagePad;    // floats of padding on staged rows
constexpr int kPLd = kScoreLd;     // row stride of the transposed scores

template <int D>
constexpr size_t smem_bytes(int bk) {
  constexpr int DS = staged_width(D, D);  // the staged rows' width (128 at 96, 112)
  return sizeof(float) * (kRows * (D + kPad) + static_cast<size_t>(bk) * kPLd +
                          kSub * (DS + kPad) + kSub + 2 * kRows);
}

template <typename T, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int Hkv, int Sq, int Sk, int bk, int kv_len,
             int q_offset, int causal, int window, float scale, int vec16) {
  constexpr int kAct = sizeof(T) == sizeof(float) ? kF32 : kBF16;
  constexpr int DS = staged_width(D, D);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kRows][D + kPad]
  float* p_s = q_s + kRows * (D + kPad);  // [bk][kPLd]: scores, then weights
  float* x_s = p_s + bk * kPLd;           // [kSub][DS + kPad]: staged K or V
  float* sc_s = x_s + kSub * (DS + kPad);  // [kSub]: written by Stage, unused (no codes)
  float* r_s = sc_s + kSub;               // [kRows]: each row's rescale
  float* l_s = r_s + kRows;               // [kRows]: each row's l

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = qb * kRows;
  const int rows = min(kRows, Sq - r0);
  const int g0 = q_offset + r0;  // the block's first global row
  // the last column any row of the block may read; tiles [t_lo, t_hi)
  const int col_end = causal ? min(kv_len, g0 + rows) : kv_len;
  const int t_lo = window > 0 && g0 > window ? (g0 - window) / bk : 0;
  const int t_hi = (col_end + bk - 1) / bk;
  const int steps_full = 2 * ((bk + kSub - 1) / kSub);  // staging steps of a whole tile
  const int64_t kv0 = static_cast<int64_t>(kvh) * Sk;

  // staging step i: the K sub-tiles of tile t_lo + i / steps_full, then its
  // V sub-tiles (only the last tile can be narrower than bk)
  const auto step_at = [&](int i, const T*& src, int& nrows) {
    const int t = t_lo + i / steps_full;
    if (t >= t_hi) return false;
    const int nr = min(bk, col_end - t * bk);
    const int ns = (nr + kSub - 1) / kSub;
    const int w = i % steps_full;
    if (w >= 2 * ns) return false;
    const bool is_v = w >= ns;
    const int sub = is_v ? w - ns : w;
    src = (is_v ? v : k) + (kv0 + t * bk + sub * kSub) * D;
    nrows = min(kSub, nr - sub * kSub);
    return true;
  };

  using St = Stage<T, D>;
  St stage;
  int step = 0;
  // staging step i: in flight in registers, or (St::kSync) straight into x_s
  const auto stage_step = [&](int i) {
    const T* src;
    int nrows;
    if (!step_at(i, src, nrows)) return;
    if constexpr (St::kSync) {
      stage.load(x_s, sc_s, src, nullptr, nrows, vec16);
    } else {
      stage.fetch(src, nullptr, nrows, vec16);
    }
  };
  if constexpr (!St::kSync) stage_step(0);
  // the current step's rows into x_s (the next step's in flight)
  const auto advance = [&]() {
    __syncthreads();  // the previous step's readers of x_s are done
    if constexpr (St::kSync) {
      stage_step(step++);
      __syncthreads();
    } else {
      stage.commit(x_s, sc_s);
      __syncthreads();
      stage_step(++step);
    }
  };

  // q as float32 rows (zeros past Sq) and the staged rows' zero padding;
  // the first advance() publishes them
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * (D + kPad) + d] =
        r < rows ? to_f32(q[(static_cast<int64_t>(bh) * Sq + r0 + r) * D + d]) : 0.0f;
  }
  zero_value_pad<D, D>(x_s);

  ChunkRows<D> st;
  const bool dense = !causal && window <= 0;  // every column read is valid
  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * bk;
    chunk_tile_step<D, EXPMUL, false>(
        st, q_s, p_s, x_s, sc_s, nullptr, r_s, nullptr, min(bk, col_end - c0), scale, dense,
        advance, [&](int r, int j) {
          const int row = g0 + r, col = c0 + j;
          return (!causal || col <= row) && (window <= 0 || row - col < window);
        });
  }
  st.store(out, (static_cast<int64_t>(bh) * Sq + r0) * D, l_s, rows, kAct);
}

template <typename T, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int H, int Hkv,
           int Sq, int Sk, int bk, int kv_len, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, EXPMUL>;
  const int smem = static_cast<int>(smem_bytes<D>(bk));
  static int granted = 48 * 1024;  // per instantiation
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, bk, kv_len, q_offset, causal, window, scale,
      (any & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, void* out, int BH,
           int H, int Hkv, int Sq, int Sk, int bk, int kv_len, int q_offset, int causal,
           int window, float scale, cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                  \
  return expmul ? launch<T, DIM, true>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,      \
                                       q_offset, causal, window, scale, s)                \
                : launch<T, DIM, false>(q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,     \
                                        q_offset, causal, window, scale, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 96: REPRO_LAUNCH(96);
    case 112: REPRO_LAUNCH(112);
    case 128: REPRO_LAUNCH(128);
    case 256: REPRO_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

}  // namespace

// q (BH = B*H, Sq, D), k and v (B*Hkv, Sk, D), out (BH, Sq, D), all of
// `dtype` (kF32 or kBF16) and contiguous; bk the KV tile width (<= kMaxTile);
// kv_len <= Sk the valid keys; q_offset >= 0 the global row of q's first
// row (the causal and window masks' row); window <= 0: none. Returns the
// cudaError_t of the launch.
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out, int BH,
                             int H, int Hkv, int Sq, int Sk, int D, int bk, int kv_len,
                             int q_offset, int causal, int window, float scale, int expmul,
                             int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 || bk <= 0 ||
      bk > kMaxTile || kv_len < 0 || kv_len > Sk || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len, q_offset,
                           causal, window, scale, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, out, BH, H, Hkv, Sq, Sk, bk, kv_len,
                                   q_offset, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that flash_forward gives each CTA at
// head dim D and tile width bk (independent of the sequence lengths); -1
// for an unsupported D.
extern "C" long long flash_smem(int D, int bk) {
  switch (D) {
    case 16: return static_cast<long long>(smem_bytes<16>(bk));
    case 32: return static_cast<long long>(smem_bytes<32>(bk));
    case 64: return static_cast<long long>(smem_bytes<64>(bk));
    case 96: return static_cast<long long>(smem_bytes<96>(bk));
    case 112: return static_cast<long long>(smem_bytes<112>(bk));
    case 128: return static_cast<long long>(smem_bytes<128>(bk));
    case 256: return static_cast<long long>(smem_bytes<256>(bk));
    default: return -1;
  }
}
