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
// ~10 MB of bytes, ~850 operations per byte, above the card's ridge.
//
// The exactness rule is csrc/prefill.cu's: both products are fmaf chains in
// the plain version's order (kernels/flash/tile.py:fma_chain), the scores in
// depth order, the values in column order, on the CUDA cores.
//
// Design: csrc/prefill.cu's CUDA-core layout (tile_sm90.cuh): one CTA of
// 128 threads per (sequence, query head, 32 chunk rows). It walks the
// reference's KV tiles, one page wide (the ExpMul results depend on the
// width): history pages 0, 1, ... of the block table, stopping at the
// sequence length and at the table's width (so sentinel entries past the
// length are never read; one within it is clamped to the last pool block,
// as the Pallas kernel does), then chunk tiles [0, ps), [ps, 2ps), ...
// counted from the chunk start, below n_valid and the block's last row
// (later tiles are wholly masked for every row of the block); tiles wholly
// below the window of the block's lowest row are skipped. Pages are staged
// several at once, G = min(16, 64 / ps) of them (64 rows at ps = 16), each
// resolved through the block table (a page's rows for KV head h lie
// Hkv * D elements apart in the (nblk, ps, Hkv, D) pool), only the rows
// below the length or the chunk's end: K for the scores, then V for the
// values, the next step's 16-byte loads in flight in registers while the
// current one is computed on. The group's scores are taken together
// (columns are independent: each thread a 4 x 4 block of (rows, columns));
// then page by page, in order, four threads a row take the page's row max,
// its weights, their sum and the rescale of (m, l); after V lands, each
// page's value product is a fresh fmaf chain over its columns (each thread a
// 4 x 4 block of (rows, features)) folded into acc, all in registers.
// Masks, per row:
//   history:  col < length (the columns read), and length + row - col < window
//   chunk:    col < n_valid (the columns read), col <= row, row - col < window
// The query block (32 rows, not the reference's min(128, C)) changes only
// which wholly masked tiles are skipped.
#include "tile_sm90.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;
constexpr int kSub = kStageRows;
constexpr int kPad = kStagePad;
constexpr int kPLd = kScoreLd;
constexpr int kMaxGroupPages = 16;  // pages staged at once

// pages staged at once at page size ps (<= kMaxPage)
__host__ __device__ constexpr int group_pages(int ps) {
  return kSub / ps < kMaxGroupPages ? kSub / ps : kMaxGroupPages;
}

template <int D>
struct Smem {
  float q[kRows * (D + kPad)];         // the CTA's query rows
  float p[kSub * kPLd];                // the group's scores, then weights
  float x[kSub * (D + kPad)];          // the staged K or V rows
  float sc[kSub];                      // their scale rows
  float vt[kSub];                      // the group's v scales
  float r[kMaxGroupPages * kRows];     // each page's rescale of each row
  float l[kRows];
};

// One staging group of the walk: its first page (history) or tile (chunk),
// its page count, its first column and the rows read.
struct Group {
  bool hist;
  int p0, np, col0, nrows;
};

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 3)
paged_prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                     const KV* __restrict__ vpool, const float* __restrict__ kspool,
                     const float* __restrict__ vspool, const KV* __restrict__ kn,
                     const KV* __restrict__ vn, const float* __restrict__ ksn,
                     const float* __restrict__ vsn, const int* __restrict__ bt,
                     const int* __restrict__ lens, const int* __restrict__ nvalid,
                     void* __restrict__ out, int H, int Hkv, int C, int nblk, int ps, int MB,
                     int window, float scale, int act_dtype, int vec16) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  constexpr int DG = D / 4;                      // 4-feature groups
  constexpr int RPT = kRows * DG / kThreads;     // value rows a thread (4 or 1)
  static_assert(RPT == 4 || RPT == 1, "head dims 16 and 64");
  static_assert(kRows * 4 == kThreads, "four weight threads a row");
  __shared__ __align__(16) Smem<D> sm;

  const int bh = blockIdx.x;
  const int b = bh / H, h = (bh % H) / (H / Hkv);
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - r0);
  const int tid = threadIdx.x;
  const int length = lens[b];
  const int n_valid = min(nvalid[b], C);
  const int64_t chunk0 = static_cast<int64_t>(b * Hkv + h) * C;
  const int* bt_row = bt + static_cast<int64_t>(b) * MB;
  const int G = group_pages(ps);
  // history pages [h_lo, n_hist), chunk tiles [c_lo, n_ct); the tiles below
  // h_lo and c_lo are wholly below the window of the block's lowest row
  const int n_hist = min((length + ps - 1) / ps, MB);
  const int chunk_end = min(n_valid, r0 + kRows);
  const int n_ct = chunk_end > 0 ? (chunk_end + ps - 1) / ps : 0;
  const int h_lo = window > 0 ? min(n_hist, max(0, length + r0 - window) / ps) : 0;
  const int c_lo = window > 0 ? min(n_ct, max(0, r0 - window) / ps) : 0;
  const int n_hg = (n_hist - h_lo + G - 1) / G;
  const int n_groups = n_hg + (n_ct - c_lo + G - 1) / G;

  const auto group_at = [&](int g, Group& t) {
    t.hist = g < n_hg;
    t.p0 = t.hist ? h_lo + g * G : c_lo + (g - n_hg) * G;
    t.np = min(G, (t.hist ? n_hist : n_ct) - t.p0);
    t.col0 = t.p0 * ps;
    t.nrows = min(t.np * ps, (t.hist ? length : chunk_end) - t.col0);
  };
  // pool row of row r of a history group
  const auto pool_row = [&](const Group& t, int r) {
    const int pp = r / ps;
    const int blk = min(__ldg(bt_row + t.p0 + pp), nblk - 1);
    return (static_cast<int64_t>(blk) * ps + (r - pp * ps)) * Hkv + h;
  };

  // staging step i: the K rows of group i / 2, or its V rows for odd i
  Stage<KV, D> stage;
  const auto fetch_step = [&](int i) {
    Group t;
    if (i / 2 >= n_groups) return;
    group_at(i / 2, t);
    const bool is_v = i % 2;
    if (t.hist) {
      const unsigned char* pool = reinterpret_cast<const unsigned char*>(is_v ? vpool : kpool);
      const float* spool = is_v ? vspool : kspool;
      stage.fetch_at([&](int r) { return pool + pool_row(t, r) * kRowBytes; },
                     [&](int r) { return spool + pool_row(t, r); }, t.nrows, vec16);
    } else {
      const int64_t r = chunk0 + t.col0;
      stage.fetch((is_v ? vn : kn) + r * D, QUANT ? (is_v ? vsn : ksn) + r : nullptr, t.nrows,
                  vec16);
    }
  };
  int step = 0;
  fetch_step(0);
  // the staged rows of the current step into sm.x, the next step's in flight
  const auto advance = [&]() {
    __syncthreads();  // the previous step's readers of sm.x are done
    stage.commit(sm.x, sm.sc);
    __syncthreads();
    fetch_step(++step);
  };

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sm.q[r * (D + kPad) + d] =
        r < rows ? load_act(q, (static_cast<int64_t>(bh) * C + r0 + r) * D + d, act_dtype)
                 : 0.0f;
  }

  // the running state: (m, l) of row tid / 4 in its four weight threads;
  // acc of RPT rows x 4 features in each thread
  const int wrow = tid / 4, wpart = tid % 4;
  const int row = r0 + wrow;
  float m_run = kMaskValue, l_run = 0.0f;
  const int vrg = tid / DG, vdg = tid % DG;
  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;

  for (int g = 0; g < n_groups; ++g) {
    Group t;
    group_at(g, t);
    advance();  // the group's K rows (its first barrier also publishes q)
    score_block<D, QUANT>(sm.q, sm.x, sm.sc, sm.p, t.nrows, scale);
    if constexpr (QUANT) {
      for (int j = tid; j < t.nrows; j += kThreads)
        sm.vt[j] = t.hist ? vspool[pool_row(t, j)] : vsn[chunk0 + t.col0 + j];
    }
    __syncthreads();
    // page by page, in order: the row max, the weights, their sum, the
    // rescale of (m, l)
    const bool dense = t.hist && window <= 0;  // every history column read is valid
    for (int pp = 0; pp < t.np; ++pp) {
      const int j0 = pp * ps, nc = min(ps, t.nrows - j0);
      const int c0 = t.col0 + j0;
      const auto valid = [&](int j) {
        const int col = c0 + j;
        if (t.hist) return dense || length + row - col < window;
        return col <= row && (window <= 0 || row - col < window);
      };
      float mx = kMaskValue;
      for (int j = wpart; j < nc; j += 4)
        if (valid(j)) mx = fmaxf(mx, sm.p[(j0 + j) * kPLd + wrow]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float ps_sum = 0.0f;
      for (int j = wpart; j < nc; j += 4) {
        float* pj = sm.p + (j0 + j) * kPLd + wrow;
        const float p = valid(j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
        ps_sum += p;
        *pj = QUANT ? p * sm.vt[j0 + j] : p;  // the weight the value product takes
      }
      ps_sum += __shfl_xor_sync(kFull, ps_sum, 1);
      ps_sum += __shfl_xor_sync(kFull, ps_sum, 2);
      const float r = rescale_factor<EXPMUL>(m_run, m_new);
      l_run = rescale<EXPMUL>(l_run, r) + ps_sum;
      m_run = m_new;
      if (wpart == 0) sm.r[pp * kRows + wrow] = r;
    }
    advance();  // the group's V rows (the barrier publishes the weights)
    // page by page, in order: a fresh value product, folded into acc
    for (int pp = 0; pp < t.np; ++pp) {
      const int j0 = pp * ps, nc = min(ps, t.nrows - j0);
      float dsum[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[r][e] = 0.0f;
      value_block<D, RPT>(dsum, sm.p + j0 * kPLd + RPT * vrg,
                          sm.x + j0 * (D + kPad) + 4 * vdg, nc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float f = sm.r[pp * kRows + RPT * vrg + r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = rescale<EXPMUL>(acc[r][e], f) + dsum[r][e];
      }
    }
  }

  if (wpart == 0) sm.l[wrow] = l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int vrow = RPT * vrg + r;
    if (vrow >= rows) continue;
    const float l = sm.l[vrow];
    const float den = l == 0.0f ? 1.0f : l;
    const int64_t o = (static_cast<int64_t>(bh) * C + r0 + vrow) * D + 4 * vdg;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_act(out, o + e, acc[r][e] / den, act_dtype);
  }
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const void* kn, const void* vn, const float* ksn, const float* vsn, const int* bt,
           const int* lens, const int* nvalid, void* out, int B, int H, int Hkv, int C,
           int nblk, int ps, int MB, int window, float scale, int act_dtype,
           cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn);
  const dim3 grid(B * H, (C + kRows - 1) / kRows);
  paged_prefill_kernel<KV, D, EXPMUL><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      static_cast<const KV*>(kn), static_cast<const KV*>(vn), ksn, vsn, bt, lens, nvalid, out,
      H, Hkv, C, nblk, ps, MB, window, scale, act_dtype, (any & 15) == 0);
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
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0 || ps <= 0 || ps > kMaxPage || nblk <= 0 ||
      MB < 0)
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

// The shared memory, in bytes, that paged_prefill gives each CTA (static,
// independent of every length and of the page size); -1 for an unsupported D.
extern "C" long long paged_prefill_smem(int D) {
  switch (D) {
    case 16: return static_cast<long long>(sizeof(Smem<16>));
    case 64: return static_cast<long long>(sizeof(Smem<64>));
    default: return -1;
  }
}
