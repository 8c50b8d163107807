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
// Hkv * D elements apart in the (nblk, ps, Hkv, D) pool); a page wider than
// 64 rows (up to 256) is a group of its own, staged in NS = ceil(ps / 64)
// sub-tiles of 64 rows, its scores kept whole in shared memory, so its row
// max, weights and rescale are still taken once for the page and its value
// product is one chain over its columns, carried from sub-tile to sub-tile
// (the p buffer is max(64, 64 NS) columns wide, sized at the launch): every row of a
// history page (past the length too, weighed 0 into the value product as
// the plain version does, so a NaN row there reaches the output), a chunk
// tile's rows below the chunk's end: K for the scores, then V for the
// values, the next step's 16-byte loads in flight in registers while the
// current one is computed on (at head dim 256, float32 and bfloat16 rows
// are loaded and converted when their step begins, as in csrc/prefill.cu).
// The group's scores are taken together (columns are independent: each
// thread a 4 x 4 block of (rows, columns));
// then page by page, in order, four threads a row take the page's row max,
// its weights, their sum and the rescale of (m, l); after V lands, each
// page's value product is a fresh fmaf chain over its columns (each thread a
// 4 x 4 block of (rows, features)) folded into acc, all in registers.
// Masks, per row:
//   history:  col < length, and length + row - col < window
//   chunk:    col < n_valid (the columns read), col <= row, row - col < window
// The query block (32 rows, not the reference's min(128, C)) changes only
// which wholly masked tiles are skipped.
// Built for W in {16, 32, 64, 112, 128, 256}; a call at head dims D, Dv <=
// 256 runs the narrowest W >= max(D, Dv), reading D K and Dv V features a
// row, staging zeros in the rest (tile_sm90.cuh: Stage, RowBytes: the zeros
// add fmaf(0, 0, acc) = acc to every chain, so the result is the plain
// version's at (D, Dv)) and storing Dv features. At W 112 (kimi-k2-1t-a32b)
// the staged rows are 128 floats wide and the value side runs W 128's layout,
// storing the first 112 features (tile_sm90.cuh:value_width, as in
// csrc/prefill.cu).
#include "tile_sm90.cuh"

using namespace repro;

namespace {

constexpr int kThreads = kChunkThreads;
constexpr int kRows = kChunkRows;
constexpr int kSub = kStageRows;
constexpr int kPad = kStagePad;
constexpr int kPLd = kScoreLd;
constexpr int kMaxGroupPages = 16;  // pages staged at once

// pages staged at once at page size ps (<= kMaxPage): one above kSub
__host__ __device__ constexpr int group_pages(int ps) {
  return ps > kSub ? 1 : (kSub / ps < kMaxGroupPages ? kSub / ps : kMaxGroupPages);
}

// staging sub-tiles a group's K (and its V) takes at page size ps
__host__ __device__ constexpr int group_subs(int ps) {
  return ps > kSub ? (ps + kSub - 1) / kSub : 1;
}

template <int D>
struct Smem {
  static constexpr int XLD = staged_width(D, D) + kPad;  // staged rows' stride
  float q[kRows * (D + kPad)];         // the CTA's query rows
  float x[kSub * XLD];                 // the staged K or V rows
  float sc[kSub];                      // their scale rows
  float r[kMaxGroupPages * kRows];     // each page's rescale of each row
  float l[kRows];
  // then, 16-byte aligned at kTail, a group's columns (group_subs(ps) * kSub):
  // p[cols * kPLd], the scores, then weights; vt[cols], their v scales
  static constexpr int kTail = (static_cast<int>(sizeof(float)) *
                                    (kRows * (D + kPad) + kSub * XLD + kSub +
                                     kMaxGroupPages * kRows + kRows) + 15) & ~15;
  static constexpr int bytes(int ps) {
    return kTail + static_cast<int>(sizeof(float)) * group_subs(ps) * kSub * (kPLd + 1);
  }
};

// One staging group of the walk: its first page (history) or tile (chunk),
// its page count, its first column and the rows read.
struct Group {
  bool hist;
  int p0, np, col0, nrows;
};

// three CTAs an SM (170 registers a thread) up to head dim 128; two at 112
// and 128 over float32 pages, whose 16-byte loads in flight take 56 and 64
// registers a thread and spill at 170, and at 256 (111,744 B of shared
// memory a CTA, and a thread's accumulators take 128 registers)
template <typename KV, int D>
constexpr int min_ctas() {
  return D >= 256 || (D >= 112 && sizeof(KV) == 4) ? 2 : 3;
}

// The whole-row walk (WHOLE; whole_fits) is this kernel with every test of
// the contract a constant: D == Dv == the built width, rows of whole 16-byte
// pieces, pages of at most kSub rows (one sub-tile a group: NS == 1). Its
// float operations and their order are the general walk's, so its output is
// the general walk's bit for bit wherever both run.
template <typename KV, int D, bool EXPMUL, bool WHOLE>
__global__ void __launch_bounds__(kThreads, min_ctas<KV, D>())
paged_prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                     const KV* __restrict__ vpool, const float* __restrict__ kspool,
                     const float* __restrict__ vspool, const KV* __restrict__ kn,
                     const KV* __restrict__ vn, const float* __restrict__ ksn,
                     const float* __restrict__ vsn, const int* __restrict__ bt,
                     const int* __restrict__ lens, const int* __restrict__ nvalid,
                     void* __restrict__ out, int H, int Hkv, int C, int nblk, int ps, int MB,
                     int window, float scale, int act_dtype, int dq_call, int dv_call,
                     RowBytes rb_call) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  const int dq = WHOLE ? D : dq_call, dv = WHOLE ? D : dv_call;
  const RowBytes rb = WHOLE ? RowBytes{kRowBytes, kRowBytes, 16} : rb_call;
  constexpr int DG = ChunkRows<D>::kGroups;      // 4-feature groups (padded)
  constexpr int RPT = ChunkRows<D>::RPT;         // value rows a thread
  constexpr int XLD = Smem<D>::XLD;
  static_assert(kRows * 4 == kThreads, "four weight threads a row");
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem);
  const int NS = WHOLE ? 1 : group_subs(ps);
  float* p_s = reinterpret_cast<float*>(smem + Smem<D>::kTail);  // [NS * kSub][kPLd]
  float* vt_s = p_s + NS * kSub * kPLd;                           // [NS * kSub]

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
    t.nrows = t.hist ? t.np * ps : min(t.np * ps, chunk_end - t.col0);
  };
  // pool row of row r of a history group
  const auto pool_row = [&](const Group& t, int r) {
    const int pp = r / ps;
    const int blk = min(__ldg(bt_row + t.p0 + pp), nblk - 1);
    return (static_cast<int64_t>(blk) * ps + (r - pp * ps)) * Hkv + h;
  };

  // staging step i: sub-tile i % NS of group i / (2 NS)'s K rows, then of
  // its V rows; in flight in registers, or (St::kSync) straight into sm.x
  using St = Stage<KV, D>;
  static_assert(St::DS + kPad == XLD, "staged at the stride the blocks read");
  St stage;
  const auto stage_step = [&](int i) {
    Group t;
    if (i / (2 * NS) >= n_groups) return;
    group_at(i / (2 * NS), t);
    const bool is_v = i % (2 * NS) >= NS;
    const int j0 = (i % NS) * kSub, nrows = max(0, min(kSub, t.nrows - j0));
    if (t.hist) {
      const unsigned char* pool = reinterpret_cast<const unsigned char*>(is_v ? vpool : kpool);
      const float* spool = is_v ? vspool : kspool;
      const int64_t row = is_v ? rb.v : rb.k;
      const auto src_row = [&](int r) { return pool + pool_row(t, j0 + r) * row; };
      const auto sc_row = [&](int r) { return spool + pool_row(t, j0 + r); };
      if constexpr (St::kSync) {
        stage.load_at(sm.x, sm.sc, src_row, sc_row, nrows, rb, is_v);
      } else {
        stage.fetch_at(src_row, sc_row, nrows, rb, is_v);
      }
    } else {
      const int64_t r = chunk0 + t.col0 + j0;
      const KV* src = is_v ? vn + r * dv : kn + r * dq;
      const float* sc = QUANT ? (is_v ? vsn : ksn) + r : nullptr;
      if constexpr (St::kSync) {
        stage.load(sm.x, sm.sc, src, sc, nrows, rb, is_v);
      } else {
        stage.fetch(src, sc, nrows, rb, is_v);
      }
    }
  };
  int step = 0;
  if constexpr (!St::kSync) stage_step(0);
  // the current step's rows into sm.x (the next step's in flight)
  const auto advance = [&]() {
    __syncthreads();  // the previous step's readers of sm.x are done
    if constexpr (St::kSync) {
      stage_step(step++);
      __syncthreads();
    } else {
      stage.commit(sm.x, sm.sc);
      __syncthreads();
      stage_step(++step);
    }
  };

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sm.q[r * (D + kPad) + d] =
        r < rows && (WHOLE || d < dq)
            ? load_act(q, (static_cast<int64_t>(bh) * C + r0 + r) * dq + d, act_dtype)
            : 0.0f;
  }
  zero_value_pad<D, D>(sm.x);

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
    // the group's K rows, a sub-tile a step (the first barrier also
    // publishes q)
    for (int sub = 0; sub < NS; ++sub) {
      advance();
      const int nc = min(kSub, t.nrows - sub * kSub);
      if (nc > 0)
        score_block<D, QUANT, XLD>(sm.q, sm.x, sm.sc, p_s + sub * kSub * kPLd, nc, scale);
    }
    if constexpr (QUANT) {
      for (int j = tid; j < t.nrows; j += kThreads)
        vt_s[j] = t.hist ? vspool[pool_row(t, j)] : vsn[chunk0 + t.col0 + j];
    }
    __syncthreads();
    // page by page, in order: the row max, the weights, their sum, the
    // rescale of (m, l)
    // a history page below the length without a window: every column valid
    const bool dense = t.hist && window <= 0 && t.col0 + t.nrows <= length;
    for (int pp = 0; pp < t.np; ++pp) {
      const int j0 = pp * ps, nc = min(ps, t.nrows - j0);
      const int c0 = t.col0 + j0;
      const auto valid = [&](int j) {
        const int col = c0 + j;
        if (t.hist)
          return dense || (col < length && (window <= 0 || length + row - col < window));
        return col <= row && (window <= 0 || row - col < window);
      };
      float mx = kMaskValue;
      for (int j = wpart; j < nc; j += 4)
        if (valid(j)) mx = max_nan(mx, p_s[(j0 + j) * kPLd + wrow]);
      mx = max_nan(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = max_nan(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = max_nan(m_run, mx);
      float ps_sum = 0.0f;
      for (int j = wpart; j < nc; j += 4) {
        float* pj = p_s + (j0 + j) * kPLd + wrow;
        const float p = valid(j) ? softmax_weight<EXPMUL>(*pj, m_new) : 0.0f;
        ps_sum += p;
        *pj = QUANT ? p * vt_s[j0 + j] : p;  // the weight the value product takes
      }
      ps_sum += __shfl_xor_sync(kFull, ps_sum, 1);
      ps_sum += __shfl_xor_sync(kFull, ps_sum, 2);
      const float r = rescale_factor<EXPMUL>(m_run, m_new);
      l_run = rescale<EXPMUL>(l_run, r) + ps_sum;
      m_run = m_new;
      if (wpart == 0) sm.r[pp * kRows + wrow] = r;
    }
    // page by page, in order: a fresh value product, folded into acc; a
    // page wider than a sub-tile (the group's only page) carries its chain
    // from sub-tile to sub-tile
    float dsum[RPT][4];
    for (int sub = 0; sub < NS; ++sub) {
      advance();  // a V sub-tile (the first barrier publishes the weights)
      const int s0 = sub * kSub, s1 = min(t.nrows, s0 + kSub);
      for (int pp = 0; pp < t.np; ++pp) {
        const int j0 = pp * ps, j1 = min(j0 + ps, t.nrows);
        // its columns staged (the whole-row walk: the group's one sub-tile)
        const int lo = WHOLE ? j0 : max(j0, s0), hi = WHOLE ? j1 : min(j1, s1);
        if (lo >= hi) continue;
        if (WHOLE || lo == j0) {
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) dsum[r][e] = 0.0f;
        }
        value_block<D, RPT, XLD>(dsum, p_s + lo * kPLd + RPT * vrg,
                                 sm.x + (lo - s0) * XLD + 4 * vdg, hi - lo);
        if (WHOLE || hi == j1) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float f = sm.r[pp * kRows + RPT * vrg + r];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = rescale<EXPMUL>(acc[r][e], f) + dsum[r][e];
          }
        }
      }
    }
  }

  if (wpart == 0) sm.l[wrow] = l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int vrow = RPT * vrg + r;
    if (vrow >= rows || 4 * vdg >= dv) continue;  // a padded feature: not stored
    const float l = sm.l[vrow];
    const float den = l == 0.0f ? 1.0f : l;
    const int64_t o = (static_cast<int64_t>(bh) * C + r0 + vrow) * dv + 4 * vdg;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * vdg + e < dv) store_act(out, o + e, acc[r][e] / den, act_dtype);
  }
}

// the rows as they lie in the pools and the chunk: D and Dv elements of KV,
// in the widest piece every address and row length allows
template <typename KV>
RowBytes row_bytes(const void* k, const void* v, const void* kn, const void* vn, int D, int Dv) {
  const int kb = D * static_cast<int>(sizeof(KV)), vb = Dv * static_cast<int>(sizeof(KV));
  return RowBytes{kb, vb,
                  piece_of(reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn) |
                           static_cast<uintptr_t>(kb) | static_cast<uintptr_t>(vb))};
}

// whether a call may take the whole-row walk of the W build: D == Dv == W,
// rows in 16-byte pieces, pages of at most one staging sub-tile
template <int W>
bool whole_fits(int D, int Dv, int ps, const RowBytes& rb) {
  return D == W && Dv == W && rb.piece == 16 && group_subs(ps) == 1;
}

}  // namespace

namespace paged_prefill_part {

// one call of the C entry paged_prefill, as the parts pass it on
struct Call {
  const void *q, *k, *v;
  const float *ks, *vs;
  const void *kn, *vn;
  const float *ksn, *vsn;
  const int *bt, *lens, *nvalid;
  void* out;
  int B, H, Hkv, C, D, Dv, nblk, ps, MB, window;
  float scale;
  int expmul, act_dtype, walk;
  int* taken;  // the walk the launch takes, written before it (may be null)
  cudaStream_t stream;
};

// each KV dtype's launches, defined in that dtype's part of the build
int run_f32(const Call& c);
int run_bf16(const Call& c);
int run_i8(const Call& c);
int run_fp8(const Call& c);

}  // namespace paged_prefill_part

namespace {

using paged_prefill_part::Call;

template <typename KV, int D, bool EXPMUL, bool WHOLE>
int launch_walk(const Call& c, const RowBytes& rb) {
  auto kernel = paged_prefill_kernel<KV, D, EXPMUL, WHOLE>;
  static bool wide_smem = false;  // once per instantiation: room for the widest page
  if (!wide_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::bytes(kMaxPage));
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_smem = true;
  }
  const dim3 grid(c.B * c.H, (c.C + kRows - 1) / kRows);
  kernel<<<grid, kThreads, Smem<D>::bytes(c.ps), c.stream>>>(
      c.q, static_cast<const KV*>(c.k), static_cast<const KV*>(c.v), c.ks, c.vs,
      static_cast<const KV*>(c.kn), static_cast<const KV*>(c.vn), c.ksn, c.vsn, c.bt, c.lens,
      c.nvalid, c.out, c.H, c.Hkv, c.C, c.nblk, c.ps, c.MB, c.window, c.scale, c.act_dtype,
      c.D, c.Dv, rb);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int D, bool EXPMUL>
int launch(const Call& c) {
  const RowBytes rb = row_bytes<KV>(c.k, c.v, c.kn, c.vn, c.D, c.Dv);
  const int walk = choose_walk(c.walk, whole_fits<D>(c.D, c.Dv, c.ps, rb));
  if (c.taken) *c.taken = walk;
  switch (walk) {
    case kWalkWhole: return launch_walk<KV, D, EXPMUL, true>(c, rb);
    case kWalkGeneral: return launch_walk<KV, D, EXPMUL, false>(c, rb);
    default: return static_cast<int>(cudaErrorInvalidValue);  // a forced whole walk refused
  }
}

template <typename KV>
int by_dim(const Call& c) {
#define REPRO_LAUNCH(DIM) return c.expmul ? launch<KV, DIM, true>(c) : launch<KV, DIM, false>(c)
  switch (square_width(c.D > c.Dv ? c.D : c.Dv)) {
    case 16: REPRO_LAUNCH(16);
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 112: REPRO_LAUNCH(112);
    case 128: REPRO_LAUNCH(128);
    case 256: REPRO_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

bool dims_ok(int D, int Dv, int ps) {
  return ps > 0 && ps <= kMaxPage && D > 0 && D <= kMaxHeadDim && Dv > 0 && Dv <= kMaxHeadDim;
}

}  // namespace

#if REPRO_IN_PART(REPRO_PART_F32)
int paged_prefill_part::run_f32(const Call& c) { return by_dim<float>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_BF16)
int paged_prefill_part::run_bf16(const Call& c) { return by_dim<__nv_bfloat16>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_I8)
int paged_prefill_part::run_i8(const Call& c) { return by_dim<int8_t>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_FP8)
int paged_prefill_part::run_fp8(const Call& c) { return by_dim<__nv_fp8_e4m3>(c); }
#endif

#if REPRO_IN_PART(REPRO_PART_F32)
// q (B*H, C, D) f32/bf16; pools (nblk, ps, Hkv, D) and (nblk, ps, Hkv, Dv)
// of kv_dtype and their scale pools (nblk, ps, Hkv) f32 for codes; chunk kn
// (B*Hkv, C, D) and vn (B*Hkv, C, Dv) of kv_dtype and ksn/vsn (B*Hkv, C) f32
// for codes; bt (B, MB) i32; lens / nvalid (B,) i32; out (B*H, C, Dv) in q's
// dtype. D, Dv and ps in [1, 256]; window <= 0: none; walk kWalkAuto,
// kWalkGeneral or kWalkWhole; *taken (unless null) gets the walk the call
// takes (-1: none). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a forced whole-row walk on a call that does
// not qualify).
extern "C" int paged_prefill(const void* q, const void* k, const void* v, const float* ks,
                             const float* vs, const void* kn, const void* vn, const float* ksn,
                             const float* vsn, const int* bt, const int* lens,
                             const int* nvalid, void* out, int B, int H, int Hkv, int C, int D,
                             int Dv, int nblk, int ps, int MB, int window, float scale,
                             int expmul, int act_dtype, int kv_dtype, int walk, int* taken,
                             void* stream) {
  if (taken) *taken = -1;
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0 || nblk <= 0 || MB < 0 || !dims_ok(D, Dv, ps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q,  k,  v,    ks,    vs, kn, vn,     ksn,   vsn,    bt,        lens, nvalid,
               out, B, H,    Hkv,   C,  D,  Dv,     nblk,  ps,     MB,        window,
               scale, expmul, act_dtype, walk, taken, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kF32: return paged_prefill_part::run_f32(c);
    case kBF16: return paged_prefill_part::run_bf16(c);
    case kI8: return paged_prefill_part::run_i8(c);
    case kFP8: return paged_prefill_part::run_fp8(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that paged_prefill gives each CTA at
// head dims (D, Dv) and page size ps (independent of every length, and the
// same on either walk); -1 past kMaxHeadDim or kMaxPage.
extern "C" long long paged_prefill_smem(int D, int Dv, int ps) {
  if (!dims_ok(D, Dv, ps)) return -1;
  switch (square_width(D > Dv ? D : Dv)) {
    case 16: return static_cast<long long>(Smem<16>::bytes(ps));
    case 32: return static_cast<long long>(Smem<32>::bytes(ps));
    case 64: return static_cast<long long>(Smem<64>::bytes(ps));
    case 112: return static_cast<long long>(Smem<112>::bytes(ps));
    case 128: return static_cast<long long>(Smem<128>::bytes(ps));
    case 256: return static_cast<long long>(Smem<256>::bytes(ps));
    default: return -1;
  }
}
#endif
