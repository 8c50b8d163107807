// Paged flash-decode: one query token per sequence against the paged KV pool.
//
// Replaces the Pallas TPU kernel kernels/decode/decode.py:285
// (paged_decode_fwd_pallas, body _paged_decode_kernel at :162).
//
// What bounds it on the card: the bytes it must read, i.e. the pool codes
// (or values) and scale rows of every resident token, plus the block tables;
// the arithmetic is ~4 * group * D operations per token, far below the
// H100's ~295 operations per byte. A decode step of qwen2-0.5b at 8
// sequences x 1k context reads ~2 MB per layer, under a microsecond at
// 3.35 TB/s, so what the kernel can win is latency: few dependent memory
// round trips, many SMs at once.
//
// Design: the reference walks the pages of the block table in order, one
// page a KV tile (the ExpMul results depend on the width), tile t using the
// running max m_t = max(m_{t-1}, max_j s_tj): a prefix maximum of the
// pages' maxima. Once those maxima are known, every page's weights, weight
// sum psum_t and value product dsum_t follow from its own columns alone;
// only the fold, l_t = rescale(l_{t-1}, m_{t-1} -> m_t) + psum_t (acc the
// same way), runs in order. These are the sequential walk's float
// operations, in its order, so the split changes no bit (no combined
// rescale of partial states). csrc/decode.cu does the same over contiguous
// caches; kernels/flash/tile.py:paged_decode_fold is this algorithm in
// plain PyTorch.
//
// So the pages of one (sequence, KV head) run in parallel on the CTAs of one
// thread-block cluster of CL = min(8, ceil(MB / P)) CTAs (cudaLaunchKernelEx
// with a cluster dimension; the host reads no length), P = min(8, R / ps)
// pages (at most R = 128 pool rows, fewer for rows over 256 bytes: 32 at
// head dim 256 in float32; 8 pages at ps = 16 and R = 128, so 1,024 tokens
// are one round) a rank a round: round k gives chunk
// k * CL + r, pages [first + (k * CL + r) * P, ... + P) of the table, to
// rank r, so a CTA's shared memory holds one chunk and its partials at any
// length or table width. The walk covers pages [first, n): n stops at the
// length and at the table's width, and `first` is the window's lowest page
// (the pages below it contribute nothing, as the reference skips them). Each
// rank resolves its pages through the block table (a sentinel within the
// length is clamped to the last pool block, as the Pallas kernel does: the
// engine's idle decode slots carry length 1 over an all-sentinel table) and
// has every row of those pages (past the length too, weighed 0 into the
// value product as the plain version does) copied into shared memory by 16-byte
// cp.async, row by row (a page's rows for KV head h lie Hkv * D elements
// apart in the (nblk, ps, Hkv, D) pool; V's copy overlaps the scores, the
// next round's K and V overlap the rest of the round). It scores the GQA
// group's rows on its columns (one (row, column) a thread, the fmaf order of
// tile.cuh), takes each page's row maxima and stores the chunk's into every
// rank's shared memory (distributed shared memory); after a cluster barrier
// each rank takes each page's prefix maximum m_t (the earlier rounds'
// maximum, carried; this round's lower ranks'; its own earlier pages') and
// computes the page's rescale factor (m_{t-1} -> m_t), weights, psum and
// dsum (vs folded into the weights; one thread a (page, row, 4 features), an
// fmaf chain over the page's columns in order) into its own shared memory;
// after a second barrier every rank folds the round's partials, read from
// every rank's shared memory, page by page in order into the running
// (l, acc) of its own rows (rows rank, rank + CL, ...; one thread an entry),
// and at the end finalizes them (acc / l, 0 for a row with no column) as
// tile.py:finalize_tiles does. Every rank arrives at every barrier, idle ones
// too. A rank writes round k + 1's partials only after the barrier that
// every rank reaches once it has folded round k, the chunk maxima alternate
// between two buffers, and a last barrier keeps every CTA alive until the
// others have read its partials.
//
// The contract is the Pallas kernel's: any head dims D, Dv <= 256 (codes
// too), any GQA group, pages of 1 to 256 tokens. Built for W in {16, 32, 64,
// 112, 128, 256}: a call runs the narrowest W >= max(D, Dv), reads D K and Dv
// V features a row, zero-fills the rest of each staged K row (q's too), and
// stores Dv outputs; fmaf(0, 0, acc) = acc, so every score is the call's.
// A group wider than a CTA takes (32 rows, or fewer where shared memory
// binds) is split into parts along the grid's y axis (query rows are
// independent; each part re-reads the KV). A page wider than a rank's rows
// (R: 128, fewer for rows over 256 bytes) is a rank's only page of the
// round, staged in pieces of R rows: its scores are kept whole, so its row
// max, weights and rescale are taken once for the page, and its value chains
// are carried from piece to piece.
#include <cooperative_groups.h>

#include "tile_sm90.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxGroup = 32;      // query heads per KV head a part
constexpr int kMaxRankRows = 128;  // pool rows a rank stages at once
constexpr int kRankBytes = 32768;  // at most this many bytes of K rows
constexpr int kMaxRankPages = 8;   // pages a rank takes a round
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA can use

// pool rows a rank stages at once: 128 rows, or fewer where a row of W
// elements of KV is over 256 bytes (W 112: 73 float32 rows, four pages of
// 16; W 128: 64 float32 rows; W 256: 32 float32 rows, 64 bfloat16), so the
// staged K and V rows stay within ~64 KB at every W
template <typename KV, int W>
__host__ __device__ constexpr int rank_rows() {
  constexpr int row = W * static_cast<int>(sizeof(KV));
  return kRankBytes / row < kMaxRankRows ? kRankBytes / row : kMaxRankRows;
}

// pages a rank takes a round at page size ps: one for a page wider than the
// rank's rows (staged in pieces)
template <typename KV, int W>
__host__ __device__ constexpr int rank_pages(int ps) {
  constexpr int rows = rank_rows<KV, W>();
  return ps > rows ? 1 : (rows / ps < kMaxRankPages ? rows / ps : kMaxRankPages);
}

// score columns a rank holds a round: its rows, or a whole wide page
template <typename KV, int W>
__host__ __device__ constexpr int rank_cols(int ps) {
  return ps > rank_rows<KV, W>() ? ps : rank_rows<KV, W>();
}

struct Layout {
  int k_stride;  // bytes between staged K rows (padded by 16)
  int k, v, ks, vs, q, s, pmax, tmax, carry, f, part, st, total;  // byte offsets, size
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// the layout of a CTA of `group` query rows at page size ps
template <typename KV, int W>
__host__ __device__ Layout layout(int group, int ps) {
  constexpr int F = sizeof(float);
  constexpr int kRankRows = rank_rows<KV, W>();
  const int P = rank_pages<KV, W>(ps), SC = rank_cols<KV, W>(ps);
  Layout L;
  const int row = W * static_cast<int>(sizeof(KV));
  L.k_stride = row + 16;
  L.k = 0;
  L.v = align16(L.k + kRankRows * L.k_stride);
  L.ks = align16(L.v + kRankRows * row);
  L.vs = align16(L.ks + F * SC);
  L.q = align16(L.vs + F * SC);
  L.s = align16(L.q + F * group * W);                       // [group][SC]
  L.pmax = align16(L.s + F * group * SC);                   // [P][group]: page maxima
  L.tmax = align16(L.pmax + F * P * group);                 // [2][kMaxCluster][group]
  L.carry = align16(L.tmax + F * 2 * kMaxCluster * group);  // [group]
  L.f = align16(L.carry + F * group);                       // [P][group]: rescale factors
  L.part = align16(L.f + F * P * group);                    // [P][group][W + 1]
  L.st = align16(L.part + F * P * group * (W + 1));         // [group][W + 1]: acc, l
  L.total = L.st + F * group * (W + 1);
  return L;
}

// query rows a CTA takes at page size ps: the most (<= kMaxGroup) whose
// layout fits a CTA, shared out evenly over the fewest parts; 0 if none fits
template <typename KV, int W>
int part_rows(int group, int ps) {
  int most = group < kMaxGroup ? group : kMaxGroup;
  while (most > 0 && layout<KV, W>(most, ps).total > kMaxSmem) --most;
  if (most == 0) return 0;
  const int parts = (group + most - 1) / most;
  return (group + parts - 1) / parts;
}

// The whole-row walk (WHOLE; whole_fits) is this kernel with every test of
// the contract a constant: D == Dv == W, rows of whole 16-byte pieces, pages
// of at most R rows (never wide) and the group in one part. Its float
// operations and their order are the general walk's, so its output is the
// general walk's bit for bit wherever both run.
template <typename KV, int W, bool EXPMUL, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                    const KV* __restrict__ vpool, const float* __restrict__ kspool,
                    const float* __restrict__ vspool, const int* __restrict__ bt,
                    const int* __restrict__ lens, void* __restrict__ out, int Hkv, int group,
                    int gpart, int nblk, int ps, int MB, int CL, int window, float scale,
                    int act_dtype, int dq_call, int dv_call, RowBytes rb_call) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int kRowBytes = W * static_cast<int>(sizeof(KV));  // a staged row's
  constexpr int R = rank_rows<KV, W>();
  const int dq = WHOLE ? W : dq_call, dv = WHOLE ? W : dv_call;
  const RowBytes rb = WHOLE ? RowBytes{kRowBytes, kRowBytes, 16} : rb_call;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<KV, W>(gpart, ps);
  unsigned char* k_s = smem + L.k;
  const KV* v_s = reinterpret_cast<const KV*>(smem + L.v);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* pmax_s = reinterpret_cast<float*>(smem + L.pmax);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);
  float* f_s = reinterpret_cast<float*>(smem + L.f);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* st_s = reinterpret_cast<float*>(smem + L.st);

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // matched by cluster_wait before the first remote store
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / CL;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int g0 = WHOLE ? 0 : blockIdx.y * gpart;       // this part's first query row
  const int G = WHOLE ? group : min(gpart, group - g0);  // and its rows
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int length = lens[b];
  const int P = rank_pages<KV, W>(ps);
  const int SC = rank_cols<KV, W>(ps);         // s_s's row stride
  const bool wide = !WHOLE && ps > R;          // one page a rank, staged in pieces
  const int n_pieces = wide ? (ps + R - 1) / R : 1;
  // the walk: pages [first, n_pages), stopping at the length and at the
  // table's width; pages wholly below the window's floor are skipped
  const int n_pages = min((length + ps - 1) / ps, MB);
  const int first = window > 0 ? min(n_pages, max(0, length - window) / ps) : 0;
  const int n_chunks = (n_pages - first + P - 1) / P;
  const int rounds = max(1, (n_chunks + CL - 1) / CL);  // the same on every rank
  const int floor_col = window > 0 ? length - window : 0;  // columns below it are masked
  const int* bt_row = bt + static_cast<int64_t>(b) * MB;

  // chunk c: its first page and its page count (0 past the walk)
  const auto chunk = [&](int c, int& p0, int& np) {
    p0 = first + c * P;
    np = c < n_chunks ? min(P, n_pages - p0) : 0;
  };
  // pool row of the chunk's row r
  const auto pool_row = [&](int p0, int r) {
    const int pp = r / ps;
    const int blk = min(__ldg(bt_row + p0 + pp), nblk - 1);
    return (static_cast<int64_t>(blk) * ps + (r - pp * ps)) * Hkv + h;
  };
  // rows [off, off + n) of chunk c's pages (the rows past the length too:
  // the plain version weighs them 0 into its value product, so a NaN there
  // reaches the output, as it must), `bytes` of each, zero to `fill`; no
  // commit
  const auto copy_rows = [&](int c, int off, int n, unsigned char* dst, int dst_stride,
                             const KV* pool, int bytes, int fill) {
    int p0, np;
    chunk(c, p0, np);
    n = min(n, np * ps - off);
    const auto src = [&](int r) {
      return reinterpret_cast<const unsigned char*>(pool) + pool_row(p0, off + r) * bytes;
    };
    if (n > 0 && (WHOLE || (bytes == kRowBytes && rb.piece == 16))) {  // whole rows
      copy_rows_async_at(dst, dst_stride, n, kRowBytes, kRowBytes, 16, src);
    } else if (!WHOLE && n > 0) {
      copy_rows_async_at(dst, dst_stride, n, bytes, fill, rb.piece, src);
    }
  };
  const auto copy_scales = [&](int c, float* dst, const float* spool) {
    int p0, np;
    chunk(c, p0, np);
    for (int j = tid; j < np * ps; j += kThreads) cp_async4(dst + j, spool + pool_row(p0, j));
  };
  // one commit group each, empty past the walk, so every thread counts alike:
  // every row of the chunk (its K rows zero-filled to W)
  const auto copy_k = [&](int c) {
    copy_rows(c, 0, R, k_s, L.k_stride, kpool, rb.k, kRowBytes);
    if (QUANT) copy_scales(c, ks_s, kspool);
    cp_async_commit();
  };
  const auto copy_v = [&](int c) {
    copy_rows(c, 0, R, smem + L.v, kRowBytes, vpool, rb.v, rb.v);
    if (QUANT) copy_scales(c, vs_s, vspool);
    cp_async_commit();
  };
  // the scores of the chunk's rows [off, off + n) (staged in k_s) for this
  // part's rows: one (row, column) a thread, the fmaf order of tile.cuh
  const auto scores = [&](int off, int n, int col0, int nv) {
    for (int e = tid; e < G * n; e += kThreads) {
      const int i = e / n, j = e - i * n, col = off + j;
      const KV* krow = reinterpret_cast<const KV*>(k_s + j * L.k_stride);
      const float4* qr = reinterpret_cast<const float4*>(q_s + i * W);
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < W; d += 4) {
        const float4 qd = qr[d / 4];
        const float4 kd = load4<KV>(krow + d);
        dot = fmaf(qd.x, kd.x, dot);
        dot = fmaf(qd.y, kd.y, dot);
        dot = fmaf(qd.z, kd.z, dot);
        dot = fmaf(qd.w, kd.w, dot);
      }
      float sc = dot * scale;
      if (QUANT) sc *= ks_s[col];
      s_s[i * SC + col] = col < nv && col0 + col >= floor_col ? sc : kMaskValue;
    }
  };
  // each page's value product over the chunk's rows [off, off + n) (staged
  // in v_s): one thread a (page, row, 4 features), an fmaf chain over the
  // page's columns in order, carried in part_s from piece to piece; every
  // feature of the built width W (those past dv are never stored)
  const auto values = [&](int off, int n, int np, int nr) {
    for (int e = tid; e < np * G * (W / 4); e += kThreads) {
      const int pi = e / (W / 4), d4 = (e - pi * (W / 4)) * 4;
      const int pp = pi / G, i = pi - pp * G;
      const int j0 = pp * ps;
      // (the whole-row walk: one piece, off 0 and n nr)
      const int lo = WHOLE ? j0 : max(j0, off);
      const int hi = WHOLE ? min(j0 + ps, nr) : min(min(j0 + ps, nr), off + n);
      if (lo >= hi) continue;
      const float* wr = s_s + i * SC + lo;
      const KV* vc = v_s + (lo - off) * W + d4;
      float* dst = part_s + pi * (W + 1) + d4;
      float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!WHOLE && lo > j0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) ds[u] = dst[u];
      }
      for (int j = 0; j < hi - lo; ++j) {
        const float4 vv = load4<KV>(vc + j * W);
        const float w = wr[j];
        ds[0] = fmaf(w, vv.x, ds[0]);
        ds[1] = fmaf(w, vv.y, ds[1]);
        ds[2] = fmaf(w, vv.z, ds[2]);
        ds[3] = fmaf(w, vv.w, ds[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = ds[u];
    }
  };

  // the first round's K and V in flight while q is read
  if (!wide) {
    copy_k(rank);
    copy_v(rank);
  }
  for (int e = tid; e < G * W; e += kThreads) {
    const int i = e / W, d = e - i * W;
    q_s[e] = WHOLE || d < dq
                 ? load_act(q, (static_cast<int64_t>(bh) * group + g0 + i) * dq + d, act_dtype)
                 : 0.0f;
  }
  for (int i = tid; i < G; i += kThreads) carry_s[i] = kMaskValue;
  // this rank's rows of the running state: i = rank, rank + CL, ...
  const int my_rows = rank < G ? (G - rank + CL - 1) / CL : 0;
  for (int e = tid; e < my_rows * (W + 1); e += kThreads) st_s[e] = 0.0f;

  for (int round = 0; round < rounds; ++round) {
    const int c = round * CL + rank;
    int p0, np;
    chunk(c, p0, np);
    const int col0 = p0 * ps;                            // the chunk's first column
    const int nr = np * ps;                                // its rows staged
    const int nv = np > 0 ? min(nr, length - col0) : 0;    // those below the length
    float* tmax_s = reinterpret_cast<float*>(smem + L.tmax) + (round & 1) * kMaxCluster * G;

    // 1. the scores of this rank's pages, their row maxima, the chunk's to
    // every rank; a wide page's scale rows, then its K rows R at a time
    if (wide && QUANT) {
      copy_scales(c, ks_s, kspool);
      copy_scales(c, vs_s, vspool);
    }
    for (int pc = 0; pc < n_pieces; ++pc) {
      if (wide) {
        copy_rows(c, pc * R, R, k_s, L.k_stride, kpool, rb.k, kRowBytes);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();  // K landed; V may still be in flight
      }
      __syncthreads();
      scores(pc * R, wide ? max(0, min(R, nr - pc * R)) : nr, col0, nv);
      __syncthreads();  // the K readers are done
    }
    if (!wide) copy_k(c + CL);  // the next round's K
    if (round == 0) cluster_wait();
    for (int x = warp; x < np * G; x += kWarps) {  // a warp a (page, row)
      const int pp = x / G, i = x - pp * G;
      const int j0 = pp * ps, end = min(j0 + ps, nr);
      float mx = lane < end - j0 ? s_s[i * SC + j0 + lane] : kMaskValue;
      for (int j = j0 + kWarp + lane; j < end; j += kWarp) mx = max_nan(mx, s_s[i * SC + j]);
      mx = warp_max(mx);
      if (lane == 0) pmax_s[pp * G + i] = mx;
    }
    __syncthreads();
    for (int i = tid; i < G; i += kThreads) {
      float mx = kMaskValue;  // an idle rank's: the mask value
      for (int pp = 0; pp < np; ++pp) mx = max_nan(mx, pmax_s[pp * G + i]);
      for (int r = 0; r < CL; ++r) *cluster.map_shared_rank(tmax_s + rank * G + i, r) = mx;
    }
    cluster.sync();

    // 2. each page's prefix maximum m_t, rescale factor (m_{t-1} -> m_t),
    // weights, psum and dsum into f_s and part_s
    if (!wide) cp_async_wait<1>();  // V landed; the next K may still be in flight
    __syncthreads();
    for (int x = warp; x < np * G; x += kWarps) {
      const int pp = x / G, i = x - pp * G;
      float m_prev = carry_s[i];
      for (int u = 0; u < rank; ++u) m_prev = max_nan(m_prev, tmax_s[u * G + i]);
      for (int u = 0; u < pp; ++u) m_prev = max_nan(m_prev, pmax_s[u * G + i]);
      const float m = max_nan(m_prev, pmax_s[pp * G + i]);
      const int end = min(pp * ps + ps, nr);
      float psum = 0.0f;
      for (int j = pp * ps + lane; j < end; j += kWarp) {
        const float p =
            j < nv && col0 + j >= floor_col ? softmax_weight<EXPMUL>(s_s[i * SC + j], m) : 0.0f;
        psum += p;
        s_s[i * SC + j] = QUANT ? p * vs_s[j] : p;  // the weight the values take
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        f_s[pp * G + i] = rescale_factor<EXPMUL>(m_prev, m);
        part_s[(pp * G + i) * (W + 1) + W] = psum;
      }
    }
    __syncthreads();  // the weights are in place
    for (int pc = 0; pc < n_pieces; ++pc) {
      if (wide) {  // the wide page's V rows R at a time
        copy_rows(c, pc * R, R, smem + L.v, kRowBytes, vpool, rb.v, rb.v);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      values(pc * R, wide ? max(0, min(R, nr - pc * R)) : nr, np, nr);
      __syncthreads();  // the V and carry readers are done
    }
    for (int i = tid; i < G; i += kThreads) {
      float cm = carry_s[i];
      for (int u = 0; u < CL; ++u) cm = max_nan(cm, tmax_s[u * G + i]);
      carry_s[i] = cm;
    }
    if (!wide) copy_v(c + CL);  // the next round's V
    cluster.sync();  // every partial of the round is in place

    // 3. every rank folds its rows over the round's pages, rank by rank and
    // page by page in order: one thread an entry (i, d) of (acc, l), l as
    // d = W (psum in part_s's last column); features past dv are never
    // stored
    const int n_here = min(CL, n_chunks - round * CL);  // ranks with a chunk
    for (int e = tid; e < my_rows * (W + 1); e += kThreads) {
      const int i = rank + CL * (e / (W + 1)), d = e % (W + 1);
      float x = st_s[e];
      for (int u = 0; u < n_here; ++u) {
        int up0, unp;
        chunk(round * CL + u, up0, unp);
        const float* pr = cluster.map_shared_rank(part_s, u);
        const float* fr = cluster.map_shared_rank(f_s, u);
        float ds[kMaxRankPages], ff[kMaxRankPages];
#pragma unroll
        for (int pp = 0; pp < kMaxRankPages; ++pp) {
          if (pp < unp) {
            ds[pp] = pr[(pp * G + i) * (W + 1) + d];
            ff[pp] = fr[pp * G + i];
          }
        }
#pragma unroll
        for (int pp = 0; pp < kMaxRankPages; ++pp)
          if (pp < unp) x = rescale<EXPMUL>(x, ff[pp]) + ds[pp];
      }
      st_s[e] = x;
    }
  }

  __syncthreads();  // every row's l is in place
  for (int e = tid; e < my_rows * dv; e += kThreads) {
    const int k = e / dv, d = e - k * dv, i = rank + CL * k;
    const float l = st_s[k * (W + 1) + W];
    store_act(out, (static_cast<int64_t>(bh) * group + g0 + i) * dv + d,
              st_s[k * (W + 1) + d] / (l == 0.0f ? 1.0f : l), act_dtype);
  }
  cluster.sync();  // no CTA leaves while another may still read its partials
}

// The query rows a CTA takes, its cluster size and its dynamic shared
// memory at page size ps over a table MB pages wide (the memory depends on
// no length or width); a memory of -1 where no part fits a CTA.
template <typename KV, int W>
int launch_shape(int group, int ps, int MB, int& gpart, int& CL) {
  const int P = rank_pages<KV, W>(ps);
  const int T = (MB + P - 1) / P;  // chunks of the table's width
  CL = T < 1 ? 1 : (T < kMaxCluster ? T : kMaxCluster);
  gpart = part_rows<KV, W>(group, ps);
  return gpart > 0 ? layout<KV, W>(gpart, ps).total : -1;
}

// the rows as they lie in the pools: D and Dv elements of KV, in the widest
// piece every pool address and row length allows
template <typename KV>
RowBytes row_bytes(const void* k, const void* v, int D, int Dv) {
  const int kb = D * static_cast<int>(sizeof(KV)), vb = Dv * static_cast<int>(sizeof(KV));
  return RowBytes{kb, vb,
                  piece_of(reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                           static_cast<uintptr_t>(kb) | static_cast<uintptr_t>(vb))};
}

// whether a call may take the whole-row walk of the W build: D == Dv == W
// (so each row is kRowBytes), rows in 16-byte pieces, pages of at most R
// rows (no wide page) and the group in one part
template <typename KV, int W>
bool whole_fits(int group, int D, int Dv, int ps, const RowBytes& rb) {
  return D == W && Dv == W && rb.piece == 16 && ps <= rank_rows<KV, W>() &&
         part_rows<KV, W>(group, ps) == group;
}

}  // namespace

namespace paged_decode_part {

// one call of the C entry paged_decode, as the parts pass it on
struct Call {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *bt, *lens;
  void* out;
  int B, Hkv, group, D, Dv, nblk, ps, MB, window;
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

}  // namespace paged_decode_part

namespace {

using paged_decode_part::Call;

template <typename KV, int W, bool EXPMUL, bool WHOLE>
int launch_walk(const Call& c, int gpart, int CL, int smem, const RowBytes& rb) {
  auto kernel = paged_decode_kernel<KV, W, EXPMUL, WHOLE>;
  static int granted = 48 * 1024;  // per instantiation
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.B * c.Hkv * CL, (c.group + gpart - 1) / gpart);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, c.q, static_cast<const KV*>(c.k), static_cast<const KV*>(c.v), c.ks, c.vs,
      c.bt, c.lens, c.out, c.Hkv, c.group, gpart, c.nblk, c.ps, c.MB, CL, c.window, c.scale,
      c.act_dtype, c.D, c.Dv, rb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int W, bool EXPMUL>
int launch(const Call& c) {
  int gpart, CL;
  const int smem = launch_shape<KV, W>(c.group, c.ps, c.MB, gpart, CL);
  if (smem < 0 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const RowBytes rb = row_bytes<KV>(c.k, c.v, c.D, c.Dv);
  const int walk = choose_walk(c.walk, whole_fits<KV, W>(c.group, c.D, c.Dv, c.ps, rb));
  if (c.taken) *c.taken = walk;
  switch (walk) {
    case kWalkWhole: return launch_walk<KV, W, EXPMUL, true>(c, gpart, CL, smem, rb);
    case kWalkGeneral: return launch_walk<KV, W, EXPMUL, false>(c, gpart, CL, smem, rb);
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

template <typename KV>
long long smem_by_dim(int D, int Dv, int group, int ps, int MB) {
  int gpart, CL;
  switch (square_width(D > Dv ? D : Dv)) {
    case 16: return static_cast<long long>(launch_shape<KV, 16>(group, ps, MB, gpart, CL));
    case 32: return static_cast<long long>(launch_shape<KV, 32>(group, ps, MB, gpart, CL));
    case 64: return static_cast<long long>(launch_shape<KV, 64>(group, ps, MB, gpart, CL));
    case 112: return static_cast<long long>(launch_shape<KV, 112>(group, ps, MB, gpart, CL));
    case 128: return static_cast<long long>(launch_shape<KV, 128>(group, ps, MB, gpart, CL));
    case 256: return static_cast<long long>(launch_shape<KV, 256>(group, ps, MB, gpart, CL));
    default: return -1;
  }
}

bool dims_ok(int D, int Dv, int group, int ps) {
  return D > 0 && D <= kMaxHeadDim && Dv > 0 && Dv <= kMaxHeadDim && group > 0 && ps > 0 &&
         ps <= kMaxPage;
}

}  // namespace

#if REPRO_IN_PART(REPRO_PART_F32)
int paged_decode_part::run_f32(const Call& c) { return by_dim<float>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_BF16)
int paged_decode_part::run_bf16(const Call& c) { return by_dim<__nv_bfloat16>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_I8)
int paged_decode_part::run_i8(const Call& c) { return by_dim<int8_t>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_FP8)
int paged_decode_part::run_fp8(const Call& c) { return by_dim<__nv_fp8_e4m3>(c); }
#endif

#if REPRO_IN_PART(REPRO_PART_F32)
// q (B*Hkv, group, D) f32/bf16; pools (nblk, ps, Hkv, D) and (nblk, ps,
// Hkv, Dv) of kv_dtype; scale pools (nblk, ps, Hkv) f32 for codes (else
// unused); bt (B, MB) i32; lens (B,) i32; out (B*Hkv, group, Dv) in q's
// dtype. D, Dv and ps in [1, 256], any group >= 1; window <= 0: none; walk
// kWalkAuto, kWalkGeneral or kWalkWhole; *taken (unless null) gets the walk
// the call takes (-1: none). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a forced whole-row walk on a call that does
// not qualify).
extern "C" int paged_decode(const void* q, const void* k, const void* v, const float* ks,
                            const float* vs, const int* bt, const int* lens, void* out, int B,
                            int Hkv, int group, int D, int Dv, int nblk, int ps, int MB,
                            int window, float scale, int expmul, int act_dtype, int kv_dtype,
                            int walk, int* taken, void* stream) {
  if (taken) *taken = -1;
  if (B <= 0 || Hkv <= 0 || !dims_ok(D, Dv, group, ps) || nblk <= 0 || MB < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q,     k,  v,  ks,   vs, bt, lens,   out,   B,      Hkv,       group,
               D,     Dv, nblk, ps, MB, window, scale, expmul, act_dtype, walk,
               taken, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kF32: return paged_decode_part::run_f32(c);
    case kBF16: return paged_decode_part::run_bf16(c);
    case kI8: return paged_decode_part::run_i8(c);
    case kFP8: return paged_decode_part::run_fp8(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that paged_decode gives each CTA at
// these arguments (the same at any length and any table width MB, and on
// either walk; a group split into parts counts one part); -1 where it
// launches nothing.
extern "C" long long paged_decode_smem(int group, int D, int Dv, int ps, int MB, int kv_dtype) {
  if (!dims_ok(D, Dv, group, ps)) return -1;
  switch (kv_dtype) {
    case kF32: return smem_by_dim<float>(D, Dv, group, ps, MB);
    case kBF16: return smem_by_dim<__nv_bfloat16>(D, Dv, group, ps, MB);
    case kI8: return smem_by_dim<int8_t>(D, Dv, group, ps, MB);
    case kFP8: return smem_by_dim<__nv_fp8_e4m3>(D, Dv, group, ps, MB);
    default: return -1;
  }
}
#endif
