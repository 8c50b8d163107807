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
#include <cooperative_groups.h>

#include "tile_sm90.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxGroup = 32;      // query heads per KV head
constexpr int kMaxRankRows = 128;  // pool rows a rank stages a round
constexpr int kRankBytes = 32768;  // at most this many bytes of K rows
constexpr int kMaxRankPages = 8;   // pages a rank takes a round
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA can use

// pool rows a rank stages a round: 128 rows, or fewer where a row of D
// elements of KV is over 256 bytes (head dim 112: 73 float32 rows, four pages
// of 16; head dim 128: 64 float32 rows; head dim 256: 32 float32 rows, 64
// bfloat16), so the staged K and V rows stay within ~64 KB at every D
template <typename KV, int D>
__host__ __device__ constexpr int rank_rows() {
  constexpr int row = D * static_cast<int>(sizeof(KV));
  return kRankBytes / row < kMaxRankRows ? kRankBytes / row : kMaxRankRows;
}

// pages a rank takes a round at page size ps (<= kMaxPage)
template <typename KV, int D>
__host__ __device__ constexpr int rank_pages(int ps) {
  constexpr int rows = rank_rows<KV, D>();
  return rows / ps < kMaxRankPages ? rows / ps : kMaxRankPages;
}

struct Layout {
  int k_stride;  // bytes between staged K rows (padded by 16)
  int k, v, ks, vs, q, s, pmax, tmax, carry, f, part, st, total;  // byte offsets, size
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

template <typename KV, int D>
__host__ __device__ Layout layout(int group) {
  constexpr int F = sizeof(float);
  constexpr int P = kMaxRankPages;
  constexpr int kRankRows = rank_rows<KV, D>();
  Layout L;
  const int row = D * static_cast<int>(sizeof(KV));
  L.k_stride = row + 16;
  L.k = 0;
  L.v = align16(L.k + kRankRows * L.k_stride);
  L.ks = align16(L.v + kRankRows * row);
  L.vs = align16(L.ks + F * kRankRows);
  L.q = align16(L.vs + F * kRankRows);
  L.s = align16(L.q + F * group * D);                       // [group][kRankRows]
  L.pmax = align16(L.s + F * group * kRankRows);            // [P][group]: page maxima
  L.tmax = align16(L.pmax + F * P * group);                 // [2][kMaxCluster][group]
  L.carry = align16(L.tmax + F * 2 * kMaxCluster * group);  // [group]
  L.f = align16(L.carry + F * group);                       // [P][group]: rescale factors
  L.part = align16(L.f + F * P * group);                    // [P][group][D + 1]
  L.st = align16(L.part + F * P * group * (D + 1));         // [group][D + 1]: acc, l
  L.total = L.st + F * group * (D + 1);
  return L;
}

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const void* __restrict__ q, const KV* __restrict__ kpool,
                    const KV* __restrict__ vpool, const float* __restrict__ kspool,
                    const float* __restrict__ vspool, const int* __restrict__ bt,
                    const int* __restrict__ lens, void* __restrict__ out, int Hkv, int group,
                    int nblk, int ps, int MB, int CL, int window, float scale,
                    int act_dtype, int vec16) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  constexpr int kRankRows = rank_rows<KV, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<KV, D>(group);
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
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int length = lens[b];
  const int P = rank_pages<KV, D>(ps);
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
  // one commit group each, empty past the walk, so every thread counts alike:
  // every row of the chunk's pages, page by page through the block table
  // (the rows past the length too: the plain version weighs them 0 into
  // its value product, so a NaN there reaches the output, as it must)
  const auto copy_chunk = [&](int c, unsigned char* dst, int dst_stride, const KV* pool,
                              float* sc_dst, const float* sc_pool) {
    int p0, np;
    chunk(c, p0, np);
    if (np > 0) {
      const int nr = np * ps;
      const auto pool_row = [&](int r) {  // pool row of staged row r
        const int pp = r / ps;
        const int blk = min(__ldg(bt_row + p0 + pp), nblk - 1);
        return (static_cast<int64_t>(blk) * ps + (r - pp * ps)) * Hkv + h;
      };
      copy_rows_async_at(dst, dst_stride, nr, kRowBytes, vec16, [&](int r) {
        return reinterpret_cast<const unsigned char*>(pool) + pool_row(r) * kRowBytes;
      });
      if (QUANT) {
        for (int j = tid; j < nr; j += kThreads) cp_async4(sc_dst + j, sc_pool + pool_row(j));
      }
    }
    cp_async_commit();
  };

  // the first round's K and V in flight while q is read
  copy_chunk(rank, k_s, L.k_stride, kpool, ks_s, kspool);
  copy_chunk(rank, smem + L.v, kRowBytes, vpool, vs_s, vspool);
  for (int i = tid; i < group * D; i += kThreads)
    q_s[i] = load_act(q, static_cast<int64_t>(bh) * group * D + i, act_dtype);
  for (int i = tid; i < group; i += kThreads) carry_s[i] = kMaskValue;
  // this rank's rows of the running state: i = rank, rank + CL, ...
  const int my_rows = rank < group ? (group - rank + CL - 1) / CL : 0;
  for (int e = tid; e < my_rows * (D + 1); e += kThreads) st_s[e] = 0.0f;

  for (int round = 0; round < rounds; ++round) {
    const int c = round * CL + rank;
    int p0, np;
    chunk(c, p0, np);
    const int col0 = p0 * ps;                            // the chunk's first column
    const int nr = np * ps;                                // its rows staged
    const int nv = np > 0 ? min(nr, length - col0) : 0;    // those below the length
    float* tmax_s = reinterpret_cast<float*>(smem + L.tmax) + (round & 1) * kMaxCluster * group;

    // 1. the scores of this rank's pages, their row maxima, the chunk's to
    // every rank
    cp_async_wait<1>();  // K landed; V may still be in flight
    __syncthreads();
    for (int e = tid; e < group * nr; e += kThreads) {
      const int i = e / nr, j = e - i * nr;
      const KV* krow = reinterpret_cast<const KV*>(k_s + j * L.k_stride);
      const float4* qr = reinterpret_cast<const float4*>(q_s + i * D);
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qd = qr[d / 4];
        const float4 kd = load4<KV>(krow + d);
        dot = fmaf(qd.x, kd.x, dot);
        dot = fmaf(qd.y, kd.y, dot);
        dot = fmaf(qd.z, kd.z, dot);
        dot = fmaf(qd.w, kd.w, dot);
      }
      float sc = dot * scale;
      if (QUANT) sc *= ks_s[j];
      s_s[i * kRankRows + j] = j < nv && col0 + j >= floor_col ? sc : kMaskValue;
    }
    __syncthreads();  // the K readers are done
    copy_chunk(c + CL, k_s, L.k_stride, kpool, ks_s, kspool);  // the next round's K
    if (round == 0) cluster_wait();
    for (int x = warp; x < np * group; x += kWarps) {  // a warp a (page, row)
      const int pp = x / group, i = x - pp * group;
      const int j = pp * ps + lane;
      const float mx = warp_max(lane < ps && j < nr ? s_s[i * kRankRows + j] : kMaskValue);
      if (lane == 0) pmax_s[pp * group + i] = mx;
    }
    __syncthreads();
    for (int i = tid; i < group; i += kThreads) {
      float mx = kMaskValue;  // an idle rank's: the mask value
      for (int pp = 0; pp < np; ++pp) mx = max_nan(mx, pmax_s[pp * group + i]);
      for (int r = 0; r < CL; ++r) *cluster.map_shared_rank(tmax_s + rank * group + i, r) = mx;
    }
    cluster.sync();

    // 2. each page's prefix maximum m_t, rescale factor (m_{t-1} -> m_t),
    // weights, psum and dsum into f_s and part_s
    cp_async_wait<1>();  // V landed; the next K may still be in flight
    __syncthreads();
    for (int x = warp; x < np * group; x += kWarps) {
      const int pp = x / group, i = x - pp * group;
      float m_prev = carry_s[i];
      for (int u = 0; u < rank; ++u) m_prev = max_nan(m_prev, tmax_s[u * group + i]);
      for (int u = 0; u < pp; ++u) m_prev = max_nan(m_prev, pmax_s[u * group + i]);
      const float m = max_nan(m_prev, pmax_s[pp * group + i]);
      const int j = pp * ps + lane;
      const bool in = lane < ps && j < nr;
      const float p =
          in && j < nv && col0 + j >= floor_col ? softmax_weight<EXPMUL>(s_s[i * kRankRows + j], m)
                                                : 0.0f;
      const float psum = warp_sum(p);
      if (in) s_s[i * kRankRows + j] = QUANT ? p * vs_s[j] : p;  // the weight the values take
      if (lane == 0) {
        f_s[pp * group + i] = rescale_factor<EXPMUL>(m_prev, m);
        part_s[(pp * group + i) * (D + 1) + D] = psum;
      }
    }
    __syncthreads();  // the weights are in place
    // one thread a (page, row, 4 features): an fmaf chain over the page's
    // columns in order
    for (int e = tid; e < np * group * (D / 4); e += kThreads) {
      const int pi = e / (D / 4), d4 = (e - pi * (D / 4)) * 4;
      const int pp = pi / group, i = pi - pp * group;
      const int j0 = pp * ps, nc = min(ps, nr - j0);
      const float* wr = s_s + i * kRankRows + j0;
      const KV* vc = v_s + j0 * D + d4;
      float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < nc; ++j) {
        const float4 vv = load4<KV>(vc + j * D);
        const float w = wr[j];
        ds[0] = fmaf(w, vv.x, ds[0]);
        ds[1] = fmaf(w, vv.y, ds[1]);
        ds[2] = fmaf(w, vv.z, ds[2]);
        ds[3] = fmaf(w, vv.w, ds[3]);
      }
      float* dst = part_s + pi * (D + 1) + d4;
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = ds[u];
    }
    __syncthreads();  // the V and carry readers are done
    for (int i = tid; i < group; i += kThreads) {
      float cm = carry_s[i];
      for (int u = 0; u < CL; ++u) cm = max_nan(cm, tmax_s[u * group + i]);
      carry_s[i] = cm;
    }
    copy_chunk(c + CL, smem + L.v, kRowBytes, vpool, vs_s, vspool);  // the next round's V
    cluster.sync();  // every partial of the round is in place

    // 3. every rank folds its rows over the round's pages, rank by rank and
    // page by page in order: one thread an entry (i, d) of (acc, l), l as
    // d = D (psum in part_s's last column)
    const int n_here = min(CL, n_chunks - round * CL);  // ranks with a chunk
    for (int e = tid; e < my_rows * (D + 1); e += kThreads) {
      const int i = rank + CL * (e / (D + 1)), d = e % (D + 1);
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
            ds[pp] = pr[(pp * group + i) * (D + 1) + d];
            ff[pp] = fr[pp * group + i];
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
  for (int e = tid; e < my_rows * D; e += kThreads) {
    const int k = e / D, d = e - k * D, i = rank + CL * k;
    const float l = st_s[k * (D + 1) + D];
    store_act(out, (static_cast<int64_t>(bh) * group + i) * D + d,
              st_s[k * (D + 1) + d] / (l == 0.0f ? 1.0f : l), act_dtype);
  }
  cluster.sync();  // no CTA leaves while another may still read its partials
}

// The cluster size and the dynamic shared memory of a launch at page size
// ps over a table MB pages wide; the memory depends on neither.
template <typename KV, int D>
int launch_shape(int group, int ps, int MB, int& CL) {
  const int P = rank_pages<KV, D>(ps);
  const int T = (MB + P - 1) / P;  // chunks of the table's width
  CL = T < 1 ? 1 : (T < kMaxCluster ? T : kMaxCluster);
  return layout<KV, D>(group).total;
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* bt, const int* lens, void* out, int B, int Hkv, int group, int nblk,
           int ps, int MB, int window, float scale, int act_dtype, cudaStream_t stream) {
  int CL;
  const int smem = launch_shape<KV, D>(group, ps, MB, CL);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_decode_kernel<KV, D, EXPMUL>;
  static int granted = 48 * 1024;  // per instantiation
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const int vec16 = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * CL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, bt, lens,
      out, Hkv, group, nblk, ps, MB, CL, window, scale, act_dtype, vec16);
  if (e != cudaSuccess) return static_cast<int>(e);
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
long long smem_by_dim(int D, int group, int ps, int MB) {
  int CL;
  switch (D) {
    case 16: return static_cast<long long>(launch_shape<KV, 16>(group, ps, MB, CL));
    case 32: return static_cast<long long>(launch_shape<KV, 32>(group, ps, MB, CL));
    case 64: return static_cast<long long>(launch_shape<KV, 64>(group, ps, MB, CL));
    case 112: return static_cast<long long>(launch_shape<KV, 112>(group, ps, MB, CL));
    case 128: return static_cast<long long>(launch_shape<KV, 128>(group, ps, MB, CL));
    case 256: return static_cast<long long>(launch_shape<KV, 256>(group, ps, MB, CL));
    default: return -1;
  }
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
  if (B <= 0 || Hkv <= 0 || group <= 0 || group > kMaxGroup || ps <= 0 || ps > kMaxPage ||
      nblk <= 0 || MB < 0)
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

// The dynamic shared memory, in bytes, that paged_decode gives each CTA at
// these arguments (the same at any length and any table width MB); -1 for an
// unsupported D or dtype.
extern "C" long long paged_decode_smem(int group, int D, int ps, int MB, int kv_dtype) {
  switch (kv_dtype) {
    case kF32: return smem_by_dim<float>(D, group, ps, MB);
    case kBF16: return smem_by_dim<__nv_bfloat16>(D, group, ps, MB);
    case kI8: return smem_by_dim<int8_t>(D, group, ps, MB);
    case kFP8: return smem_by_dim<__nv_fp8_e4m3>(D, group, ps, MB);
    default: return -1;
  }
}
