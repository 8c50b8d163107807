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
// ~2 MB per layer, under a microsecond at 3.35 TB/s, so what the kernel can
// win is latency: few dependent memory round trips, many SMs at once.
//
// Design: the reference walks the KV tiles of bk = min(256, S) columns in
// order (the ExpMul results depend on the width), tile t using the running
// max m_t = max(m_{t-1}, max_j s_tj): a prefix maximum of the tiles'
// maxima. Once those maxima are known, every tile's weights, weight sum
// psum_t and value product dsum_t follow from its own columns alone; only
// the fold, l_t = rescale(l_{t-1}, m_{t-1} -> m_t) + psum_t (acc the same
// way), runs in order. These are the sequential walk's float operations, in
// its order, so the split changes no bit (no combined rescale of partial
// states, as the usual split-KV merge does).
//
// So the tiles of one (sequence, KV head) run in parallel on the CTAs of
// one thread-block cluster of CL = min(8, T) CTAs (T = ceil(S / bk) tiles;
// cudaLaunchKernelEx with a cluster dimension; the host reads no length),
// in rounds: round k gives tile k * CL + r to rank r, so a CTA's shared
// memory holds one tile and one tile's partials at any S. In a round each
// CTA has its tile's K and V rows and scale rows copied into shared memory
// by cp.async (V's copy overlaps the scores, the next round's K and V
// overlap the rest of the round), scores the GQA group's rows on its
// columns (one column per thread, the fmaf order of tile.cuh), takes the
// tile's row maxima and stores them into every rank's shared memory
// (distributed shared memory); after a cluster barrier each rank takes its
// prefix maximum (the earlier rounds' maximum, carried, and this round's
// lower ranks') and computes the weights, psum_t and dsum_t (vs folded into
// the weights) into its own shared memory; after a second barrier rank 0
// reads the round's partials from every rank and folds them in order into
// its running (m, l, acc), and at the end finalizes (acc / l, 0 for a row
// with no column) as tile.py:finalize_tiles does. Every rank arrives at every
// barrier, idle ones too (tiles at or past the length, or a length of 0).
// A rank writes round k + 1's partials only after the barrier that rank 0
// reaches once it has folded round k, the maxima alternate between two
// buffers, and a last barrier keeps every CTA alive until rank 0 has read
// its partials. Tiles at or past min(length, S) are neither read nor
// folded. A tile reads all its rows (to S), its stale rows past the length
// too, and weighs those 0 into the value product as the plain version and
// the Pallas kernel do, so a NaN row there reaches the output (0 * NaN).
//
// Above head dim 64 (arctic-480b's 128, gemma's 256) a tile's rows do not fit
// in a CTA, and the tile cannot shrink (its width is part of an ExpMul result): the round's
// tile is staged in steps through two buffers instead, K in chunks of 64
// features of all its rows (one thread a column, its score chain carried
// from chunk to chunk in depth order), then V in sub-tiles of 64 rows (one
// thread a (row, feature) output, its value chain carried from sub-tile to
// sub-tile in column order), the next step's cp.async in flight while the
// current one is computed on. The scores, maxima, weights and fold are the
// same operations in the same order.
//
// K rows may be wider than V rows (MLA's expanded latents: DK 96, DV 64, as
// the reference's kernel takes them): q and the scores walk DK features, the
// partials, the running state and the output DV. Built for (W, W) with W in
// {16, 32, 64, 112, 128, 256} over every KV dtype, and for (96, 64) over
// float32 and bfloat16 KV. At (96, 64) a tile fits a CTA unsplit: 256 rows
// of K and V are 53,248 + 32,768 B in bfloat16 and 102,400 + 65,536 B in
// float32, under the 232,448 a CTA can use.
//
// The contract is the Pallas kernel's: any head dims D, Dv <= 256, codes
// too, and any GQA group. A call runs the narrowest build that holds (D, Dv)
// (built_dims), reads D K and Dv V features a row, zero-fills the rest of
// each staged K row (q's too) and stores Dv outputs; fmaf(0, 0, acc) = acc,
// so every score is the call's. A group wider than a CTA takes (32 rows, or
// fewer where shared memory binds: 21 at W 256 over float32) is split into
// parts along the grid's y axis; query rows are independent, and each part
// re-reads the KV.
#include <cooperative_groups.h>

#include "tile_sm90.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxGroup = 32;      // query heads per KV head a part
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA can use

struct Layout {
  int k_stride;  // bytes between staged K rows (padded by 16)
  int k, v, ks, vs, q, s, tmax, carry, part, m, l, acc, total;  // byte offsets, size
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Above DK + DV = 160 features a tile's K and V rows do not fit in a CTA (256
// rows of 256 float32 are 256 KB each), so the tile is staged in steps: K in
// depth chunks of kDepth features of all its rows (each thread carries its
// columns' score chains from chunk to chunk in s_s), then V in sub-tiles of
// kSubRows rows of all D features (each thread carries its outputs' value
// chains from sub-tile to sub-tile in part_s), every step double-buffered
// by cp.async. The tile, its maxima and every chain's order stay as they are.
// D 112, 128 and 256 are split (DK == DV there): at 128, K + V is 256
// features, two K chunks and four V sub-tiles a 256-column tile; at 112 (28
// float4 groups) two K chunks of 56 features.
template <int DK, int DV>
__host__ __device__ constexpr bool split_tile() { return DK + DV > 160; }
// K features a step (split tiles): 64, or 56 at head dim 112. Its rows are 56
// bytes of int8 or fp8 codes there, so those chunks are copied in 4-byte
// pieces (piece_of).
template <int DK>
__host__ __device__ constexpr int split_depth() { return DK % 64 == 0 ? 64 : 56; }
constexpr int kSubRows = 64;  // V rows a step (split tiles)

template <typename KV, int DK, int DV>
__host__ __device__ Layout layout(int group, int bk) {
  constexpr int F = sizeof(float);
  Layout L;
  const int krow = DK * static_cast<int>(sizeof(KV));
  const int vrow = DV * static_cast<int>(sizeof(KV));
  if constexpr (split_tile<DK, DV>()) {
    // two step buffers: a K chunk of bk rows, or a V sub-tile
    L.k_stride = split_depth<DK>() * static_cast<int>(sizeof(KV)) + 16;
    const int step = align16(bk * L.k_stride > kSubRows * vrow ? bk * L.k_stride
                                                                : kSubRows * vrow);
    L.k = 0;
    L.v = step;
    L.ks = 2 * step;
  } else {
    L.k_stride = krow + 16;
    L.k = 0;
    L.v = align16(L.k + bk * L.k_stride);
    L.ks = align16(L.v + bk * vrow);
  }
  L.vs = align16(L.ks + F * bk);
  L.q = align16(L.vs + F * bk);
  L.s = align16(L.q + F * group * DK);                      // [group][bk]
  L.tmax = align16(L.s + F * group * bk);                   // [2][kMaxCluster][group]
  L.carry = align16(L.tmax + F * 2 * kMaxCluster * group);  // [group]
  L.part = align16(L.carry + F * group);                    // [group][DV + 1]
  // rank 0's running state: m (two buffers), l, acc
  L.m = align16(L.part + F * group * (DV + 1));  // [2][group]
  L.l = align16(L.m + F * 2 * group);            // [group]
  L.acc = align16(L.l + F * group);              // [group][DV]
  L.total = L.acc + F * group * DV;
  return L;
}

template <typename KV, int DK, int DV, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(const void* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ lens, void* __restrict__ out, int Hkv, int n_group,
              int gpart, int S, int bk, int CL, float scale, int act_dtype, int dq, int dv,
              RowBytes rb) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr bool SPLIT = split_tile<DK, DV>();
  static_assert(!SPLIT || DK == DV, "split tiles at DK == DV only");
  constexpr int kDepth = split_depth<DK>();  // K features a step (split tiles)
  static_assert(DK % kDepth == 0 || !SPLIT, "the split depth steps skip K features");
  constexpr int kKRow = DK * static_cast<int>(sizeof(KV));  // bytes of a staged K row
  constexpr int kVRow = DV * static_cast<int>(sizeof(KV));  // bytes of a staged V row
  constexpr int kDepthBytes = kDepth * static_cast<int>(sizeof(KV));
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<KV, DK, DV>(gpart, bk);
  const int g0 = blockIdx.y * gpart;          // this part's first query row
  const int group = min(gpart, n_group - g0);  // and its rows
  unsigned char* k_s = smem + L.k;
  const KV* v_s = reinterpret_cast<const KV*>(smem + L.v);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // matched by cluster_wait before the first remote store
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / CL;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int length = min(lens[b], S);
  const int n_act = (length + bk - 1) / bk;          // tiles the walk reads
  const int rounds = max(1, (n_act + CL - 1) / CL);  // the same on every rank
  const int64_t row0 = static_cast<int64_t>(bh) * S;

  // one commit group each, empty past the walk, so every thread counts alike;
  // a tile's rows to its end (or S), past the length too: the plain version
  // weighs them 0 into its value product, so a NaN there reaches the output
  const auto copy_k = [&](int t) {
    if (t < n_act) {
      const int c0 = t * bk, nr = min(bk, S - c0);
      const int64_t r = row0 + c0;
      copy_rows_async(k_s, L.k_stride, reinterpret_cast<const unsigned char*>(k) + r * rb.k,
                      nr, rb.k, kKRow, rb.piece);
      if (QUANT) {
        for (int j = tid; j < nr; j += kThreads) cp_async4(ks_s + j, ks + r + j);
      }
    }
    cp_async_commit();
  };
  const auto copy_v = [&](int t) {
    if (t < n_act) {
      const int c0 = t * bk, nr = min(bk, S - c0);
      const int64_t r = row0 + c0;
      copy_rows_async(smem + L.v, kVRow, reinterpret_cast<const unsigned char*>(v) + r * rb.v,
                      nr, rb.v, rb.v, rb.piece);
      if (QUANT) {
        for (int j = tid; j < nr; j += kThreads) cp_async4(vs_s + j, vs + r + j);
      }
    }
    cp_async_commit();
  };
  // split tiles: step g of the walk (a round's D / kDepth K chunks, then its
  // V sub-tiles) into buffer g % 2, one commit group each; the first K
  // chunk brings both scale rows of the tile
  constexpr int kChunks = DK / kDepth;
  const int n_steps = kChunks + (bk + kSubRows - 1) / kSubRows;  // a round's
  const auto step_buf = [&](int g) { return smem + (g & 1) * L.v; };
  const auto copy_step = [&](int g) {
    const int t = (g / n_steps) * CL + rank, st = g % n_steps;
    if (t < n_act) {
      const int c0 = t * bk, nr = min(bk, S - c0);
      const int64_t r = row0 + c0;
      if (st < kChunks) {
        // the chunk's features below D, zeros to its end
        const unsigned char* src = reinterpret_cast<const unsigned char*>(k) + r * rb.k;
        const int d0 = st * kDepthBytes;
        const int kb = max(0, min(kDepthBytes, rb.k - d0));
        const int64_t row = rb.k;
        copy_rows_async_at(step_buf(g), L.k_stride, nr, kb, kDepthBytes,
                           piece_of(rb.piece | d0 | L.k_stride | kb),
                           [=](int j) { return src + j * row + d0; });
        if (QUANT && st == 0) {
          for (int j = tid; j < nr; j += kThreads) {
            cp_async4(ks_s + j, ks + r + j);
            cp_async4(vs_s + j, vs + r + j);
          }
        }
      } else {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(v) + r * rb.v;
        const int j0 = (st - kChunks) * kSubRows;
        if (j0 < nr)
          copy_rows_async(step_buf(g), kVRow, src + static_cast<int64_t>(j0) * rb.v,
                          min(kSubRows, nr - j0), rb.v, rb.v, rb.piece);
      }
    }
    cp_async_commit();
  };
  int g = 0;  // split tiles: the step in flight or being computed on

  // the first round's K and V in flight while q is read
  if constexpr (SPLIT) {
    copy_step(0);
  } else {
    copy_k(rank);
    copy_v(rank);
  }
  for (int e = tid; e < group * DK; e += kThreads) {
    const int i = e / DK, d = e - i * DK;
    q_s[e] = d < dq ? load_act(q, (static_cast<int64_t>(bh) * n_group + g0 + i) * dq + d,
                               act_dtype)
                    : 0.0f;
  }
  for (int i = tid; i < group; i += kThreads) {
    carry_s[i] = kMaskValue;
    m_s[i] = kMaskValue;
    l_s[i] = 0.0f;
  }
  for (int i = tid; i < group * DV; i += kThreads) acc_s[i] = 0.0f;

  for (int round = 0; round < rounds; ++round) {
    const int t = round * CL + rank;
    const int nr = t < n_act ? min(bk, S - t * bk) : 0;      // rows staged
    const int nv = t < n_act ? min(bk, length - t * bk) : 0;  // those below the length
    float* tmax_s = reinterpret_cast<float*>(smem + L.tmax) + (round & 1) * kMaxCluster * group;

    // 1. the scores of this rank's tile and its row maxima, to every rank
    if constexpr (SPLIT) {
      // each column's chain over the depth, kDepth features a step
      for (int c = 0; c < kChunks; ++c, ++g) {
        copy_step(g + 1);
        cp_async_wait<1>();  // this step's rows landed; the next may be in flight
        __syncthreads();
        for (int j = tid; j < nr; j += kThreads) {
          float kr[kDepth];
          const KV* krow = reinterpret_cast<const KV*>(step_buf(g) + j * L.k_stride);
#pragma unroll
          for (int d = 0; d < kDepth; d += 4) {
            const float4 x = load4<KV>(krow + d);
            kr[d] = x.x;
            kr[d + 1] = x.y;
            kr[d + 2] = x.z;
            kr[d + 3] = x.w;
          }
          const float ksj = QUANT ? ks_s[j] : 1.0f;
          for (int i = 0; i < group; ++i) {
            const float4* qr = reinterpret_cast<const float4*>(q_s + i * DK + c * kDepth);
            float dot = c == 0 ? 0.0f : s_s[i * bk + j];
#pragma unroll
            for (int d = 0; d < kDepth; d += 4) {
              const float4 qd = qr[d / 4];
              dot = fmaf(qd.x, kr[d], dot);
              dot = fmaf(qd.y, kr[d + 1], dot);
              dot = fmaf(qd.z, kr[d + 2], dot);
              dot = fmaf(qd.w, kr[d + 3], dot);
            }
            if (c + 1 < kChunks) {
              s_s[i * bk + j] = dot;
            } else {
              float sc = dot * scale;
              if (QUANT) sc *= ksj;
              s_s[i * bk + j] = j < nv ? sc : kMaskValue;
            }
          }
        }
        __syncthreads();  // the step's readers are done
      }
    } else {
      cp_async_wait<1>();  // K landed; V may still be in flight
      __syncthreads();
      // one thread a column; its row in registers up to 64 features, above
      // that read from shared memory for each query row (the same chain)
      constexpr bool kHold = DK <= 64;
      for (int j = tid; j < nr; j += kThreads) {
        [[maybe_unused]] float kr[kHold ? DK : 1];
        const KV* krow = reinterpret_cast<const KV*>(k_s + j * L.k_stride);
        if constexpr (kHold) {
#pragma unroll
          for (int d = 0; d < DK; d += 4) {
            const float4 x = load4<KV>(krow + d);
            kr[d] = x.x;
            kr[d + 1] = x.y;
            kr[d + 2] = x.z;
            kr[d + 3] = x.w;
          }
        }
        const float ksj = QUANT ? ks_s[j] : 1.0f;
        for (int i = 0; i < group; ++i) {
          const float4* qr = reinterpret_cast<const float4*>(q_s + i * DK);
          float dot = 0.0f;
#pragma unroll
          for (int d = 0; d < DK; d += 4) {
            const float4 qd = qr[d / 4];
            if constexpr (kHold) {
              dot = fmaf(qd.x, kr[d], dot);
              dot = fmaf(qd.y, kr[d + 1], dot);
              dot = fmaf(qd.z, kr[d + 2], dot);
              dot = fmaf(qd.w, kr[d + 3], dot);
            } else {
              const float4 x = load4<KV>(krow + d);
              dot = fmaf(qd.x, x.x, dot);
              dot = fmaf(qd.y, x.y, dot);
              dot = fmaf(qd.z, x.z, dot);
              dot = fmaf(qd.w, x.w, dot);
            }
          }
          float sc = dot * scale;
          if (QUANT) sc *= ksj;
          s_s[i * bk + j] = j < nv ? sc : kMaskValue;
        }
      }
      __syncthreads();  // the K readers are done
      copy_k(t + CL);   // the next round's K
    }
    if (round == 0) cluster_wait();
    for (int i = warp; i < group; i += kWarps) {
      float mx = kMaskValue;  // a tile past the length: the mask value
      for (int j = lane; j < nr; j += kWarp) mx = max_nan(mx, s_s[i * bk + j]);
      mx = warp_max(mx);
      if (lane < CL) *cluster.map_shared_rank(tmax_s + rank * group + i, lane) = mx;
    }
    cluster.sync();

    // 2. the weights from the prefix maximum, psum_t and dsum_t into part_s
    if constexpr (!SPLIT) {
      cp_async_wait<1>();  // V landed; the next K may still be in flight
      __syncthreads();
    }
    if (nr > 0) {
      for (int i = warp; i < group; i += kWarps) {
        float m = carry_s[i];
        for (int u = 0; u <= rank; ++u) m = max_nan(m, tmax_s[u * group + i]);
        float ps = 0.0f;
        for (int j = lane; j < nr; j += kWarp) {
          const float p = j < nv ? softmax_weight<EXPMUL>(s_s[i * bk + j], m) : 0.0f;
          s_s[i * bk + j] = QUANT ? p * vs_s[j] : p;  // the weight the values take
          ps += p;
        }
        ps = warp_sum(ps);
        if (lane == 0) part_s[i * (DV + 1) + DV] = ps;
      }
      __syncthreads();  // the weights are in place
    }
    if constexpr (SPLIT) {
      // one thread a (row, feature): its chain over the columns in order,
      // kSubRows columns a step
      for (int sub = 0; sub < n_steps - kChunks; ++sub, ++g) {
        copy_step(g + 1);
        cp_async_wait<1>();
        __syncthreads();
        const int c0 = sub * kSubRows, nc = min(kSubRows, nr - c0);
        const KV* vb = reinterpret_cast<const KV*>(step_buf(g));
        for (int e = tid; nc > 0 && e < group * dv; e += kThreads) {
          const int i = e / dv, d = e - i * dv;
          const float* wr = s_s + i * bk + c0;
          float ds = c0 == 0 ? 0.0f : part_s[i * (DV + 1) + d];
#pragma unroll 8
          for (int j = 0; j < nc; ++j) ds = fmaf(wr[j], to_f32(vb[j * DV + d]), ds);
          part_s[i * (DV + 1) + d] = ds;
        }
        __syncthreads();  // the step's readers are done
      }
    } else if (nr > 0) {
      // one thread a (row, 4 features): fmaf chains over the columns in
      // order, for the features below dv
      const int dv4 = (dv + 3) / 4;
      for (int e = tid; e < group * dv4; e += kThreads) {
        const int i = e / dv4, d4 = (e - i * dv4) * 4;
        const float* wr = s_s + i * bk;
        const KV* vc = v_s + d4;
        float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
        for (int j = 0; j < nr; ++j) {
          const float4 vv = load4<KV>(vc + j * DV);
          const float w = wr[j];
          ds[0] = fmaf(w, vv.x, ds[0]);
          ds[1] = fmaf(w, vv.y, ds[1]);
          ds[2] = fmaf(w, vv.z, ds[2]);
          ds[3] = fmaf(w, vv.w, ds[3]);
        }
        float* dst = part_s + i * (DV + 1) + d4;
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = ds[u];
      }
    }
    if constexpr (!SPLIT) __syncthreads();  // the V and carry readers are done
    for (int i = tid; i < group; i += kThreads) {
      float c = carry_s[i];
      for (int u = 0; u < CL; ++u) c = max_nan(c, tmax_s[u * group + i]);
      carry_s[i] = c;
    }
    if constexpr (!SPLIT) copy_v(t + CL);  // the next round's V
    cluster.sync();  // every partial of the round is in place

    // 3. rank 0 folds the round's tiles in order: one thread an output
    // (i, d); the thread of d = 0 also folds l and passes m on to the
    // other buffer, which the next round reads
    if (rank == 0) {
      const int n_here = min(CL, n_act - round * CL);
      const float* m_in = m_s + (round & 1) * group;
      float* m_out = m_s + ((round + 1) & 1) * group;
      for (int e = tid; e < group * dv; e += kThreads) {
        const int i = e / dv, d = e - i * dv;
        float ds[kMaxCluster], ps[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < n_here) {
            const float* pr = cluster.map_shared_rank(part_s, r) + i * (DV + 1);
            ds[r] = pr[d];
            if (d == 0) ps[r] = pr[DV];
          }
        }
        float m = m_in[i], l = l_s[i], acc = acc_s[i * DV + d];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < n_here) {
            const float m_new = max_nan(m, tmax_s[r * group + i]);
            const float f = rescale_factor<EXPMUL>(m, m_new);
            acc = rescale<EXPMUL>(acc, f) + ds[r];
            if (d == 0) l = rescale<EXPMUL>(l, f) + ps[r];
            m = m_new;
          }
        }
        acc_s[i * DV + d] = acc;
        if (d == 0) {
          l_s[i] = l;
          m_out[i] = m;
        }
      }
    }
  }

  if (rank == 0) {
    __syncthreads();  // every row's l is in place
    for (int e = tid; e < group * dv; e += kThreads) {
      const int i = e / dv, d = e - i * dv;
      const float l = l_s[i];
      store_act(out, (static_cast<int64_t>(bh) * n_group + g0 + i) * dv + d,
                acc_s[i * DV + d] / (l == 0.0f ? 1.0f : l), act_dtype);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its partials
}

template <typename KV, int DK, int DV>
int smem_bytes(int group, int bk) {
  return layout<KV, DK, DV>(group, bk).total;
}

// query rows a CTA takes: the most (<= kMaxGroup) whose layout fits a CTA,
// shared out evenly over the fewest parts; 0 if none fits
template <typename KV, int DK, int DV>
int part_rows(int group, int bk) {
  int most = group < kMaxGroup ? group : kMaxGroup;
  while (most > 0 && smem_bytes<KV, DK, DV>(most, bk) > kMaxSmem) --most;
  if (most == 0) return 0;
  const int parts = (group + most - 1) / most;
  return (group + parts - 1) / parts;
}

// the shared memory a CTA takes at a group's part; -1 where none fits
template <typename KV, int DK, int DV>
int part_smem(int group, int bk) {
  const int gpart = part_rows<KV, DK, DV>(group, bk);
  return gpart > 0 ? smem_bytes<KV, DK, DV>(gpart, bk) : -1;
}

template <typename KV, int DK, int DV, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* lens, void* out, int B, int Hkv, int group, int S, int bk, float scale,
           int act_dtype, int dq, int dv, cudaStream_t stream) {
  const int T = (S + bk - 1) / bk;  // the walk's tiles at a length of S
  const int CL = T < kMaxCluster ? T : kMaxCluster;
  const int gpart = part_rows<KV, DK, DV>(group, bk);
  if (gpart == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<KV, DK, DV>(gpart, bk);
  auto kernel = decode_kernel<KV, DK, DV, EXPMUL>;
  static int granted = 48 * 1024;  // per instantiation
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const int kb = dq * static_cast<int>(sizeof(KV)), vb = dv * static_cast<int>(sizeof(KV));
  const RowBytes rb{kb, vb,
                    piece_of(reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                             static_cast<uintptr_t>(kb) | static_cast<uintptr_t>(vb))};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * CL, (group + gpart - 1) / gpart);
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
      &cfg, kernel, q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, lens, out,
      Hkv, group, gpart, S, bk, CL, scale, act_dtype, dq, dv, rb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The build a call at (D, Dv) runs: (96, 64) for float KV at 64 < D <= 96
// and Dv <= 64 (MLA's expanded latents), else the narrowest square width
// holding both; {0, 0} past kMaxHeadDim.
template <typename KV>
Dims built_dims(int D, int Dv) {
  if (!IsCode<KV>::value && D > 64 && D <= 96 && Dv <= 64) return Dims{96, 64};
  const int w = square_width(D > Dv ? D : Dv);
  return Dims{w, w};
}

}  // namespace

namespace decode_part {

// one call of the C entry contiguous_decode, as the parts pass it on
struct Call {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* lens;
  void* out;
  int B, Hkv, group, D, Dv, S, bk;
  float scale;
  int expmul, act_dtype;
  cudaStream_t stream;
};

// each KV dtype's launches, defined in that dtype's part of the build
int run_f32(const Call& c);
int run_bf16(const Call& c);
int run_i8(const Call& c);
int run_fp8(const Call& c);

}  // namespace decode_part

namespace {

using decode_part::Call;

template <typename KV>
int by_dims(const Call& c) {
#define REPRO_LAUNCH(DK, DV)                                                                  \
  return c.expmul ? launch<KV, DK, DV, true>(c.q, c.k, c.v, c.ks, c.vs, c.lens, c.out, c.B,  \
                                             c.Hkv, c.group, c.S, c.bk, c.scale,             \
                                             c.act_dtype, c.D, c.Dv, c.stream)               \
                  : launch<KV, DK, DV, false>(c.q, c.k, c.v, c.ks, c.vs, c.lens, c.out, c.B, \
                                              c.Hkv, c.group, c.S, c.bk, c.scale,            \
                                              c.act_dtype, c.D, c.Dv, c.stream)
  const Dims w = built_dims<KV>(c.D, c.Dv);
  if constexpr (!IsCode<KV>::value) {
    if (w.k == 96 && w.v == 64) REPRO_LAUNCH(96, 64);
  }
  switch (w.k) {
    case 16: REPRO_LAUNCH(16, 16);
    case 32: REPRO_LAUNCH(32, 32);
    case 64: REPRO_LAUNCH(64, 64);
    case 112: REPRO_LAUNCH(112, 112);
    case 128: REPRO_LAUNCH(128, 128);
    case 256: REPRO_LAUNCH(256, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

template <typename KV>
long long smem_by_dims(int D, int Dv, int group, int bk) {
  const Dims w = built_dims<KV>(D, Dv);
  if constexpr (!IsCode<KV>::value) {
    if (w.k == 96 && w.v == 64) return static_cast<long long>(part_smem<KV, 96, 64>(group, bk));
  }
  switch (w.k) {
    case 16: return static_cast<long long>(part_smem<KV, 16, 16>(group, bk));
    case 32: return static_cast<long long>(part_smem<KV, 32, 32>(group, bk));
    case 64: return static_cast<long long>(part_smem<KV, 64, 64>(group, bk));
    case 112: return static_cast<long long>(part_smem<KV, 112, 112>(group, bk));
    case 128: return static_cast<long long>(part_smem<KV, 128, 128>(group, bk));
    case 256: return static_cast<long long>(part_smem<KV, 256, 256>(group, bk));
    default: return -1;
  }
}

bool dims_ok(int D, int Dv, int group) {
  return D > 0 && D <= kMaxHeadDim && Dv > 0 && Dv <= kMaxHeadDim && group > 0;
}

}  // namespace

#if REPRO_IN_PART(REPRO_PART_F32)
int decode_part::run_f32(const Call& c) { return by_dims<float>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_BF16)
int decode_part::run_bf16(const Call& c) { return by_dims<__nv_bfloat16>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_I8)
int decode_part::run_i8(const Call& c) { return by_dims<int8_t>(c); }
#endif
#if REPRO_IN_PART(REPRO_PART_FP8)
int decode_part::run_fp8(const Call& c) { return by_dims<__nv_fp8_e4m3>(c); }
#endif

#if REPRO_IN_PART(REPRO_PART_F32)
// q (B*Hkv, group, D) f32/bf16; caches k (B*Hkv, S, D) and v (B*Hkv, S, Dv)
// of kv_dtype; scale rows ks/vs (B*Hkv, S) f32 for codes (else unused); lens
// (B,) i32, the tokens to attend (columns >= min(len, S) are masked); bk the
// KV tile width (<= kMaxTile); out (B*Hkv, group, Dv) in q's dtype. D and Dv
// in [1, 256], any group >= 1. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue past those limits, for an unknown KV dtype, or
// where one tile would not fit in a CTA's shared memory: float32 caches at
// bk = 512; never at the wrapper's bk <= 256).
extern "C" int contiguous_decode(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, const int* lens, void* out, int B, int Hkv,
                                 int group, int D, int Dv, int S, int bk, float scale,
                                 int expmul, int act_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || !dims_ok(D, Dv, group) || S <= 0 || bk <= 0 || bk > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, k,     v,  ks, vs, lens,  out,    B,         Hkv,
               group, D, Dv, S, bk, scale, expmul, act_dtype, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kF32: return decode_part::run_f32(c);
    case kBF16: return decode_part::run_bf16(c);
    case kI8: return decode_part::run_i8(c);
    case kFP8: return decode_part::run_fp8(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that contiguous_decode gives each CTA
// at these arguments (independent of S; a group split into parts counts one
// part); -1 where it launches nothing.
extern "C" long long contiguous_decode_smem(int group, int D, int Dv, int bk, int kv_dtype) {
  if (!dims_ok(D, Dv, group) || bk <= 0 || bk > kMaxTile) return -1;
  switch (kv_dtype) {
    case kF32: return smem_by_dims<float>(D, Dv, group, bk);
    case kBF16: return smem_by_dims<__nv_bfloat16>(D, Dv, group, bk);
    case kI8: return smem_by_dims<int8_t>(D, Dv, group, bk);
    case kFP8: return smem_by_dims<__nv_fp8_e4m3>(D, Dv, group, bk);
    default: return -1;
  }
}
#endif
