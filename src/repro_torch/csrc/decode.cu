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
// folded, and a tile reads only its rows below the length: stale rows are
// never touched.
#include <cooperative_groups.h>

#include "tile_sm90.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxGroup = 32;      // query heads per KV head
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA can use

struct Layout {
  int k_stride;  // bytes between staged K rows (padded by 16)
  int k, v, ks, vs, q, s, tmax, carry, part, m, l, acc, total;  // byte offsets, size
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

template <typename KV, int D>
__host__ __device__ Layout layout(int group, int bk) {
  constexpr int F = sizeof(float);
  Layout L;
  const int row = D * static_cast<int>(sizeof(KV));
  L.k_stride = row + 16;
  L.k = 0;
  L.v = align16(L.k + bk * L.k_stride);
  L.ks = align16(L.v + bk * row);
  L.vs = align16(L.ks + F * bk);
  L.q = align16(L.vs + F * bk);
  L.s = align16(L.q + F * group * D);                       // [group][bk]
  L.tmax = align16(L.s + F * group * bk);                   // [2][kMaxCluster][group]
  L.carry = align16(L.tmax + F * 2 * kMaxCluster * group);  // [group]
  L.part = align16(L.carry + F * group);                    // [group][D + 1]
  // rank 0's running state: m (two buffers), l, acc
  L.m = align16(L.part + F * group * (D + 1));  // [2][group]
  L.l = align16(L.m + F * 2 * group);           // [group]
  L.acc = align16(L.l + F * group);             // [group][D]
  L.total = L.acc + F * group * D;
  return L;
}

template <typename KV, int D, bool EXPMUL>
__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(const void* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ lens, void* __restrict__ out, int Hkv, int group, int S,
              int bk, int CL, float scale, int act_dtype, int vec16) {
  constexpr bool QUANT = IsCode<KV>::value;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<KV, D>(group, bk);
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

  // one commit group each, empty past the walk, so every thread counts alike
  const auto copy_k = [&](int t) {
    if (t < n_act) {
      const int c0 = t * bk, nr = min(bk, length - c0);
      const int64_t r = row0 + c0;
      copy_rows_async(k_s, L.k_stride, reinterpret_cast<const unsigned char*>(k + r * D), nr,
                      kRowBytes, vec16);
      if (QUANT) {
        for (int j = tid; j < nr; j += kThreads) cp_async4(ks_s + j, ks + r + j);
      }
    }
    cp_async_commit();
  };
  const auto copy_v = [&](int t) {
    if (t < n_act) {
      const int c0 = t * bk, nr = min(bk, length - c0);
      const int64_t r = row0 + c0;
      copy_rows_async(smem + L.v, kRowBytes, reinterpret_cast<const unsigned char*>(v + r * D),
                      nr, kRowBytes, vec16);
      if (QUANT) {
        for (int j = tid; j < nr; j += kThreads) cp_async4(vs_s + j, vs + r + j);
      }
    }
    cp_async_commit();
  };

  // the first round's K and V in flight while q is read
  copy_k(rank);
  copy_v(rank);
  for (int i = tid; i < group * D; i += kThreads)
    q_s[i] = load_act(q, static_cast<int64_t>(bh) * group * D + i, act_dtype);
  for (int i = tid; i < group; i += kThreads) {
    carry_s[i] = kMaskValue;
    m_s[i] = kMaskValue;
    l_s[i] = 0.0f;
  }
  for (int i = tid; i < group * D; i += kThreads) acc_s[i] = 0.0f;

  for (int round = 0; round < rounds; ++round) {
    const int t = round * CL + rank;
    const int nr = t < n_act ? min(bk, length - t * bk) : 0;
    float* tmax_s = reinterpret_cast<float*>(smem + L.tmax) + (round & 1) * kMaxCluster * group;

    // 1. the scores of this rank's tile and its row maxima, to every rank
    cp_async_wait<1>();  // K landed; V may still be in flight
    __syncthreads();
    for (int j = tid; j < nr; j += kThreads) {
      float kr[D];
      const KV* krow = reinterpret_cast<const KV*>(k_s + j * L.k_stride);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 x = load4<KV>(krow + d);
        kr[d] = x.x;
        kr[d + 1] = x.y;
        kr[d + 2] = x.z;
        kr[d + 3] = x.w;
      }
      const float ksj = QUANT ? ks_s[j] : 1.0f;
      for (int i = 0; i < group; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + i * D);
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 qd = qr[d / 4];
          dot = fmaf(qd.x, kr[d], dot);
          dot = fmaf(qd.y, kr[d + 1], dot);
          dot = fmaf(qd.z, kr[d + 2], dot);
          dot = fmaf(qd.w, kr[d + 3], dot);
        }
        float sc = dot * scale;
        if (QUANT) sc *= ksj;
        s_s[i * bk + j] = sc;
      }
    }
    __syncthreads();  // the K readers are done
    copy_k(t + CL);   // the next round's K
    if (round == 0) cluster_wait();
    for (int i = warp; i < group; i += kWarps) {
      float mx = kMaskValue;  // a tile past the length: the mask value
      for (int j = lane; j < nr; j += kWarp) mx = fmaxf(mx, s_s[i * bk + j]);
      mx = warp_max(mx);
      if (lane < CL) *cluster.map_shared_rank(tmax_s + rank * group + i, lane) = mx;
    }
    cluster.sync();

    // 2. the weights from the prefix maximum, psum_t and dsum_t into part_s
    cp_async_wait<1>();  // V landed; the next K may still be in flight
    __syncthreads();
    if (nr > 0) {
      for (int i = warp; i < group; i += kWarps) {
        float m = carry_s[i];
        for (int u = 0; u <= rank; ++u) m = fmaxf(m, tmax_s[u * group + i]);
        float ps = 0.0f;
        for (int j = lane; j < nr; j += kWarp) {
          const float p = softmax_weight<EXPMUL>(s_s[i * bk + j], m);
          s_s[i * bk + j] = QUANT ? p * vs_s[j] : p;  // the weight the values take
          ps += p;
        }
        ps = warp_sum(ps);
        if (lane == 0) part_s[i * (D + 1) + D] = ps;
      }
      __syncthreads();  // the weights are in place
      // one thread a (row, 4 features): fmaf chains over the columns in order
      for (int e = tid; e < group * (D / 4); e += kThreads) {
        const int i = e / (D / 4), d4 = (e - i * (D / 4)) * 4;
        const float* wr = s_s + i * bk;
        const KV* vc = v_s + d4;
        float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
        for (int j = 0; j < nr; ++j) {
          const float4 vv = load4<KV>(vc + j * D);
          const float w = wr[j];
          ds[0] = fmaf(w, vv.x, ds[0]);
          ds[1] = fmaf(w, vv.y, ds[1]);
          ds[2] = fmaf(w, vv.z, ds[2]);
          ds[3] = fmaf(w, vv.w, ds[3]);
        }
        float* dst = part_s + i * (D + 1) + d4;
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = ds[u];
      }
    }
    __syncthreads();  // the V and carry readers are done
    for (int i = tid; i < group; i += kThreads) {
      float c = carry_s[i];
      for (int u = 0; u < CL; ++u) c = fmaxf(c, tmax_s[u * group + i]);
      carry_s[i] = c;
    }
    copy_v(t + CL);  // the next round's V
    cluster.sync();  // every partial of the round is in place

    // 3. rank 0 folds the round's tiles in order: one thread an output
    // (i, d); the thread of d = 0 also folds l and passes m on to the
    // other buffer, which the next round reads
    if (rank == 0) {
      const int n_here = min(CL, n_act - round * CL);
      const float* m_in = m_s + (round & 1) * group;
      float* m_out = m_s + ((round + 1) & 1) * group;
      for (int e = tid; e < group * D; e += kThreads) {
        const int i = e / D, d = e - i * D;
        float ds[kMaxCluster], ps[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < n_here) {
            const float* pr = cluster.map_shared_rank(part_s, r) + i * (D + 1);
            ds[r] = pr[d];
            if (d == 0) ps[r] = pr[D];
          }
        }
        float m = m_in[i], l = l_s[i], acc = acc_s[e];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < n_here) {
            const float m_new = fmaxf(m, tmax_s[r * group + i]);
            const float f = rescale_factor<EXPMUL>(m, m_new);
            acc = rescale<EXPMUL>(acc, f) + ds[r];
            if (d == 0) l = rescale<EXPMUL>(l, f) + ps[r];
            m = m_new;
          }
        }
        acc_s[e] = acc;
        if (d == 0) {
          l_s[i] = l;
          m_out[i] = m;
        }
      }
    }
  }

  if (rank == 0) {
    __syncthreads();  // every row's l is in place
    for (int e = tid; e < group * D; e += kThreads) {
      const float l = l_s[e / D];
      store_act(out, static_cast<int64_t>(bh) * group * D + e,
                acc_s[e] / (l == 0.0f ? 1.0f : l), act_dtype);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its partials
}

template <typename KV, int D>
int smem_bytes(int group, int bk) {
  return layout<KV, D>(group, bk).total;
}

template <typename KV, int D, bool EXPMUL>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* lens, void* out, int B, int Hkv, int group, int S, int bk, float scale,
           int act_dtype, cudaStream_t stream) {
  const int T = (S + bk - 1) / bk;  // the walk's tiles at a length of S
  const int CL = T < kMaxCluster ? T : kMaxCluster;
  const int smem = smem_bytes<KV, D>(group, bk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_kernel<KV, D, EXPMUL>;
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
      &cfg, kernel, q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, lens, out,
      Hkv, group, S, bk, CL, scale, act_dtype, vec16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int by_dim(int D, int expmul, const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* lens, void* out, int B, int Hkv, int group, int S,
           int bk, float scale, int act_dtype, cudaStream_t s) {
#define REPRO_LAUNCH(DIM)                                                                 \
  return expmul ? launch<KV, DIM, true>(q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, \
                                        scale, act_dtype, s)                             \
                : launch<KV, DIM, false>(q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, \
                                         scale, act_dtype, s)
  switch (D) {
    case 16: REPRO_LAUNCH(16);
    case 64: REPRO_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
}

template <typename KV>
long long smem_by_dim(int D, int group, int bk) {
  switch (D) {
    case 16: return static_cast<long long>(smem_bytes<KV, 16>(group, bk));
    case 64: return static_cast<long long>(smem_bytes<KV, 64>(group, bk));
    default: return -1;
  }
}

}  // namespace

// q (B*Hkv, group, D) f32/bf16; caches k/v (B*Hkv, S, D) of kv_dtype; scale
// rows ks/vs (B*Hkv, S) f32 for codes (else unused); lens (B,) i32, the
// tokens to attend (columns >= min(len, S) are masked); bk the KV tile width
// (<= kMaxTile); out (B*Hkv, group, D) in q's dtype. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue where one tile would not fit in a
// CTA's shared memory: float32 caches at bk = 512; never at the wrapper's
// bk <= 256).
extern "C" int contiguous_decode(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, const int* lens, void* out, int B, int Hkv,
                                 int group, int D, int S, int bk, float scale, int expmul,
                                 int act_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || group <= 0 || group > kMaxGroup || S <= 0 || bk <= 0 ||
      bk > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return by_dim<float>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk, scale,
                           act_dtype, s);
    case kBF16:
      return by_dim<__nv_bfloat16>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S,
                                   bk, scale, act_dtype, s);
    case kI8:
      return by_dim<int8_t>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S, bk,
                            scale, act_dtype, s);
    case kFP8:
      return by_dim<__nv_fp8_e4m3>(D, expmul, q, k, v, ks, vs, lens, out, B, Hkv, group, S,
                                   bk, scale, act_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, that contiguous_decode gives each CTA
// at these arguments (independent of S); -1 for an unsupported D or dtype.
extern "C" long long contiguous_decode_smem(int group, int D, int bk, int kv_dtype) {
  switch (kv_dtype) {
    case kF32: return smem_by_dim<float>(D, group, bk);
    case kBF16: return smem_by_dim<__nv_bfloat16>(D, group, bk);
    case kI8: return smem_by_dim<int8_t>(D, group, bk);
    case kFP8: return smem_by_dim<__nv_fp8_e4m3>(D, group, bk);
    default: return -1;
  }
}
