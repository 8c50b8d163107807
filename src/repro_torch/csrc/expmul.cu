// The standalone ExpMul operator: out[r, c] = e^{x[r]} * v[r, c] under the
// paper's log2 quantization, by integer arithmetic only (no exp, no float
// multiply).
//
// Replaces the Pallas TPU kernel kernels/expmul/expmul.py:57 (expmul_pallas,
// body _expmul_kernel at :29).
//
// What it computes, per row: xc = clamp(x, -15, 0), xfix = round-half-even
// (xc * 1024) (exact: a power-of-two scale), acc = xfix + (xfix >> 1) -
// (xfix >> 4) with arithmetic shifts, lhat = (512 - acc) >> 10. Per element:
// lhat is subtracted from the 8-bit exponent field (bit 23 of a float32, bit
// 7 of a bfloat16); where the new exponent is <= 0 every bit of the result
// is 0 (underflow, denormals and -0 become +0), else sign and mantissa are
// kept. This is the bit path of numerics/log2exp.py, not a multiply by
// 2^-lhat: a multiply would keep denormals, infinities and the sign of a
// flushed -0, which the reference does not.
//
// What bounds it on the card: bytes. Each element is read once and written
// once (4 + 4 bytes in float32, 2 + 2 in bfloat16, plus 4 bytes of x per
// row) for a dozen integer operations, far below the H100's ~295 operations
// per byte.
//
// Design: the (256, 256) tiles of the Pallas grid change no value (the
// operator is elementwise), so the grid here is the card's: a flat,
// grid-stride walk over vectors of W elements, 16 bytes each when the row
// width and both pointers allow it (W = 4 float32 or 8 bfloat16: every
// vector then lies in one row), else W = 1, which takes any width d >= 1
// (d = 65: the merged [l, o] rows of Eq. 5 are misaligned for vectors).
// A thread loads kUnroll vectors before it stores any, so a 4-byte path
// too keeps enough bytes in flight to cover the memory's latency. Each
// thread finds its first vector's (row, column) by one division, then
// steps it by the grid stride's quotient and remainder, carrying the column
// into the row: no division in the loop. lhat is recomputed from x[row]
// per vector: a few integer operations against 16 bytes of traffic.
//
// Outside the contract (finite inputs), as the reference: a NaN x gives
// lhat 0 (log2exp_lhat's guard), so v comes out as for x = 0.
#include "tile.cuh"  // log2exp_lhat, the dtype codes

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kUnroll = 4;

// The exponent-field subtraction on the raw bits of one element: U is
// uint32_t (float32, mantissa 23 bits) or uint16_t (bfloat16, 7 bits).
template <typename U>
__device__ __forceinline__ U pow2_scale_bits(U bits, int lhat) {
  constexpr int kMant = sizeof(U) == 4 ? 23 : 7;
  constexpr uint32_t kExpMask = 0xFFu << kMant;
  const uint32_t b = bits;
  const int e = static_cast<int>((b >> kMant) & 0xFFu) - lhat;
  if (e <= 0) return 0;
  return static_cast<U>((b & ~kExpMask) | (static_cast<uint32_t>(e) << kMant));
}

template <typename U, int W>
struct alignas(sizeof(U) * W) Vec {
  U v[W];
};

// x (rows,) float32; v, out (rows, d) of U's width; W elements a vector,
// nv = d / W vectors a row; (q_step, r_step) = divmod(grid stride, nv).
// Each thread takes kUnroll vectors one grid stride apart per trip, their
// loads issued before any store, so that enough bytes are in flight even
// with 4-byte vectors (W = 1).
template <typename U, int W>
__global__ void __launch_bounds__(kThreads)
expmul_kernel(const float* __restrict__ x, const U* __restrict__ v, U* __restrict__ out,
              int64_t n_vec, int64_t nv, int64_t q_step, int64_t r_step) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_vec) return;
  int64_t row = j / nv, col = j - row * nv;
  const Vec<U, W>* vin = reinterpret_cast<const Vec<U, W>*>(v);
  Vec<U, W>* vout = reinterpret_cast<Vec<U, W>*>(out);
  for (; j < n_vec; j += kUnroll * stride) {
    Vec<U, W> t[kUnroll];
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * stride < n_vec) {
        t[u] = vin[j + u * stride];
        xs[u] = __ldg(x + row);
      }
      row += q_step;  // the (row, column) of the vector one stride on
      col += r_step;
      if (col >= nv) {
        col -= nv;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * stride < n_vec) {
        const int lhat = log2exp_lhat(xs[u]);
#pragma unroll
        for (int i = 0; i < W; ++i) t[u].v[i] = pow2_scale_bits<U>(t[u].v[i], lhat);
        vout[j + u * stride] = t[u];
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename U, int W>
int launch(const float* x, const void* v, void* out, int64_t rows, int64_t d,
           cudaStream_t stream) {
  const int64_t nv = d / W;
  const int64_t n_vec = rows * nv;
  const int64_t want = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSM;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const int64_t stride = static_cast<int64_t>(blocks) * kThreads;
  expmul_kernel<U, W><<<blocks, kThreads, 0, stream>>>(
      x, static_cast<const U*>(v), static_cast<U*>(out), n_vec, nv, stride / nv,
      stride % nv);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int by_width(const float* x, const void* v, void* out, int64_t rows, int64_t d,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(U);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned ? launch<U, kVec>(x, v, out, rows, d, stream)
                 : launch<U, 1>(x, v, out, rows, d, stream);
}

}  // namespace

// x (rows,) float32; v and out (rows, d), contiguous, of `dtype` (kF32 or
// kBF16); rows, d >= 1. Returns the cudaError_t of the launch.
extern "C" int expmul_forward(const void* x, const void* v, void* out, int64_t rows,
                              int64_t d, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  switch (dtype) {
    case kF32:
      return by_width<uint32_t>(xf, v, out, rows, d, s);
    case kBF16:
      return by_width<uint16_t>(xf, v, out, rows, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
