// imc_mav: one ±1 product tile of the IMC macro with its sense-amplifier
// epilogue, the per-group layer of the KWS net.
//
// Replaces the Pallas TPU kernel `imc_mav` (src/repro/kernels/imc_mav/
// imc_mav.py:67, with `_mav_kernel` and `_mav_kernel_noise`).  Same
// function, not the same blocks:
//
//   counts[m, n] = sum over k of x[m, k] * w[k, n]      (fp32 accumulate)
//   pre  = (counts + bias[n]) [+ noise[m, n]]           (fp32, this order)
//   out  = (pre * flip[n]) >= 0 ? +1 : -1               (-0.0 gives +1)
//
// x and w are ±1 in float32 or bfloat16 (the output takes x's type); bias,
// flip and noise are float32.  Every partial sum of ±1 products is a small
// integer, so fp32 accumulation is exact in any order, and the epilogue
// adds in the reference's order with rounding spelled out (__fadd_rn,
// __fmul_rn; the build also passes --fmad=false), which keeps the result
// bit-identical to the plain version (../ref.py::imc_mav_ref).  The TPU
// kernel's 256 x 128 tiles and the wrapper's zero padding are layout, not
// semantics: this kernel guards its ragged edges instead.
//
// What bounds it on an H100: at the per-group layer's shapes (K = 72 = the
// macro fan-in, N = cog = 32..96 channels) it does 2*72 operations per
// output element for 4 bytes of patch input per product row, so it is bound
// by the bytes it moves (the materialized im2col patches dominate).  The
// design keeps each operand tile in shared memory (w's columns are strided
// in the (K, N) row-major layout, so both tiles are staged with coalesced
// row reads) and each thread's 4 x 4 outputs in registers; the products run
// on the CUDA cores.  Tensor-core products (±1 is exact in bf16 / int8)
// are later work.
//
// Layouts (contiguous, row-major):
//   x (M, K), w (K, N), bias / flip (N,), noise (M, N) or null, out (M, N).
// Grid: (ceil(N / 64), ceil(M / 64)); 256 threads, a 4 x 4 block of
// outputs each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;     // outputs per block along M and along N
constexpr int kDepth = 32;    // K staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_sign(bool positive);
template <>
__device__ __forceinline__ float from_sign<float>(bool positive) {
  return positive ? 1.f : -1.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_sign<__nv_bfloat16>(
    bool positive) {
  return __float2bfloat16_rn(positive ? 1.f : -1.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
imc_mav_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias,
               const float* __restrict__ flip,
               const float* __restrict__ noise, T* __restrict__ out, int M,
               int K, int N) {
  __shared__ float x_s[kDepth][kTile + 1];  // [k][m]
  __shared__ float w_s[kDepth][kTile];      // [k][n]
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // x tile: consecutive threads read consecutive k of one row
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kDepth, c = i % kDepth;
      const int m = m0 + r, k = k0 + c;
      x_s[c][r] = (m < M && k < K) ? to_float(x[(size_t)m * K + k]) : 0.f;
    }
    // w tile: consecutive threads read consecutive n of one row
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const int k = k0 + r, n = n0 + c;
      w_s[r][c] = (k < K && n < N) ? to_float(w[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < kDepth; ++q) {
      float xv[4], wv[4];
      for (int a = 0; a < 4; ++a) xv[a] = x_s[q][tm + 16 * a];
      for (int b = 0; b < 4; ++b) wv[b] = w_s[q][tn + 16 * b];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b)
          acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(xv[a], wv[b]));
    }
    __syncthreads();
  }
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + tm + 16 * a;
    if (m >= M) continue;
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tn + 16 * b;
      if (n >= N) continue;
      float pre = __fadd_rn(acc[a][b], bias[n]);
      if (noise != nullptr)
        pre = __fadd_rn(pre, noise[(size_t)m * N + n]);
      pre = __fmul_rn(pre, flip[n]);
      out[(size_t)m * N + n] = from_sign<T>(pre >= 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const float* flip,
           const float* noise, void* out, int M, int K, int N,
           void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  imc_mav_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, flip, noise,
      static_cast<T*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one product tile on `stream`; `bf16` selects bfloat16 x, w and
// out (else float32).  Returns cudaGetLastError() (0 = queued).
int imc_mav_launch(const void* x, const void* w, const float* bias,
                   const float* flip, const float* noise, void* out, int M,
                   int K, int N, int bf16, void* stream) {
  if (M == 0 || N == 0) return 0;
  return bf16 ? launch<__nv_bfloat16>(x, w, bias, flip, noise, out, M, K, N,
                                      stream)
              : launch<float>(x, w, bias, flip, noise, out, M, K, N, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
