// int8_matmul: the chip's 8-bit fixed-point FC datapath (paper §V-C).
//
// Replaces the Pallas TPU kernel `int8_matmul` (src/repro/kernels/
// int8_matmul/int8_matmul.py:34, body `_int8_kernel`).  Same function, not
// the same blocks:
//
//   acc = x @ w + bias                         (int32, wrapping as XLA's)
//   acc = (acc + 2^(shift-1)) >> shift         (only when shift > 0;
//                                               arithmetic shift)
//   out = clip(acc, -out_max - 1, out_max)     (int8)
//
// x (M, K) and w (K, N) are int8, bias (N,) int32.  The products run four
// at a time with __dp4a (int8 x int8 summed into an int32).  Sums are taken
// modulo 2^32 (the hardware's integer add), which is what XLA's int32
// adds give as well.  The bias and rounding adds are done in unsigned
// arithmetic and reinterpreted: a signed add that overflows would be
// undefined behaviour in C++, while the reference wraps.  nvcc's `>>` on a
// signed int is arithmetic, as XLA's shift-right-arithmetic is.
//
// What bounds it on an H100: at the FC head's shape (8 x 576 x 10) the
// work is a few kilobytes and 92 thousand operations, far below either
// roof, so launch latency sets the time; at 512 x 128 x 128 it does about
// 113 operations per byte it must move, under the int8 tensor-core ridge
// (about 590 operations per byte), so the floor is the bytes moved.  This
// first version stages a 64 x 128 tile of x and of w (transposed, so each
// output's four k values are one 32-bit word) in shared memory and keeps
// each thread's 4 x 4 accumulators in registers; the deep K step keeps the
// number of load / synchronise rounds small where a single block walks
// the whole fan-in (the FC head: 5 steps for K = 576).  The TPU kernel's
// 256 x 128 tiles and the wrapper's zero padding are layout, not
// semantics: this kernel zero-fills K to a multiple of 128 in shared memory
// and guards the ragged M and N edges.  int8 tensor-core (wgmma) tiles are
// later work.
//
// Layouts (contiguous, row-major): x (M, K), w (K, N), bias (N,),
// out (M, N).  Grid: (ceil(N / 64), ceil(M / 64)); 256 threads.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 128;         // K per step: 32 words of 4 int8
constexpr int kRow = kDepth + 4;    // padded shared row, 4-byte aligned
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const int32_t* __restrict__ bias, int8_t* __restrict__ out,
                   int M, int K, int N, int shift, int out_max) {
  __shared__ __align__(16) int8_t x_s[kTile][kRow];  // [m][k]
  __shared__ __align__(16) int8_t w_s[kTile][kRow];  // [n][k]
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kDepth, c = i % kDepth;
      const int m = m0 + r, k = k0 + c;
      x_s[r][c] = (m < M && k < K) ? x[(size_t)m * K + k] : int8_t(0);
    }
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const int k = k0 + r, n = n0 + c;
      w_s[c][r] = (k < K && n < N) ? w[(size_t)k * N + n] : int8_t(0);
    }
    __syncthreads();
    for (int q = 0; q < kDepth / 4; ++q) {
      int xv[4], wv[4];
      for (int a = 0; a < 4; ++a)
        xv[a] = reinterpret_cast<const int*>(x_s[tm + 16 * a])[q];
      for (int b = 0; b < 4; ++b)
        wv[b] = reinterpret_cast<const int*>(w_s[tn + 16 * b])[q];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) acc[a][b] = __dp4a(xv[a], wv[b],
                                                        acc[a][b]);
    }
    __syncthreads();
  }
  const int lo = -out_max - 1;
  const unsigned half = shift > 0 ? (1u << (shift - 1)) : 0u;
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + tm + 16 * a;
    if (m >= M) continue;
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tn + 16 * b;
      if (n >= N) continue;
      int v = (int)((unsigned)acc[a][b] + (unsigned)bias[n]);
      if (shift > 0) v = (int)((unsigned)v + half) >> shift;
      v = min(max(v, lo), out_max);
      out[(size_t)m * N + n] = (int8_t)v;
    }
  }
}

}  // namespace

extern "C" {

// Launches one product on `stream`; returns cudaGetLastError() (0 = queued).
int int8_matmul_launch(const int8_t* x, const int8_t* w, const int32_t* bias,
                       int8_t* out, int M, int K, int N, int shift,
                       int out_max, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  int8_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, bias, out, M, K, N, shift, out_max);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
