// int8_matmul: the chip's 8-bit fixed-point FC datapath (paper §V-C),
// designed for Hopper: int8 tensor-core tiles, and a split-K plan for the
// FC head's few outputs over a long fan-in.
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
// x (M, K) and w (K, N) are int8, bias (N,) int32.  Products run on the
// tensor cores (mma.sync m16n8k32 s8 x s8 -> s32).  Every product is at
// most 2^14 in magnitude, so the int32 sum cannot overflow below
// K = 2^17; beyond that it wraps modulo 2^32, as the reference's int32
// sum does.  Adds modulo 2^32 are associative and commutative, so partial
// sums may be combined in any order, bit for bit.  The bias and rounding
// adds are done in unsigned arithmetic and reinterpreted: a signed add that
// overflows would be undefined behaviour in C++, while the reference
// wraps.  nvcc's `>>` on a signed int is arithmetic, as XLA's
// shift-right-arithmetic is.  The TPU kernel's 256 x 128 tiles and the
// wrapper's zero padding are layout: this kernel zero-fills K to a
// multiple of 32 in shared memory and guards the M and N edges.
//
// What bounds it on an H100: at the FC head (8 x 576 x 10) the work is a
// few kilobytes and 92 thousand operations, far below either roof, so
// latency sets the time: a launch, the loads' round trip and the barriers.
// The first version had one 64 x 64 block (80 of its 4096 outputs live)
// walk the 576-deep fan-in in five serial steps, staging byte by byte.  At
// 512 x 128 x 128 the floor is the bytes (about 113 operations per byte,
// under the int8 tensor cores' ridge of about 590).  The launch picks one
// of two plans by shape (`plan_split`):
//
// * Split K (few outputs: at most kSplitTiles blocks of 16 x 16, K over
//   128): a block holds a 16 x 16 output tile and its eight warps take
//   every eighth 32-deep k-step of up to 1024 staged at once; the warps'
//   int32 partial sums meet in shared memory (atomic adds, exact in any
//   order).  The head is one block, one staging round, three barriers.
// * Tiled: a 64 x 64 output tile per block, a warp per 16 x 32 of it,
//   walking K in 128-deep steps.
//
// Both stage with 16-byte asynchronous copies (cp.async): x rows as they
// are (k-contiguous A rows), w rows raw (the whole K x N chunk as one range
// where the tile spans all N), then transposed once in shared memory into
// k-contiguous B rows, zero past K.  Where a row is not 16-byte aligned
// (K or N not a multiple of 16) it is copied byte by byte.  Fragments use
// the k-step permutation of imc_fused.cu (thread t of a quad takes bytes
// t*8..t*8+7), so each fragment half is one 8-byte shared-memory load.
// The tile's bias is loaded at the start and staged before the epilogue,
// which reads the tile's counts from shared memory and writes 16 outputs
// with one 16-byte store where N % 16 == 0.
//
// Layouts (contiguous, row-major): x (M, K), w (K, N), bias (N,),
// out (M, N).  Grid: (ceil(M / TM), ceil(N / TN)); 256 threads.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 32;           // bytes of one int8 k-step
constexpr int kSplitTiles = 16;     // most 16 x 16 tiles the split plan takes

// The smallest pitch >= `bytes` (a multiple of 32) whose word count puts
// rows 0..3 on disjoint 8-word bank windows.
constexpr int row_pitch(int bytes) {
  return (bytes / 4) % 32 == 0 || (bytes / 4) % 32 == 16 ? bytes + 32
                                                          : bytes;
}

// A plan's block: a TM x TN output tile, warps arranged WM x WN over it
// (one m16 tile, TN / WN / 8 n-tiles each) and WK ways over K, K staged
// KC at a time.
template <int TM_, int TN_, int WM_, int WN_, int WK_, int KC_>
struct Plan {
  static constexpr int TM = TM_, TN = TN_, WM = WM_, WN = WN_, WK = WK_;
  static constexpr int KC = KC_;
  static constexpr int NT = TN / WN / 8;           // n-tiles per warp
  static constexpr int XP = row_pitch(KC);         // A row pitch (bytes)
  static constexpr int WP = row_pitch(KC);         // B row pitch (bytes)
  static constexpr int RP = TN + 16;               // raw w row pitch
  static constexpr int CP = TN + 8;                // count row pitch (words)
  static constexpr int XS = 0;
  static constexpr int WR = XS + TM * XP;
  static constexpr int WS = WR + KC * RP;
  static constexpr int CS = WS + TN * WP;
  static constexpr int BS = CS + TM * CP * 4;
  static constexpr int BYTES = BS + TN * 4;
  static_assert(TM == 16 * WM && WM * WN * WK == kWarps && TN <= kThreads,
                "block layout");
};

using Tiled = Plan<64, 64, 4, 2, 1, 128>;
using Split = Plan<16, 16, 1, 1, 8, 1024>;

int plan_split(int M, int K, int N) {
  return K > Tiled::KC &&
         (long long)((M + 15) / 16) * ((N + 15) / 16) <= kSplitTiles;
}

struct Params {
  const int8_t* x;
  const int8_t* w;
  const int32_t* bias;
  int8_t* out;
  int M, K, N, shift, out_max;
};

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copies `rows` rows of `len` bytes (row r at src + r*ld) to dst + r*pitch:
// whole 16-byte pieces with cp.async where src, ld and pitch allow it, the
// rest byte by byte.
__device__ __forceinline__ void stage(unsigned char* dst, int pitch,
                                      const int8_t* src, size_t ld, int rows,
                                      int len) {
  const int tid = threadIdx.x;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (rows == 1 || ld % 16 == 0) && pitch % 16 == 0;
  const int pieces = vec ? len / 16 : 0;
  for (int i = tid; i < rows * pieces; i += kThreads) {
    const int r = i / pieces, p = i - r * pieces;
    cp_async16(dst + r * pitch + 16 * p, src + r * ld + 16 * p);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int rest = len - 16 * pieces;
  for (int i = tid; i < rows * rest; i += kThreads) {
    const int r = i / rest, b = 16 * pieces + i - r * rest;
    dst[r * pitch + b] = (unsigned char)src[r * ld + b];
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem + C::XS;     // [TM][XP] A rows, k-contiguous
  unsigned char* wr = smem + C::WR;     // raw w rows [k][n]
  unsigned char* ws = smem + C::WS;     // [TN][WP] B rows, k-contiguous
  int* cs = reinterpret_cast<int*>(smem + C::CS);   // [TM][CP] counts
  int* bs = reinterpret_cast<int*>(smem + C::BS);   // [TN] bias
  const int M = P.M, K = P.K, N = P.N;
  const int m0 = blockIdx.x * C::TM, n0 = blockIdx.y * C::TN;
  const int rows = min(C::TM, M - m0), cols = min(C::TN, N - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int wk = warp % C::WK, wm = warp / C::WK / C::WN,
            wn = warp / C::WK % C::WN;
  // the tile spans all N: a chunk of w rows is one contiguous range
  const bool flat_w = n0 == 0 && N <= C::TN;
  const int wld = flat_w ? N : C::RP;   // raw w row pitch as staged

  // the tile's bias, loaded now and stored before the epilogue
  const int bias_t = tid < cols ? __ldg(P.bias + n0 + tid) : 0;
  if (C::WK > 1)
    for (int i = tid; i < C::TM * C::CP; i += kThreads) cs[i] = 0;

  int acc[C::NT][4];
#pragma unroll
  for (int q = 0; q < C::NT; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0;

  for (int k0 = 0; k0 < K; k0 += C::KC) {
    const int kc = min(C::KC, K - k0);
    const int kcp = (kc + kStep - 1) / kStep * kStep;
    if (k0 > 0) __syncthreads();       // the last chunk's fragments are read
    stage(xs, C::XP, P.x + (size_t)m0 * K + k0, K, rows, kc);
    if (flat_w)
      stage(wr, 0, P.w + (size_t)k0 * N, 0, 1, kc * N);
    else
      stage(wr, C::RP, P.w + (size_t)k0 * N + n0, N, kc, cols);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // Transpose: lane (n = 8 columns, kq = 4 k-quads) of a warp item packs
    // w[k0 + 4kq .. +3][n0 + n] into one word of B row n; zero past kc.
    const int n_grp = (cols + 7) / 8, n_items = n_grp * (kcp / 16);
    for (int item = warp; item < n_items; item += kWarps) {
      const int kg = item / n_grp, ng = item - kg * n_grp;
      const int n = ng * 8 + (lane & 7), k = (kg * 4 + (lane >> 3)) * 4;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n < cols && k + j < kc)
          v |= (uint32_t)wr[(k + j) * wld + n] << (8 * j);
      *reinterpret_cast<uint32_t*>(ws + n * C::WP + k) = v;
    }
    __syncthreads();

    // Products: this warp's m16 tile and NT n-tiles, every WK-th k-step.
    const unsigned char* xa = xs + (wm * 16 + gid) * C::XP + tq * 8;
    const unsigned char* wb =
        ws + (wn * C::NT * 8 + gid) * C::WP + tq * 8;
    for (int ks = wk; ks < kcp / kStep; ks += C::WK) {
      const uint2 lo = *reinterpret_cast<const uint2*>(xa + ks * kStep);
      const uint2 hi =
          *reinterpret_cast<const uint2*>(xa + 8 * C::XP + ks * kStep);
#pragma unroll
      for (int q = 0; q < C::NT; ++q) {
        if ((wn * C::NT + q) * 8 < cols) {    // warp-uniform
          const uint2 b = *reinterpret_cast<const uint2*>(
              wb + q * 8 * C::WP + ks * kStep);
          mma_s8(acc[q], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
        }
      }
    }
  }

  // Counts to shared memory: stored, or added across the WK warps.
#pragma unroll
  for (int q = 0; q < C::NT; ++q) {
    const int c = (wn * C::NT + q) * 8 + 2 * tq;
    int* lo = cs + (wm * 16 + gid) * C::CP + c;
    int* hi = lo + 8 * C::CP;
    if (C::WK > 1) {
      atomicAdd(lo, acc[q][0]);
      atomicAdd(lo + 1, acc[q][1]);
      atomicAdd(hi, acc[q][2]);
      atomicAdd(hi + 1, acc[q][3]);
    } else {
      *reinterpret_cast<int2*>(lo) = make_int2(acc[q][0], acc[q][1]);
      *reinterpret_cast<int2*>(hi) = make_int2(acc[q][2], acc[q][3]);
    }
  }
  if (tid < cols) bs[tid] = bias_t;
  __syncthreads();

  // Epilogue: bias, rounding shift, clip; 16 outputs a store where
  // N % 16 == 0, else one.
  const int lo_clip = -P.out_max - 1, hi_clip = P.out_max, shift = P.shift;
  const unsigned half = shift > 0 ? (1u << (shift - 1)) : 0u;
  auto finish = [&](int count, int c) {    // c: column in the tile
    int v = (int)((unsigned)count + (unsigned)bs[c]);
    if (shift > 0) v = (int)((unsigned)v + half) >> shift;
    return (uint32_t)(uint8_t)(int8_t)min(max(v, lo_clip), hi_clip);
  };
  if (N % 16 == 0) {
    const int pieces = cols / 16;
    for (int i = tid; i < rows * pieces; i += kThreads) {
      const int r = i / pieces, c = (i - r * pieces) * 16;
      uint32_t word[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 cnt =
            *reinterpret_cast<const int4*>(cs + r * C::CP + c + 4 * j);
        const int n = c + 4 * j;
        word[j] = finish(cnt.x, n) | (finish(cnt.y, n + 1) << 8) |
                  (finish(cnt.z, n + 2) << 16) | (finish(cnt.w, n + 3) << 24);
      }
      *reinterpret_cast<uint4*>(P.out + (size_t)(m0 + r) * N + n0 + c) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      P.out[(size_t)(m0 + r) * N + n0 + c] =
          (int8_t)finish(cs[r * C::CP + c], c);
    }
  }
}

template <class C>
int launch(const Params& P, cudaStream_t stream) {
  auto kernel = int8_matmul_kernel<C>;
  if (C::BYTES > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P.M + C::TM - 1) / C::TM, (P.N + C::TN - 1) / C::TN);
  kernel<<<grid, kThreads, C::BYTES, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan the launch takes for an (M, K) x (K, N) product: 1 = split K,
// 0 = tiled.
int int8_matmul_plan(int M, int K, int N) { return plan_split(M, K, N); }

// Launches one product on `stream`; returns cudaGetLastError() (0 =
// queued).  `out` must be 16-byte aligned where N % 16 == 0.
int int8_matmul_launch(const int8_t* x, const int8_t* w, const int32_t* bias,
                       int8_t* out, int M, int K, int N, int shift,
                       int out_max, void* stream) {
  if (M == 0 || N == 0) return 0;
  const Params P{x, w, bias, out, M, K, N, shift, out_max};
  return plan_split(M, K, N) ? launch<Split>(P, (cudaStream_t)stream)
                             : launch<Tiled>(P, (cudaStream_t)stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
