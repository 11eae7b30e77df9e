// imc_mav: one product tile of the IMC macro with its sense-amplifier
// epilogue, the per-group layer of the KWS net, designed for Hopper: int8
// tensor-core products over patches read from device memory once.
//
// Replaces the Pallas TPU kernel `imc_mav` (src/repro/kernels/imc_mav/
// imc_mav.py:67, with `_mav_kernel` and `_mav_kernel_noise`).  Same
// function, not the same blocks:
//
//   counts[m, n] = sum over k of x[m, k] * w[k, n]
//   pre  = (counts + bias[n]) [+ noise[m, n]]           (fp32, this order)
//   out  = (pre * flip[n]) >= 0 ? +1 : -1               (-0.0 gives +1)
//
// The input contract is x and w in {-1, 0, +1}, float32 or bfloat16 (the
// output takes x's type), as for imc_fused; conv_mav feeds it ±1 patches
// and ±1 weights.  Those values are exact in int8, so they are converted
// while they are staged and the products run on the tensor cores in int8
// (mma.sync m16n8k32 s8 x s8 -> s32).  Each count is an exact int32 of
// magnitude at most K; while K < 2^24 it converts to the same float the
// plain version's fp32 sum gives (every partial sum of ternary products is
// then an exact integer, in any order).  The epilogue adds in the
// reference's order with rounding spelled out (__fadd_rn, __fmul_rn; the
// build also passes --fmad=false), so the result is bit-identical to the
// plain version (../ref.py::imc_mav_ref).  The TPU kernel's 256 x 128
// tiles and the wrapper's zero padding are layout: this kernel guards its
// ragged edges instead.
//
// What bounds it on an H100: at the per-group layer's shapes (K = 72, the
// macro fan-in; N = cog = 32..96) it does 2*K*N operations per patch row
// for 4*(K + N) bytes of fp32 patches in and decisions out, 20-40
// operations per byte: at the fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s is 20), and with separate multiply and add instructions above
// it, which is where the first version (fp32 products on the CUDA cores,
// 64 x 64 tiles) lost its time.  On the int8 tensor cores (ridge ~590
// operations per byte) the floor is the bytes.  The design:
//
// * One block covers `bm` rows and all N columns up to a chunk of 128
//   (a grid dimension over chunks beyond that), so each patch is read from
//   device memory once at the net's shapes.
// * One round of loads per block.  A tile of rows of row-major x is one
//   contiguous range of bm*K values: it is copied raw with 16-byte
//   cp.async first, into the region the counts take later.  While those
//   copies fly, the tile's rows of w (K rows of up to 128 columns) are
//   read four columns a load (16 bytes in fp32, 8 in bf16; consecutive
//   threads on consecutive loads of a row, so a warp reads whole 32-byte
//   sectors of w, which every block reads from L2), kWLoads in flight per
//   thread, and stored at once as s8 words of a [k][n] tile.  After one
//   barrier, x is converted to s8 A rows [row][k] (a 4-byte store per 16
//   bytes of fp32, 8 per 16 of bf16), and w is transposed into
//   k-contiguous s8 B rows [n][k], zero from K to a multiple of 32, four k
//   rows of four columns at a time (a 4 x 4 byte transpose in registers
//   with byte permutes).  Where K is not a multiple of a piece's values or
//   x's base is not 16-byte aligned, x is read with 16-byte loads into
//   registers instead, scalar loads for the edges before the first
//   aligned address and after the last, each value placed at its own
//   (row, k); where N % 4 != 0, w is read value by value straight into B
//   rows (lanes on eight columns by four k-quads).  K beyond kKChunk is
//   staged chunk by chunk (value by value), the counts summed in shared
//   memory.
// * The bias and flip of the block's columns are loaded at the start and
//   stored to shared memory only before the epilogue.
// * Thread t of a quad takes bytes t*8..t*8+7 of a 32-deep k-step as its
//   fragment's k = t*4..t*4+3 and 16+t*4..16+t*4+3: a permutation of the
//   k-step that A and B share, so each fragment half is one 8-byte
//   shared-memory load.  Row pitches put the four rows a half-warp reads
//   on distinct bank windows.  Warps walk (m16 tile, four n-tiles) items
//   and leave int32 counts in shared memory; B rows and count columns are
//   padded to whole groups of four n-tiles, so the product loop has no
//   branch and its fragment loads are issued ahead of the products.
// * Epilogue and stores by rows of four-column quads: counts, bias and
//   flip from shared memory, noise with 16-byte loads, ±1 written with
//   16-byte stores (8 bytes in bf16); element by element where N % 4 != 0.
// * The launch plans the row tile (`make_plan`) from M, the column chunks
//   and the SM count: the largest of 128, 64, 32, 16 rows whose grid has a
//   block for at least every other SM (every block re-reads w, so fewer,
//   larger blocks win until the card runs short of them), within a
//   shared-memory budget of two blocks per SM.
//
// Layouts (contiguous, row-major):
//   x (M, K), w (K, N), bias / flip (N,), noise (M, N) or null, out (M, N).
// Grid: (ceil(M / bm), ceil(N / 128)); 256 threads (8 warps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 32;          // bytes of one int8 k-step
constexpr int kNChunk = 128;       // columns per block
constexpr int kKChunk = 256;       // K staged at once
constexpr int kStage = 8;          // x loads in flight per thread
constexpr int kWBatch = 2;         // w items loaded together (scalar)
constexpr int kWLoads = 8;         // w loads in flight per thread (vector)
constexpr int kRowTiles[] = {128, 64, 32, 16};

// n / d for 0 <= n < 2**31 as a multiply-high and a shift (the divisor's
// magic number is made once, on the host).
struct FastDiv {
  uint32_t mul;
  uint32_t shift;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return FastDiv{(uint32_t)mul, shift};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.mul) + (uint32_t)n) >> f.shift);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The smallest pitch >= `bytes` (a multiple of 32) whose word count puts
// rows 0..3 on disjoint 8-word bank windows.
int row_pitch(int bytes) {
  return (bytes / 4) % 32 == 0 || (bytes / 4) % 32 == 16 ? bytes + 32
                                                          : bytes;
}

// The same for a row of int32 counts of `words` words (a multiple of 8).
int count_pitch(int words) {
  return words % 32 == 0 || words % 32 == 16 ? words + 8 : words;
}

// Shared-memory layout of one block (byte offsets).
struct Layout {
  int xp, wp, cp;      // pitches: x and w rows (bytes), count rows (words)
  int xs, ws, cs, ep;  // regions
  int wr;              // s8 [k][n] w tile, from cs
  int bytes;
};

// `ncq`: B rows and count columns, whole groups of four n-tiles.  The
// count region also takes the raw x tile (`x_bytes`) and the s8 [k][n] w
// tile (`w_bytes`, from offset `wr`) before the products.
Layout layout(int bm, int ncq, int kcp, int x_bytes, int w_bytes) {
  Layout l;
  l.xp = row_pitch(kcp);
  l.wp = row_pitch(kcp);
  l.cp = count_pitch(ncq);
  l.xs = 0;
  l.ws = l.xs + round_up(bm * l.xp, 16);
  l.cs = l.ws + round_up(ncq * l.wp, 16);
  l.wr = round_up(x_bytes, 16);
  l.ep = l.cs + round_up(std::max(bm * l.cp * 4, l.wr + w_bytes), 16);
  l.bytes = l.ep + 2 * kNChunk * 4;
  return l;
}

// Bytes per s8 [k][n] w row of `cols` columns: whole words, an odd number
// of them, so that the transpose's reads of eight consecutive k-quads
// (rows four apart) start on eight different banks.
int kn_pitch(int cols) {
  const int words = round_up(cols, 8) / 4;
  return 4 * (words % 2 ? words : words + 1);
}

// The launch's plan: rows per block, which operands are copied raw, and
// the shared-memory layout.  Rows: the largest tile whose grid gives at
// least every other SM a block (every block re-reads w, so fewer, larger
// blocks win until the card runs short of blocks; timed on an H100 at the
// per-group shapes).  A plan whose block passes kSmemBudget (two blocks
// per SM) drops the [k][n] staging of w, then the raw copy of x, then
// halves the rows.
constexpr int kSmemBudget = 110 * 1024;

struct Plan {
  int bm, x_raw, w_vec, wkp;
  Layout l;
};

Plan make_plan(int M, int K, int N, int size, bool x_aligned,
               bool w_aligned, int sms) {
  const int values = 16 / size;
  const int n_chunks = (N + kNChunk - 1) / kNChunk;
  const int kc = std::min(K, kKChunk);
  const int kcp = (kc + kStep - 1) / kStep * kStep;
  const int nc = std::min(N, kNChunk);
  const bool x_ok = K <= kKChunk && K % values == 0 && x_aligned;
  const bool w_ok = K <= kKChunk && N % 4 == 0 && w_aligned;
  int first = 3;
  for (int i = 0; i < 4; ++i)
    if (2LL * ((M + kRowTiles[i] - 1) / kRowTiles[i]) * n_chunks >= sms) {
      first = i;
      break;
    }
  Plan p{};
  p.wkp = kn_pitch(nc);
  for (int i = first; i < 4; ++i) {
    p.bm = kRowTiles[i];
    const bool tries[3][2] = {{x_ok, w_ok}, {x_ok, false}, {false, false}};
    for (const auto& t : tries) {
      p.x_raw = t[0], p.w_vec = t[1];
      p.l = layout(p.bm, round_up(nc, 32), kcp,
                   p.x_raw ? p.bm * kc * size : 0,
                   p.w_vec ? kc * p.wkp : 0);
      if (p.l.bytes <= kSmemBudget) return p;
    }
  }
  return p;   // 16 rows, nothing raw: under 64 KB for any K and N
}

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  const float* flip;
  const float* noise;    // may be null
  void* out;
  int M, K, N, bm;
  int w_vec, wkp;        // w read four values a load, its s8 row pitch
  Layout l;
  FastDiv by_k, by_quads, by_quads_last;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t s8(float v) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rz(v);
}

__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c,
                                            float d) {
  return s8(a) | (s8(b) << 8) | (s8(c) << 16) | (s8(d) << 24);
}

__device__ __forceinline__ uint32_t pack_bf16_s8(uint32_t lo, uint32_t hi) {
  // two words of two bfloat16 each -> four s8
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack_s8(__low2float(a), __high2float(a), __low2float(b),
                 __high2float(b));
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

// Four consecutive values as floats: one 16-byte (fp32) or 8-byte (bf16)
// load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a), v[1] = __high2float(a);
  v[2] = __low2float(b), v[3] = __high2float(b);
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

// Stores four ±1 outputs (consecutive columns) as one 16-byte (fp32) or
// 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* dst, const bool (&pos)[4]) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(from_sign<float>(pos[0]), from_sign<float>(pos[1]),
                  from_sign<float>(pos[2]), from_sign<float>(pos[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const bool (&pos)[4]) {
  __nv_bfloat162 a, b;
  a.x = from_sign<__nv_bfloat16>(pos[0]);
  a.y = from_sign<__nv_bfloat16>(pos[1]);
  b.x = from_sign<__nv_bfloat16>(pos[2]);
  b.y = from_sign<__nv_bfloat16>(pos[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&a);
  v.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = v;
}

// x staging modes: kVecX, one chunk copied raw with 16-byte cp.async,
// each piece one store when converted (K a multiple of the piece's values,
// base aligned); kFlatX, one chunk of 16-byte loads with scalar edges,
// each value placed by itself; kChunkX, K in chunks of kKChunk, value by
// value.
enum XMode { kVecX = 0, kFlatX = 1, kChunkX = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
imc_mav_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);     // values per 16-byte piece
  const Layout& l = P.l;
  const T* __restrict__ x = static_cast<const T*>(P.x);
  const T* __restrict__ w = static_cast<const T*>(P.w);
  const int M = P.M, K = P.K, N = P.N;
  const int m0 = blockIdx.x * P.bm, n0 = blockIdx.y * kNChunk;
  const bool last_chunk = blockIdx.y == gridDim.y - 1;
  const int rows = min(P.bm, M - m0);
  const int nc = min(kNChunk, N - n0);
  const int ncp = (nc + 7) & ~7;
  unsigned char* xs = smem + l.xs;            // [bm][xp] s8 A rows
  unsigned char* ws = smem + l.ws;            // [ncq][wp] s8 B rows
  int* cs = reinterpret_cast<int*>(smem + l.cs);   // [bm][cp] counts
  unsigned char* xr = smem + l.cs;            // raw x tile (kVecX)
  unsigned char* wk = smem + l.cs + l.wr;     // s8 [k][n] w (w_vec)
  float* eb = reinterpret_cast<float*>(smem + l.ep);
  float* ef = eb + kNChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;

  // the chunk's bias and flip, loaded now and stored before the epilogue
  // (nc <= kNChunk <= kThreads)
  const float bias_t = tid < nc ? __ldg(P.bias + n0 + tid) : 0.f;
  const float flip_t = tid < nc ? __ldg(P.flip + n0 + tid) : 0.f;
  const int m_tiles = (rows + 15) / 16;
  const int n_groups = (ncp / 8 + 3) / 4;
  const int items = m_tiles * n_groups;

  for (int k0 = 0; k0 < max(K, 1); k0 += kKChunk) {   // K = 0: zeros
    const int kc = min(kKChunk, K - k0);
    const int kcp = (kc + kStep - 1) / kStep * kStep;
    if (k0 > 0) __syncthreads();     // the last chunk's fragments are read

    // 1. kVecX: the tile's rows of x (one contiguous, aligned range of
    // rows*K values) copied raw, all in flight while w is staged.
    const int n_vec = kMode == kVecX ? rows * K / V : 0;
    if (kMode == kVecX) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m0 * K);
      for (int i = tid; i < n_vec; i += kThreads)
        cp_async16(xr + 16 * i, src + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    // 2. w_vec (N % 4 == 0): the tile's rows of w, four columns a load
    // (consecutive threads on consecutive loads of a row: whole sectors),
    // kWLoads in flight per thread, converted to s8 words of a [k][n]
    // tile.
    if (P.w_vec) {
      const int quads = nc / 4, n_ld = kc * quads;
      for (int base = tid; base < n_ld; base += kWLoads * kThreads) {
        float v[kWLoads][4];
#pragma unroll
        for (int u = 0; u < kWLoads; ++u) {
          const int i = base + u * kThreads;
          const int r = i / quads, q = i - r * quads;
          if (i < n_ld) load4(w + (size_t)(k0 + r) * N + n0 + 4 * q, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kWLoads; ++u) {
          const int i = base + u * kThreads;
          const int r = i / quads, q = i - r * quads;
          if (i < n_ld)
            *reinterpret_cast<uint32_t*>(wk + r * P.wkp + 4 * q) =
                pack_s8(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
      }
    }

    // Otherwise w value by value into B rows [n][k]: lane (n = 8 columns,
    // kq = 4 k-quads) of a warp item packs w[k0 + 4kq .. +3, n0 + n] into
    // one word; zero past K and nc.
    if (!P.w_vec) {
      const int n_grp = ncp / 8, n_items = n_grp * (kcp / 16);
      for (int base = warp; base < n_items; base += kWBatch * kWarps) {
        float v[kWBatch][4];
#pragma unroll
        for (int u = 0; u < kWBatch; ++u) {
          const int item = base + u * kWarps;
          const int kg = item / n_grp, ng = item - kg * n_grp;
          const int n = ng * 8 + (lane & 7), k = (kg * 4 + (lane >> 3)) * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = item < n_items && n < nc && k + j < kc
                          ? to_float(__ldg(w + (size_t)(k0 + k + j) * N +
                                           n0 + n))
                          : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kWBatch; ++u) {
          const int item = base + u * kWarps;
          if (item >= n_items) continue;
          const int kg = item / n_grp, ng = item - kg * n_grp;
          const int n = ng * 8 + (lane & 7), k = (kg * 4 + (lane >> 3)) * 4;
          *reinterpret_cast<uint32_t*>(ws + n * l.wp + k) =
              pack_s8(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
      }
    }

    // 3. x rows [m0, m0 + rows) x [k0, k0 + kc) -> s8 A rows, where they
    // were not copied raw.
    if (kMode == kFlatX) {
      // one range of rows*K values from any base: scalar loads up to the
      // first 16-byte aligned value and after the last whole piece; every
      // value placed at its own (row, k)
      const T* src = x + (size_t)m0 * K;
      const int n_el = rows * K;
      const int head = min(
          (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
              (int)sizeof(T),
          n_el);
      const int n_pc = (n_el - head) / V;
      const int tail = head + n_pc * V;
      for (int base = tid; base < n_pc; base += kStage * kThreads) {
        uint4 v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = base + u * kThreads;
          if (i < n_pc)
            v[u] = __ldg(reinterpret_cast<const uint4*>(src + head) + i);
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = base + u * kThreads;
          if (i >= n_pc) continue;
          const int e = head + i * V;
          int r = fdiv(e, P.by_k), c = e - r * K;
          const T* vals = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            xs[r * l.xp + c] = (unsigned char)s8(to_float(vals[j]));
            if (++c == K) c = 0, ++r;
          }
        }
      }
      for (int i = tid; i < head + n_el - tail; i += kThreads) {
        const int e = i < head ? i : tail + i - head;
        const int r = fdiv(e, P.by_k), c = e - r * K;
        xs[r * l.xp + c] = (unsigned char)s8(to_float(__ldg(src + e)));
      }
    } else if (kMode == kChunkX) {
      for (int i = tid; i < rows * kc; i += kThreads) {
        const int r = i / kc, c = i - r * kc;
        xs[r * l.xp + c] = (unsigned char)s8(
            to_float(__ldg(x + (size_t)(m0 + r) * K + k0 + c)));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // 4. x pieces to s8 A rows (one 4- or 8-byte store each); the [k][n]
    // w tile to B rows [n][k], four k rows of four columns an item (a 4 x 4
    // byte transpose in registers), zero past K.
    if (kMode == kVecX || P.w_vec) {
      if (kMode == kVecX) {
        for (int i = tid; i < n_vec; i += kThreads) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr + 16 * i);
          const int e = i * V;
          const int r = fdiv(e, P.by_k), c = e - r * K;
          unsigned char* dst = xs + r * l.xp + c;
          if (sizeof(T) == 4) {
            *reinterpret_cast<uint32_t*>(dst) =
                pack_s8(__uint_as_float(v.x), __uint_as_float(v.y),
                        __uint_as_float(v.z), __uint_as_float(v.w));
          } else {
            *reinterpret_cast<uint2*>(dst) = make_uint2(
                pack_bf16_s8(v.x, v.y), pack_bf16_s8(v.z, v.w));
          }
        }
      }
      if (P.w_vec) {
        const int nkq = kcp / 4, n_items = (ncp / 4) * nkq;
        for (int i = tid; i < n_items; i += kThreads) {
          const int nq = i / nkq, kq = i - nq * nkq;
          uint32_t r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            r[j] = 4 * kq + j < kc ? *reinterpret_cast<const uint32_t*>(
                                         wk + (4 * kq + j) * P.wkp + 4 * nq)
                                   : 0u;
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          unsigned char* dst = ws + 4 * nq * l.wp + 4 * kq;
          *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + l.wp) =
              __byte_perm(t0, t2, 0x7632);
          *reinterpret_cast<uint32_t*>(dst + 2 * l.wp) =
              __byte_perm(t1, t3, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + 3 * l.wp) =
              __byte_perm(t1, t3, 0x7632);
        }
      }
      __syncthreads();
    }

    // 5. Products: warp items (m16 tile, four n-tiles: B rows and count
    // columns are padded to whole groups, so no n-tile is guarded); counts
    // to shared memory (stored on the first chunk, added after).
    const int steps = kcp / kStep;
    for (int item = warp; item < items; item += kWarps) {
      const int ng = item / m_tiles, mt = item - ng * m_tiles;
      int acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0;
      const unsigned char* xa = xs + (mt * 16 + gid) * l.xp + tq * 8;
      const unsigned char* wb = ws + (ng * 32 + gid) * l.wp + tq * 8;
#pragma unroll 2
      for (int ks = 0; ks < steps; ++ks) {
        const uint2 lo = *reinterpret_cast<const uint2*>(xa + ks * kStep);
        const uint2 hi =
            *reinterpret_cast<const uint2*>(xa + 8 * l.xp + ks * kStep);
        uint2 b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = *reinterpret_cast<const uint2*>(wb + q * 8 * l.wp +
                                                 ks * kStep);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_s8(acc[q], lo.x, hi.x, lo.y, hi.y, b[q].x, b[q].y);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = (ng * 4 + q) * 8 + 2 * tq;
        int2* lo = reinterpret_cast<int2*>(cs + (mt * 16 + gid) * l.cp + c);
        int2* hi = lo + 4 * l.cp;           // row + 8 (int2 = 2 words)
        if (k0 == 0) {
          *lo = make_int2(acc[q][0], acc[q][1]);
          *hi = make_int2(acc[q][2], acc[q][3]);
        } else {
          const int2 a = *lo, b = *hi;
          *lo = make_int2(a.x + acc[q][0], a.y + acc[q][1]);
          *hi = make_int2(b.x + acc[q][2], b.y + acc[q][3]);
        }
      }
    }
  }
  if (tid < nc) {
    eb[tid] = bias_t;
    ef[tid] = flip_t;
  }
  __syncthreads();

  // 4. Epilogue: (count + bias) [+ noise], x flip, sign; four columns of a
  // row per item where N % 4 == 0, else one value per item.
  T* out = static_cast<T*>(P.out);
  const float* noise = P.noise;
  if (N % 4 == 0) {
    const int quads = nc / 4;
    const FastDiv byq = last_chunk ? P.by_quads_last : P.by_quads;
    for (int i = tid; i < rows * quads; i += kThreads) {
      const int r = fdiv(i, byq), c = (i - r * quads) * 4;
      const int4 cnt = *reinterpret_cast<const int4*>(cs + r * l.cp + c);
      const float4 b = *reinterpret_cast<const float4*>(eb + c);
      const float4 f = *reinterpret_cast<const float4*>(ef + c);
      const size_t o = (size_t)(m0 + r) * N + n0 + c;
      float pre[4] = {__fadd_rn(__int2float_rn(cnt.x), b.x),
                      __fadd_rn(__int2float_rn(cnt.y), b.y),
                      __fadd_rn(__int2float_rn(cnt.z), b.z),
                      __fadd_rn(__int2float_rn(cnt.w), b.w)};
      if (noise != nullptr) {
        const float4 z = __ldg(reinterpret_cast<const float4*>(noise + o));
        pre[0] = __fadd_rn(pre[0], z.x);
        pre[1] = __fadd_rn(pre[1], z.y);
        pre[2] = __fadd_rn(pre[2], z.z);
        pre[3] = __fadd_rn(pre[3], z.w);
      }
      const bool pos[4] = {__fmul_rn(pre[0], f.x) >= 0.f,
                           __fmul_rn(pre[1], f.y) >= 0.f,
                           __fmul_rn(pre[2], f.z) >= 0.f,
                           __fmul_rn(pre[3], f.w) >= 0.f};
      store4(out + o, pos);
    }
  } else {
    for (int i = tid; i < rows * nc; i += kThreads) {
      const int r = i / nc, c = i - r * nc;
      const size_t o = (size_t)(m0 + r) * N + n0 + c;
      float pre = __fadd_rn(__int2float_rn(cs[r * l.cp + c]), eb[c]);
      if (noise != nullptr) pre = __fadd_rn(pre, __ldg(noise + o));
      out[o] = from_sign<T>(__fmul_rn(pre, ef[c]) >= 0.f);
    }
  }
}

template <typename T, int kMode>
int launch_kernel(const Params& P, dim3 grid, cudaStream_t stream) {
  auto kernel = imc_mav_kernel<T, kMode>;
  const int smem = P.l.bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Params& P, int sms, cudaStream_t stream) {
  const Plan plan = make_plan(
      P.M, P.K, P.N, sizeof(T), reinterpret_cast<uintptr_t>(P.x) % 16 == 0,
      reinterpret_cast<uintptr_t>(P.w) % (4 * sizeof(T)) == 0, sms);
  P.bm = plan.bm, P.w_vec = plan.w_vec, P.wkp = plan.wkp, P.l = plan.l;
  const int n_chunks = (P.N + kNChunk - 1) / kNChunk;
  P.by_k = make_fastdiv(std::max(P.K, 1));
  P.by_quads = make_fastdiv(kNChunk / 4);
  const int last = P.N - (n_chunks - 1) * kNChunk;
  P.by_quads_last = make_fastdiv(std::max(last / 4, 1));
  const dim3 grid((P.M + P.bm - 1) / P.bm, n_chunks);
  if (P.K > kKChunk) return launch_kernel<T, kChunkX>(P, grid, stream);
  if (plan.x_raw) return launch_kernel<T, kVecX>(P, grid, stream);
  return launch_kernel<T, kFlatX>(P, grid, stream);
}

}  // namespace

extern "C" {

// The row tile the launch takes for an (M, K) x (K, N) float32 product on
// a card of `sms` SMs: writes (rows per block, column chunks) to
// tile[0..1] and returns the block's shared-memory bytes.
int imc_mav_plan(int M, int K, int N, int sms, int* tile) {
  const Plan p = make_plan(M, K, N, 4, true, true, sms);
  tile[0] = p.bm;
  tile[1] = (N + kNChunk - 1) / kNChunk;
  return p.l.bytes;
}

// Launches one product tile on `stream` in blocks planned for a card of
// `sms` SMs; `bf16` selects bfloat16 x, w and out (else float32); `noise`
// may be null and must be 16-byte aligned where N % 4 == 0, as `out` is.
// Returns cudaGetLastError() (0 = queued).
int imc_mav_launch(const void* x, const void* w, const float* bias,
                   const float* flip, const float* noise, void* out, int M,
                   int K, int N, int bf16, int sms, void* stream) {
  if (M == 0 || N == 0) return 0;
  Params P;
  P.x = x, P.w = w, P.bias = bias, P.flip = flip, P.noise = noise;
  P.out = out, P.M = M, P.K = K, P.N = N;
  return bf16 ? launch<__nv_bfloat16>(P, sms, (cudaStream_t)stream)
              : launch<float>(P, sms, (cudaStream_t)stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
