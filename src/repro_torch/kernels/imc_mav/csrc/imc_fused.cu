// imc_fused: one whole grouped IMC layer of the KWS net in one launch,
// designed for Hopper: int8 tensor-core products over an implicit im2col.
//
// Replaces the Pallas TPU kernel `imc_fused` (src/repro/kernels/imc_mav/
// imc_mav.py:141, with `_fused_kernel`, `_fused_kernel_noise` and
// `_epilogue`).  It computes the same function, not the same blocks:
//
//   counts[b, t, ch] = sum over taps j and group channels c of
//                      x[b, t*stride + j, g*cpg + c] * w[j, c, ch]
//   pre  = ((counts + off) + bias) [+ noise]      (fp32, in this order)
//   act  = (pre * flip) >= 0 ? +1 : -1
//   out[b, tp, a*groups + g] = max over r < pool of act[b, tp*pool + r, g*cog + a]
//
// i.e. grouped convolution, chip offset, word-line bias, optional pre-sign
// noise operand, BN-decoder flip, SA sign, OR-maxpool and the channel
// shuffle, with no pre-activation ever written to device memory.  The add
// order is the reference's (repro/core/imc.py::mav_sa), spelled out with
// __fadd_rn / __fmul_rn (the build also passes --fmad=false), so the result
// is bit-identical to the plain version in ../ref.py.
//
// The input contract is x in {-1, 0, +1}, not only ±1.  The served path
// sends zeros: the carries of slots that were never admitted are zeroed
// (serving/stream.py::zeros_state) and ride every batched hop until their
// results are thrown away.  The plain version counts a zero as a zero
// product, so the kernel must too.  A ternary x and a ±1 w are exact as
// s8, and each count is an exact int32 of magnitude at most k*cpg (72 in
// the paper net), which converts to the same float the plain version sums.
// An XNOR-popcount design would read 0 as +1 and differ on those rows.
//
// What bounds it on an H100: the layer moves its activations in and out of
// HBM as fp32 (4 bytes each) and does 2*k*cpg = 144 operations per product
// row, about 40-50 operations per byte: far below the int8 tensor cores'
// ridge (~590 per byte), so the floor is the bytes at 3.35 TB/s.  What the
// first version lost was latency inside each thread (72-step serial float
// chains) and a grid of under a wave.  The design:
//
// * Products on the tensor cores, in int8: mma.sync m16n8k32 s8 x s8 -> s32.
//   Each tap's cpg group channels are s = ceil(cpg / 32) 32-deep k-steps,
//   padded with zero weights, so k = 3 takes 3 s mma per 16 x 8 tile (s = 1
//   in the paper net, cpg 24).  wgmma is not needed: a group's N (cog) is
//   8-96 and a block's M per group is 16-64 rows, so there is no 64-row
//   warpgroup tile to fill, and at ~45 operations per byte the products
//   are nowhere near the limit; mma.sync keeps each warp's small tile
//   independent and its operands in registers.
// * Weights as int8 B rows made once, at fold time (../ops.py::
//   pack_weights_s8, from models/kws.py::pack_hw_params): row (g, j, n) is
//   w[j, 0..cpg-1, g*cog + n] in 32 s bytes, zero past cpg.  A block copies
//   its chunk of groups (one contiguous range, 4x smaller than fp32) into
//   shared memory with cp.async, nothing converted per block.  Thread t of
//   a quad takes channels t*8..t*8+7 of a k-step (bytes t*8 of an A or B
//   row's 32) as its fragment's k = t*4..t*4+3 and 16+t*4..16+t*4+3: a
//   permutation of the k-step that both operands share, so each fragment
//   half is one 8-byte shared-memory load and a half-warp reads four whole
//   rows.
// * An implicit im2col, kept: a block stages each input row it needs once,
//   converted to s8 in registers into a shared layout [row][group][32 s].
//   Where cpg is a multiple of 4 the rows are read as fp32 with 16-byte
//   loads along C_in (four channels never straddle a group); otherwise
//   each staged 4-byte word decodes its group and channels and reads them
//   one by one, writing zeros from cpg to the end of the slot.  The A
//   fragment of conv column m, tap j and k-step i is row m*stride + j of
//   the group, bytes 32 i on; no patch tensor exists.  The row pitch is
//   padded so that a quad's four rows (spaced pool*stride apart) fall in
//   distinct banks.
// * OR-maxpool in registers.  Row i of an m16 tile is pooled column m0 + i,
//   and the tile is computed `pool` times, pass r taking conv column
//   (m0 + i)*pool + r.  A pool window's columns thus land in the same
//   accumulator slot of the same thread on successive passes, and the OR
//   is a bit set in a register: no shuffle, no shared-memory exchange, one
//   code path for any pool, and ragged tails stay right (columns past
//   t_pool*pool are never computed, as the reference drops them).  It
//   spends the same mma per pooled column as pairing conv columns 2q,
//   2q + 1 on rows i, i + 8 would, without that pool-2-only special case.
// * Warps walk (m16 tile, group, two n-tiles) items; an item loads its
//   epilogue constants, B fragments and noise ahead of use, and its
//   epilogue is branch-free (invalid slots are masked), which keeps loads
//   and products in flight in every warp.
// * Coalesced shuffled stores: the block's (pooled column x channel) tile
//   is staged in shared memory as s8 in post-shuffle order (a*groups + g),
//   then written as ±1 fp32 with 16-byte stores; a block that holds all
//   groups writes one contiguous range of the output.
// * A grid that fills the card: one block per (group chunk, tile of pooled
//   columns, stream).  The launch picks the tile and the chunk
//   (`plan_tile`, below, beside the shared-memory layout it sizes): about
//   two blocks per SM at the full-window shapes, and as many as the
//   hop-tail shapes allow.
// * Guards, not padding: HBM operands are read as given; ragged column
//   tiles, ragged n-tiles (cog not a multiple of 8, or odd), the B rows a
//   ragged n-tile reads past its group (masked columns; the last group's
//   land in kWeightSlack rows of slack) and rows past T are guarded (a row
//   past T only ever feeds a column that is not stored).  So any cpg and
//   cog that divide the layer run; a shape whose smallest tile needs more
//   shared memory than a block of the card can have is refused.
//
// Layouts (contiguous):
//   x     (B, T, C_in) fp32       {-1, 0, +1}, C_in = groups * cpg (16-byte
//                                 aligned where cpg % 4 == 0)
//   wq    (groups, k, cog, 32 s)  s8, the fold-time B rows
//   bias, flip, off   (C_out,)    fp32, pre-shuffle order; off may be null
//   noise (B, noise_t, C_out)     fp32, optional (null), pre-pool rows
//   out   (B, t_pool, C_out)      fp32, post-shuffle channel order
// Grid: (groups / gc, ceil(t_pool / pt), B); 256 threads (8 warps).

#include <cuda_runtime.h>
#include <algorithm>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNChunk = 2;        // n-tiles of 8 channels per warp item
constexpr int kStep = 32;         // bytes of one int8 k-step
constexpr int kSlackRows = 16;    // B rows a ragged n-tile reads past cog
constexpr int kStage = 8;         // loads in flight per thread

// n / d for 0 <= n < 2**31 as a multiply-high and a shift (the divisor's
// magic number is made once, on the host): the staging, item and store
// loops divide indices by runtime widths.
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

// Shared-memory layout of one block.
struct Layout {
  int mt;          // m16 tiles per block
  int rows;        // staged input rows
  int pitch;       // bytes per staged s8 row
  int xs, ws, ep, os;               // region offsets (bytes)
  int bytes;                        // total
};

// Bytes of a group's slot in a staged row and in a B row: cpg channels
// rounded up to whole 32-byte k-steps.
int slot_bytes(int cpg) { return (cpg + kStep - 1) / kStep * kStep; }

// Pitch padding: the smallest 8-byte pad that puts the four rows a quad
// reads (spaced `spacing` rows apart) on distinct 8-bank windows.
int row_pitch(int gc, int slot, int spacing) {
  const int base = gc * slot;
  for (int pad = 0; pad < 128; pad += 8) {
    const int words = ((base + pad) / 4) * spacing % 32;
    if (words == 8 || words == 24) return base + pad;
  }
  return base;
}

int round16(int v) { return (v + 15) & ~15; }

Layout layout(int pt, int gc, int k, int cog, int slot, int stride,
              int pool) {
  Layout l;
  l.mt = pt / 16;
  l.rows = (l.mt * 16 * pool - 1) * stride + k;
  l.pitch = row_pitch(gc, slot, pool * stride);
  l.xs = 0;
  l.ws = l.xs + round16(l.rows * l.pitch);
  l.ep = l.ws + round16((gc * k * cog + kSlackRows) * slot);
  l.os = l.ep + round16(3 * 4 * gc * cog);
  l.bytes = l.os + round16(pt * gc * cog);
  return l;
}

// The block tile: `pt` pooled columns (a multiple of the m16 tile) of one
// stream and `gc` of the layer's groups.  Of the tiles whose shared memory
// fits kSmemBudget, the one with the most blocks up to kBlocksPerSM per SM;
// among those, the widest chunk of groups (the shuffled output rows are
// then long contiguous runs), then the longest column tile (fewer blocks
// stage the same weights).  A column tile is not taken where half of it
// gives as many tiles.  The rule was chosen by timing every tile at the
// paper net's served shapes on an H100.  Where no tile fits the budget
// (wide groups: a group's B rows alone can pass it), the same rule picks
// among the tiles that fit the most shared memory a block of the card can
// have (`smem_max`).
constexpr int kTileColumns[] = {128, 64, 32, 16};
constexpr int kSmemBudget = 72 * 1024;   // bytes a block may take: 3 per SM
constexpr double kBlocksPerSM = 1.9;     // a grid this full gains no more

struct Tile {
  int pt, gc, bytes;                     // bytes = 0: no tile fits
};

Tile plan_tile(int B, int t_pool, int groups, int cog, int k, int cpg,
               int stride, int pool, int sms, int smem_max) {
  const double cap = kBlocksPerSM * sms;
  const int slot = slot_bytes(cpg);
  const int budgets[2] = {std::min(kSmemBudget, smem_max), smem_max};
  for (const int budget : budgets) {
    Tile best{0, 0, 0};
    double best_blocks = -1.0;
    for (int gc = 1; gc <= groups; ++gc) {
      if (groups % gc != 0) continue;
      for (const int pt : kTileColumns) {
        const int n_tiles = (t_pool + pt - 1) / pt;
        if (pt > 16 && n_tiles == (t_pool + pt / 2 - 1) / (pt / 2)) continue;
        const int bytes = layout(pt, gc, k, cog, slot, stride, pool).bytes;
        if (bytes > budget) continue;
        const double blocks =
            std::min((double)B * n_tiles * (groups / gc), cap);
        if (blocks > best_blocks ||
            (blocks == best_blocks &&
             (gc > best.gc || (gc == best.gc && pt > best.pt)))) {
          best = Tile{pt, gc, bytes};
          best_blocks = blocks;
        }
      }
    }
    if (best.bytes > 0) return best;
  }
  return Tile{0, 0, 0};
}

struct Params {
  const float* x;
  const int8_t* wq;      // (groups, k, cog, slot) int8 B rows
  const float* bias;
  const float* flip;
  const float* off;      // may be null
  const float* noise;    // may be null
  float* out;
  int T, c_in, k, cpg, cog, c_out, groups, stride, pool, t_pool, noise_t;
  int slot, steps;       // bytes of a group's slot, 32-byte k-steps in it
  int pt, gc;
  Layout l;
  FastDiv by_quads, by_cpg, by_row_words, by_slot_words, by_c_chunk, by_gc,
      by_mt, by_chunks;
};

__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c,
                                            float d) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rz(a) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rz(b) << 8) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rz(c) << 16) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rz(d) << 24);
}

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

// kOneStep: cpg <= 32, one k-step per tap (the slot a compile-time 32
// bytes); kVecX: cpg % 4 == 0, input rows read as float4.
template <bool kNoise, bool kOneStep, bool kVecX>
__global__ void __launch_bounds__(kThreads, 3)
imc_fused_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& l = P.l;
  const int cog = P.cog, cpg = P.cpg, gc = P.gc, k = P.k;
  const int slot = kOneStep ? kStep : P.slot;
  const int steps = kOneStep ? 1 : P.steps;
  const int pool = P.pool, stride = P.stride;
  const int g0 = blockIdx.x * gc;     // first group of the chunk
  const int p0 = blockIdx.y * P.pt;   // first pooled column of the tile
  const int b = blockIdx.z;
  const int n_cols = min(P.pt, P.t_pool - p0);
  const int c_chunk = gc * cog;
  unsigned char* xs = smem + l.xs;          // [rows][gc][slot] s8, pitched
  unsigned char* ws = smem + l.ws;          // [gc][k*cog][slot] B rows
  float* eb = (float*)(smem + l.ep);        // [c_chunk] bias, flip and
  float* ef = eb + c_chunk;                 // offset of the chunk's
  float* eo = ef + c_chunk;                 // channels (pre-shuffle)
  signed char* os = (signed char*)(smem + l.os);   // [pt][c_chunk] s8
  const int tid = threadIdx.x;

  // 1. Stage.  The chunk's int8 B rows are one contiguous range of the
  // fold-time pack: 16-byte asynchronous copies, all in flight at once.
  // The input rows [row0, row0 + rows) of the chunk's channels are packed
  // to s8 four at a time and stored as [row][group][slot]: with kVecX read
  // as float4 along C_in (each thread's loads of a round in flight
  // together; bytes cpg.. of a slot are left as they are, facing zero
  // weights), otherwise one 4-byte word of a slot per item, its channels
  // read one by one and zeros from cpg to the end of the slot.  The
  // chunk's bias, flip and offset (zero without an offset: adding +0 to
  // an integer-valued count changes nothing) are loaded as they are.
  {
    const int n_w = gc * k * cog * slot / 16;
    const int4* wsrc = reinterpret_cast<const int4*>(
        P.wq + (size_t)g0 * k * cog * slot);
    for (int i = tid; i < n_w; i += kThreads)
      cp_async16(ws + 16 * i, wsrc + i);
    asm volatile("cp.async.commit_group;\n" ::);

    const int row0 = p0 * pool * stride;
    const int n_rows = min(l.rows, P.T - row0);
    // items per staged row: float4s of the chunk's channels, or words of
    // its slots
    const int row_items = kVecX ? gc * cpg / 4 : gc * slot / 4;
    const int n_x = n_rows * row_items;
    const int total = n_x + c_chunk;
    const float* xb =
        P.x + ((size_t)b * P.T + row0) * P.c_in + (size_t)g0 * cpg;
    for (int base = tid; base < total; base += kStage * kThreads) {
      float4 v[kStage];
      int dst[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * kThreads;
        if (i < n_x && kVecX) {
          const int r = fdiv(i, P.by_quads);
          const int c = (i - r * row_items) * 4;
          const int gl = fdiv(c, P.by_cpg);
          dst[u] = r * l.pitch + gl * slot + c - gl * cpg;
          v[u] = __ldg(reinterpret_cast<const float4*>(
              xb + (size_t)r * P.c_in + c));
        } else if (i < n_x) {
          const int r = fdiv(i, P.by_row_words);
          const int word = i - r * row_items;
          const int gl = fdiv(word, P.by_slot_words);
          const int c = (word - gl * (slot / 4)) * 4;   // channel in group
          dst[u] = r * l.pitch + gl * slot + c;
          const float* src = xb + (size_t)r * P.c_in + gl * cpg + c;
          v[u].x = c < cpg ? __ldg(src) : 0.f;
          v[u].y = c + 1 < cpg ? __ldg(src + 1) : 0.f;
          v[u].z = c + 2 < cpg ? __ldg(src + 2) : 0.f;
          v[u].w = c + 3 < cpg ? __ldg(src + 3) : 0.f;
        } else if (i < total) {
          const int ch = g0 * cog + (i - n_x);
          dst[u] = i - n_x;
          v[u] = make_float4(__ldg(P.bias + ch), __ldg(P.flip + ch),
                             P.off != nullptr ? __ldg(P.off + ch) : 0.f,
                             0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * kThreads;
        if (i < n_x) {
          *reinterpret_cast<uint32_t*>(xs + dst[u]) =
              pack_s8(v[u].x, v[u].y, v[u].z, v[u].w);
        } else if (i < total) {
          eb[dst[u]] = v[u].x;
          ef[dst[u]] = v[u].y;
          eo[dst[u]] = v[u].z;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }
  __syncthreads();

  // 2. Products and epilogue.  One warp item = (m16 tile, group, two
  // n-tiles); its constants, B fragments and noise are loaded ahead of use
  // and the epilogue is branch-free (invalid slots are masked), so a warp
  // keeps several loads and products in flight.
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int n_tiles = (cog + 7) / 8;
  const int n_chunks = (n_tiles + kNChunk - 1) / kNChunk;
  const int items = l.mt * gc * n_chunks;
  const int row_step = 8 * pool * stride;           // rows i -> i + 8
  for (int item = warp; item < items; item += kWarps) {
    const int rest = fdiv(item, P.by_mt);
    const int mt = item - rest * l.mt;
    const int gl = fdiv(rest, P.by_chunks);
    const int nc = rest - gl * n_chunks;
    const int m0 = mt * 16;
    const int g = g0 + gl;
    // slot i of n-tile q: column n = (nc*2 + q)*8 + 2*tq + (i & 1), row
    // m0 + gid (+ 8 for i >= 2)
    float cb[kNChunk][2], cf[kNChunk][2], co[kNChunk][2];
    uint32_t valid = 0;
#pragma unroll
    for (int q = 0; q < kNChunk; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (nc * kNChunk + q) * 8 + 2 * tq + e;
        const int ec = gl * cog + min(n, cog - 1);
        cb[q][e] = eb[ec];
        cf[q][e] = ef[ec];
        co[q][e] = eo[ec];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (n < cog && m0 + gid + 8 * h < n_cols)
            valid |= 1u << (q * 4 + 2 * h + e);
      }
    }
    uint32_t bits = 0;   // bit q*4 + i: slot i of n-tile q fired
    const unsigned char* xa =
        xs + (m0 + gid) * pool * stride * l.pitch + gl * slot + tq * 8;
    // B row (gl, j, n = (nc*2 + q)*8 + gid), this thread's 8 bytes of a
    // k-step
    const unsigned char* wb =
        ws + (gl * k * cog + nc * kNChunk * 8 + gid) * slot + tq * 8;
    for (int r = 0; r < pool; ++r) {
      float nz[kNChunk][4];
      if (kNoise) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // conv column of row m0 + gid + 8h (clamped: a masked slot)
          const int t = min((p0 + m0 + gid + 8 * h) * pool + r,
                            P.noise_t - 1);
          const float* src = P.noise + ((size_t)b * P.noise_t + t) * P.c_out +
                             g * cog;
#pragma unroll
          for (int q = 0; q < kNChunk; ++q) {
            const int n = (nc * kNChunk + q) * 8 + 2 * tq;
            if (cog % 2 == 0) {       // pairs 8-byte aligned: one load
              const float2 v = __ldg(
                  reinterpret_cast<const float2*>(src + min(n, cog - 2)));
              nz[q][2 * h] = v.x;
              nz[q][2 * h + 1] = v.y;
            } else {
              nz[q][2 * h] = __ldg(src + min(n, cog - 1));
              nz[q][2 * h + 1] = __ldg(src + min(n + 1, cog - 1));
            }
          }
        }
      }
      int acc[kNChunk][4];
#pragma unroll
      for (int q = 0; q < kNChunk; ++q)
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0;
      const unsigned char* xr = xa + r * stride * l.pitch;
#pragma unroll 3
      for (int j = 0; j < k; ++j) {
        for (int ks = 0; ks < steps; ++ks) {
          const unsigned char* xj = xr + j * l.pitch + ks * kStep;
          const uint2 lo = *reinterpret_cast<const uint2*>(xj);
          const uint2 hi =
              *reinterpret_cast<const uint2*>(xj + row_step * l.pitch);
          uint2 bw[kNChunk];
#pragma unroll
          for (int q = 0; q < kNChunk; ++q)
            bw[q] = *reinterpret_cast<const uint2*>(
                wb + (j * cog + q * 8) * slot + ks * kStep);
#pragma unroll
          for (int q = 0; q < kNChunk; ++q)
            mma_s8(acc[q], lo.x, hi.x, lo.y, hi.y, bw[q].x, bw[q].y);
        }
      }
#pragma unroll
      for (int q = 0; q < kNChunk; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pre = __int2float_rn(acc[q][i]);
          pre = __fadd_rn(pre, co[q][i & 1]);
          pre = __fadd_rn(pre, cb[q][i & 1]);
          if (kNoise) pre = __fadd_rn(pre, nz[q][i]);
          pre = __fmul_rn(pre, cf[q][i & 1]);
          bits |= (pre >= 0.f ? 1u : 0u) << (q * 4 + i);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kNChunk; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = (nc * kNChunk + q) * 8 + 2 * tq + (i & 1);
        const int m = m0 + gid + (i >= 2 ? 8 : 0);
        if ((valid >> (q * 4 + i)) & 1u)
          os[m * c_chunk + n * gc + gl] =
              (bits >> (q * 4 + i)) & 1u ? 1 : -1;
      }
    }
  }
  __syncthreads();

  // 3. Store the tile: element e of the staged tile is pooled column
  // e / c_chunk, shuffled channel a*groups + g0 + gl with
  // e % c_chunk = a*gc + gl.  Four at a time when the destination runs
  // are 16-byte aligned (all groups, or chunks of a multiple of 4).
  const int groups = P.groups, c_out = P.c_out;
  const bool vec = gc == groups ? c_out % 4 == 0
                                : gc % 4 == 0 && groups % 4 == 0;
  const int total = n_cols * c_chunk;
  float* ob = P.out + ((size_t)b * P.t_pool + p0) * c_out + g0;
  if (vec) {
    for (int e = tid * 4; e < total; e += kThreads * 4) {
      const int p = fdiv(e, P.by_c_chunk), rem = e - p * c_chunk;
      const int a = fdiv(rem, P.by_gc), gl = rem - a * gc;
      const uint32_t s = *reinterpret_cast<const uint32_t*>(os + e);
      float4 v;
      v.x = (float)(int8_t)(s & 0xff);
      v.y = (float)(int8_t)((s >> 8) & 0xff);
      v.z = (float)(int8_t)((s >> 16) & 0xff);
      v.w = (float)(int8_t)(s >> 24);
      *reinterpret_cast<float4*>(ob + (size_t)p * c_out + a * groups + gl) =
          v;
    }
  } else {
    for (int e = tid; e < total; e += kThreads) {
      const int p = fdiv(e, P.by_c_chunk), rem = e - p * c_chunk;
      const int a = fdiv(rem, P.by_gc), gl = rem - a * gc;
      ob[(size_t)p * c_out + a * groups + gl] = (float)os[e];
    }
  }
}

// The most dynamic shared memory a block of the current device may take.
int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return kSmemBudget;
  return bytes;
}

template <bool kNoise, bool kOneStep, bool kVecX>
int launch_kernel(const Params& P, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = imc_fused_kernel<kNoise, kOneStep, kVecX>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <bool kNoise>
int launch_variant(const Params& P, dim3 grid, int smem, cudaStream_t s) {
  const bool one = P.steps == 1, vec = P.cpg % 4 == 0;
  if (one && vec) return launch_kernel<kNoise, true, true>(P, grid, smem, s);
  if (one) return launch_kernel<kNoise, true, false>(P, grid, smem, s);
  if (vec) return launch_kernel<kNoise, false, true>(P, grid, smem, s);
  return launch_kernel<kNoise, false, false>(P, grid, smem, s);
}

}  // namespace

extern "C" {

// The block tile the launch takes for a layer call on a card of `sms`
// SMs: writes (pt, gc) to tile[0..1] and returns the block's shared-memory
// bytes, or 0 if no tile fits.
int imc_fused_plan(int B, int t_pool, int groups, int cog, int k, int cpg,
                   int stride, int pool, int sms, int* tile) {
  const Tile t = plan_tile(B, t_pool, groups, cog, k, cpg, stride, pool, sms,
                           smem_optin());
  tile[0] = t.pt;
  tile[1] = t.gc;
  return t.bytes;
}

// Launches one layer on `stream`, in blocks of the planned tile for a card
// of `sms` SMs; returns cudaGetLastError() (0 = queued), or -1 if no tile
// fits the shared memory of a block (nothing launched).
int imc_fused_launch(const float* x, const int8_t* wq, const float* bias,
                     const float* flip, const float* off, const float* noise,
                     float* out, int B, int T, int c_in, int k, int cpg,
                     int c_out, int groups, int stride, int pool, int t_pool,
                     int noise_t, int sms, void* stream) {
  if (cpg < 1 || c_in != groups * cpg || c_out % groups != 0)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.x = x, P.wq = wq, P.bias = bias, P.flip = flip, P.off = off;
  P.noise = noise, P.out = out;
  P.T = T, P.c_in = c_in, P.k = k, P.cpg = cpg, P.cog = c_out / groups;
  P.c_out = c_out, P.groups = groups, P.stride = stride, P.pool = pool;
  P.t_pool = t_pool, P.noise_t = noise_t;
  P.slot = slot_bytes(cpg);
  P.steps = P.slot / kStep;
  const Tile tile = plan_tile(B, t_pool, groups, P.cog, k, cpg, stride, pool,
                              sms, smem_optin());
  if (tile.bytes == 0) return -1;
  const int pt = tile.pt, gc = tile.gc;
  P.pt = pt, P.gc = gc;
  P.l = layout(pt, gc, k, P.cog, P.slot, stride, pool);
  P.by_quads = make_fastdiv(std::max(gc * cpg / 4, 1));
  P.by_cpg = make_fastdiv(cpg);
  P.by_row_words = make_fastdiv(gc * P.slot / 4);
  P.by_slot_words = make_fastdiv(P.slot / 4);
  P.by_c_chunk = make_fastdiv(gc * P.cog);
  P.by_gc = make_fastdiv(gc);
  P.by_mt = make_fastdiv(P.l.mt);
  P.by_chunks = make_fastdiv(((P.cog + 7) / 8 + kNChunk - 1) / kNChunk);
  const dim3 grid(groups / gc, (t_pool + pt - 1) / pt, B);
  return noise != nullptr
             ? launch_variant<true>(P, grid, P.l.bytes, (cudaStream_t)stream)
             : launch_variant<false>(P, grid, P.l.bytes,
                                     (cudaStream_t)stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
