// sga_update: the fused Small-Gradient-Accumulation optimizer update.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/sga_update/
// sga_update.py: `sga_update_rows` (line 57, `_sga_rows_kernel`: B rows,
// one learning rate and threshold per row) and `sga_update` (line 89,
// `_sga_kernel`: one flat vector with static scalars).  Both compute, per
// element, the paper's Algorithm 1 bank, the SGD step and the Q1.7
// weight round/clip:
//
//   small  = |g| < g_th
//   banked = rint((a + (small ? g : 0)) / a_scale) * a_scale
//   fire   = small && |banked| >= g_th
//   g_upd  = small ? (fire ? banked : 0) : g
//   new_a  = fire ? 0 : banked
//   new_w  = clamp(rint((w - lr * g_upd) / w_scale) * w_scale, lo, hi)
//
// with lo = -w_max - w_scale and hi = w_max computed by the caller in
// double precision, as the reference's Python constants are.  Bit-identity
// with the reference rests on four choices: rintf (round half to even,
// like jnp.round), IEEE division, and the product lr * g_upd rounded
// before the difference (explicit __fmul_rn / __fsub_rn / __fdiv_rn, which
// the compiler never contracts into an FMA; the build also passes
// --fmad=false); the clamp propagates NaN like jnp.clip.
//
// What bounds it on an H100: it reads w, g and a and writes w and a, 20
// bytes per element, and does a dozen operations on them: far below the
// ridge, so the floor is the bytes at 3.35 TB/s, and below a few hundred
// thousand elements the launch latency (~1 us).  The row entry (K2) runs one
// thread per element over a (ceil(n / 256), rows) grid with a plain tail
// guard: at the customization path's shape (B sessions x 5770 head
// elements, ~0.2 MB) the launch latency sets its time, which no layout can
// change.  So the customization path runs the whole epoch around it, and
// all of a tick's epochs, in one launch of a third entry,
// `head_train_rows` (below); the per-epoch row entry stays for sessions
// that draw RGP noise or lie outside that entry's exactness bound.
//
// The flat entry (K3) updates a whole parameter tree in one launch, so the
// launch floor is paid once a tree, not once a leaf.  Its parameter block
// (`TreeParams`, passed by value as a __grid_constant__) holds up to
// kTreeLeaves leaf descriptors (w, g, a, wo, ao and n) and the prefix of
// their block counts; each block finds its leaf by a binary search of that
// prefix, and each thread updates one element of it.  The leaves stay
// where they are: a concatenated copy would triple the bytes.  A larger
// tree takes ceil(leaves / kTreeLeaves) launches (the wrapper splits it).
// One float a thread already streams a large leaf at 0.85-0.87 of the
// bytes bound (2**26 elements on an H100); four float4s a thread, tried
// on aligned leaves, measured no faster there and 1.4-3x slower on small
// trees, where the time is one thread's chain of two dependent IEEE
// divisions over a few blocks.  Both entries compute `sga_element`.
//
// Layouts (all fp32, contiguous): the row entry w, g, a, wo, ao (rows, n),
// lr and g_th (rows,) device arrays; the flat entry one (n,) vector per
// leaf, lr and g_th scalars.

#include <cuda_runtime.h>
#include <algorithm>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sga_element(
    float w, float g, float a, float lr, float g_th, float w_scale,
    float lo, float hi, float a_scale, float* wo, float* ao) {
  const bool small = fabsf(g) < g_th;
  const float banked =
      __fmul_rn(rintf(__fdiv_rn(__fadd_rn(a, small ? g : 0.0f), a_scale)),
                a_scale);
  const bool fire = small && fabsf(banked) >= g_th;
  const float g_upd = small ? (fire ? banked : 0.0f) : g;
  *ao = fire ? 0.0f : banked;
  const float stepped = __fsub_rn(w, __fmul_rn(lr, g_upd));
  const float q = __fmul_rn(rintf(__fdiv_rn(stepped, w_scale)), w_scale);
  *wo = q < lo ? lo : (q > hi ? hi : q);
}

__global__ void __launch_bounds__(kThreads)
sga_update_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ a,
                  const float* __restrict__ lr_rows,
                  const float* __restrict__ th_rows, float w_scale,
                  float lo, float hi, float a_scale, float* __restrict__ wo,
                  float* __restrict__ ao, int n) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const size_t i = (size_t)row * n + col;
  sga_element(w[i], g[i], a[i], lr_rows[row], th_rows[row], w_scale, lo, hi,
              a_scale, wo + i, ao + i);
}

// ---------------------------------------------------------------------------
// The flat entry: every leaf of a tree in one launch.

constexpr int kTreeLeaves = 64;                 // leaves in one launch

struct TreeLeaf {
  const float* w;
  const float* g;
  const float* a;
  float* wo;
  float* ao;
  long long n;
};

// 64 x 48 + 65 x 4 + 28 = 3360 bytes, inside the 4 KB of a kernel's
// classic parameter space.
struct TreeParams {
  TreeLeaf leaf[kTreeLeaves];
  int first_block[kTreeLeaves + 1];             // prefix of block counts
  int n_leaves;
  float lr, g_th, w_scale, lo, hi, a_scale;
};

__global__ void __launch_bounds__(kThreads)
sga_tree_kernel(const __grid_constant__ TreeParams P) {
  const int b = blockIdx.x;
  int l = 0, r = P.n_leaves - 1;          // the last leaf that starts at or
  while (l < r) {                         // before block b
    const int mid = (l + r + 1) >> 1;
    if (P.first_block[mid] <= b) l = mid; else r = mid - 1;
  }
  const TreeLeaf& L = P.leaf[l];
  const long long i =
      (long long)(b - P.first_block[l]) * kThreads + threadIdx.x;
  if (i < L.n)
    sga_element(L.w[i], L.g[i], L.a[i], P.lr, P.g_th, P.w_scale, P.lo, P.hi,
                P.a_scale, L.wo + i, L.ao + i);
}

// ---------------------------------------------------------------------------
// head_train_rows: a training tick's whole head-training budget in one
// launch.
//
// Replaces, on the customization path, the per-epoch chain of the JAX
// package's `serving/customize.py::_train_round`: a jitted `epoch_grads`
// per session (src/repro/core/onchip_training.py:169-220) feeding one
// `sga_update_rows` Pallas launch per epoch (sga_update.py:57).  Each
// block is one session row and runs its own budget of epochs, from its own
// epoch index, on (w, b, accum) held in shared memory:
//
//   z     = act_q(F @ w + b)                          (N, C) logits
//   p     = round(lut[idx(z - max z)] / max(sum, 1/256) * 256) / 256
//   err   = err_q((p - onehot) * scale)       scale fixed, 1, or 2**s with
//                                             s = ceil/floor(log2(1 / max|p - onehot|))
//   gw    = grad_q((F^T @ err) * (1 / N)),  gb = grad_q(sum_n err * (1 / N))
//   (w, accum) <- sga_element(w, gw, accum, lr(e), (w_scale / 2) / lr(e))
//
// with lr(e) = max(lr_init * 2**-(e / halve_every), lr_min), the float32
// arithmetic of `lr_schedule` (a power-of-two scaling).  Quantizers
// multiply by their power-of-two inverse scale (exact, as the division is),
// round half to even and clamp to their codes.
//
// Exactness.  Every product and sum of the loop lies on a fixed-point
// grid: F (act grid) x w (weight grid) and F x err (error grid) are exact
// float32 products, and their sums stay exact in any order while their
// magnitude, counted in units of the product grid, stays at most 2**24.
// The caller routes a session here only inside that bound
// (`core/onchip_training.py::head_train_exact`: D max|act| max|w| + max|b|
// and N max|act| max|err|; the paper formats hold it up to N = 1024).  So
// the warp-shuffle reductions below are bitwise equal to the reference's
// matmuls; the division by the LUT denominator is a single IEEE division
// (__fdiv_rn), as in the reference; the batch means multiply by 1 / N, one
// IEEE division per row (__fdiv_rn(1, N), then __fmul_rn), because XLA
// compiles the reference's jitted `/ n` into a product with the float32
// reciprocal; and the dynamic exponent is read from the
// exponent bits of the IEEE quotient 1 / max|err| (mantissa 1.0 means an
// exact power of two: floor and ceil agree), which equals the reference's
// log2 on every value k / 256 the loop can meet (chip_smoke.py holds all
// 257).  --fmad=false and the __f*_rn intrinsics keep every other rounding
// where the reference has it.
//
// What bounds it on an H100, and the design.  One epoch of the paper head
// (N = 10, D = 576, C = 10) is 2 N D C = 115 k multiply-adds, forward and
// gradient, and a tick of ten epochs of three sessions moves ~115 KB per
// session (state in and out, features, labels): both bounds are ~0.1 us
// (bytes at 3.35 TB/s, fp32 operations at 67 TFLOP/s).  A 10-wide C fills
// no mma tile, and the operations are too few to matter, so the products
// run on CUDA cores in fp32; the time is set by the serial chain of
// epochs, each one SM's work between block-wide barriers (most of it the
// per-element gradient and update: a long dependent chain for each of the
// 5770 elements, on 16 warps).  So:
// * one block per session row, its state in shared memory for the whole
//   budget (w and accum transposed to (C, D), so that lanes walk D; 2 x
//   5770 floats = 46 KB at the paper head), with the 256-entry LUT and the
//   (N, C) logits / errors; state is read once and written once;
// * the features are staged in shared memory when they fit (23 KB at
//   N = 10), else read from L2 every epoch: N has no limit of its own;
// * the forward is one warp per utterance, lanes splitting D and holding
//   up to 16 class sums each, reduced by shuffles; the softmax one thread
//   per utterance; the gradient and the update one thread per element of
//   (w, b), so the update needs no second pass;
// * 512 threads: 16 warps cover N = 10 utterances in one forward round and
//   the 5770 elements in 12 per thread.
// The learning rate is computed on the device, so a launch needs no copy
// from the host: everything a row needs (pointers, N, start, budget) rides
// in the kernel's parameters, up to kHeadRows rows a launch.

constexpr int kHeadThreads = 512;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadRows = 48;     // rows in one launch's parameters
constexpr int kClassChunk = 16;   // class sums a lane holds in the forward
constexpr int kLut = 256;

struct HeadRow {
  float* w;              // (D, C), updated in place
  float* b;              // (C,)
  float* aw;             // (D, C) SGA banks
  float* ab;             // (C,)
  const float* feats;    // (N, D) on the activation grid
  const float* onehot;   // (N, C)
  int n, start, epochs, stage;   // stage: features staged in shared memory
};

struct QFmt {             // value = clamp(rint(x * inv), lo, hi) * scale
  float scale, inv, lo, hi;
};

struct HeadParams {
  HeadRow rows[kHeadRows];
  const float* lut;      // (256,) Q0.8 exp table
  int d, c, n_max, feat_floats;
  QFmt act, err, grad;
  float lut_min, lut_inv_step;
  float w_scale, lo, hi, a_scale, half_lsb;   // sga_element, threshold
  float lr_init, lr_min;
  int halve_every;
  int scale_mode;        // 0 fixed, 1 ceil(log2), 2 floor(log2)
  float fixed_scale;
  int max_exponent;      // clamp of the dynamic exponent (INT_MAX: none)
};

__device__ __forceinline__ float quant(float x, const QFmt& f) {
  const float q = rintf(__fmul_rn(x, f.inv));
  return __fmul_rn(fminf(fmaxf(q, f.lo), f.hi), f.scale);
}

// Eq (2)'s exponent from max|err| = m >= 0: s = ceil (mode 1) or floor
// (mode 2) of log2(1 / m), read from the binary exponent of the IEEE
// quotient (a zero mantissa is an exact power of two, where floor and
// ceil agree), clamped above by max_exponent; 0 for m = 0.
__device__ __forceinline__ int error_exponent(float m, int mode,
                                              int max_exponent) {
  if (!(m > 0.0f)) return 0;
  const float inv = __fdiv_rn(1.0f, fmaxf(m, 1.17549435e-38f));
  const unsigned bits = __float_as_uint(inv);
  const int ex = (int)((bits >> 23) & 0xff) - 127;   // floor(log2 inv)
  const int s = (mode == 1 && (bits & 0x7fffff) != 0) ? ex + 1 : ex;
  return min(s, max_exponent);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The parameters stay in the constant bank (__grid_constant__): a block
// reads its row at a runtime index without copying the struct.
__global__ void __launch_bounds__(kHeadThreads)
head_train_kernel(const __grid_constant__ HeadParams P) {
  extern __shared__ __align__(16) float hs[];
  const HeadRow& R = P.rows[blockIdx.x];
  const int D = P.d, C = P.c, N = R.n;
  const int dc = D * C, total = dc + C;
  float* sw = hs;                     // [w^T (C, D) | b (C)]
  float* sa = sw + total;             // [aw^T | ab]
  float* lut = sa + total;            // (256,)
  float* ze = lut + kLut;             // (n_max, C) logits, then errors
  float* red = ze + P.n_max * C;      // (kHeadWarps,) block max
  float* sf = red + kHeadWarps;       // (N, D) staged features
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // state in: coalesced global reads, transposed into shared memory
  for (int i = tid; i < total; i += kHeadThreads) {
    if (i < dc) {
      const int d = i / C, c = i - d * C;
      sw[c * D + d] = R.w[i];
      sa[c * D + d] = R.aw[i];
    } else {
      sw[i] = R.b[i - dc];
      sa[i] = R.ab[i - dc];
    }
  }
  for (int i = tid; i < kLut; i += kHeadThreads) lut[i] = P.lut[i];
  if (R.stage)
    for (int i = tid; i < N * D; i += kHeadThreads) sf[i] = R.feats[i];
  const float* F = R.stage ? sf : R.feats;
  __syncthreads();

  const float inv_n = __fdiv_rn(1.0f, (float)N);   // the batch means' 1 / N
  for (int e = R.start; e < R.start + R.epochs; ++e) {
    const float lr = fmaxf(
        __fmul_rn(P.lr_init, ldexpf(1.0f, -(e / P.halve_every))), P.lr_min);
    const float g_th = __fdiv_rn(P.half_lsb, lr);

    // 1. forward: warp per utterance, lanes over D, class sums in registers
    for (int n = warp; n < N; n += kHeadWarps) {
      const float* fr = F + (size_t)n * D;
      for (int c0 = 0; c0 < C; c0 += kClassChunk) {
        float acc[kClassChunk];
#pragma unroll
        for (int j = 0; j < kClassChunk; ++j) acc[j] = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float x = fr[d];
#pragma unroll
          for (int j = 0; j < kClassChunk; ++j)
            if (c0 + j < C) acc[j] = __fmaf_rn(x, sw[(c0 + j) * D + d], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kClassChunk; ++j) {
          if (c0 + j >= C) break;
          const float z = warp_sum(acc[j]);
          if (lane == j)
            ze[n * C + c0 + j] = quant(__fadd_rn(z, sw[dc + c0 + j]), P.act);
        }
      }
    }
    __syncthreads();

    // 2. LUT softmax and error, a thread per utterance (+ max |err|)
    float mx = 0.0f;
    for (int n = tid; n < N; n += kHeadThreads) {
      float* zr = ze + n * C;
      float zmax = zr[0];
      for (int c = 1; c < C; ++c) zmax = fmaxf(zmax, zr[c]);
      float den = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float t = rintf(__fmul_rn(
            __fsub_rn(__fsub_rn(zr[c], zmax), P.lut_min), P.lut_inv_step));
        const float ev = lut[(int)fminf(fmaxf(t, 0.0f), (float)(kLut - 1))];
        zr[c] = ev;
        den = __fadd_rn(den, ev);
      }
      den = fmaxf(den, 1.0f / 256.0f);
      const float* oh = R.onehot + (size_t)n * C;
      for (int c = 0; c < C; ++c) {
        const float p =
            __fmul_rn(rintf(__fmul_rn(__fdiv_rn(zr[c], den), 256.0f)),
                      1.0f / 256.0f);
        const float er = __fsub_rn(p, oh[c]);
        mx = fmaxf(mx, fabsf(er));
        zr[c] = P.scale_mode == 0 ? quant(__fmul_rn(er, P.fixed_scale), P.err)
                                  : er;
      }
    }
    if (P.scale_mode != 0) {
      // Eq (2): the block's max |err|, then s from the exponent bits
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red[warp] = mx;
      __syncthreads();
      float m = red[0];
      for (int i = 1; i < kHeadWarps; ++i) m = fmaxf(m, red[i]);
      const int s = error_exponent(m, P.scale_mode, P.max_exponent);
      const float scale = __int_as_float((s + 127) << 23);
      for (int i = tid; i < N * C; i += kHeadThreads)
        ze[i] = quant(__fmul_rn(ze[i], scale), P.err);
    }
    __syncthreads();

    // 3. gradient, SGA and the SGD step: a thread per element of (w, b)
    for (int i = tid; i < total; i += kHeadThreads) {
      float g = 0.0f;
      if (i < dc) {
        const int c = i / D, d = i - c * D;
        for (int n = 0; n < N; ++n)
          g = __fmaf_rn(F[(size_t)n * D + d], ze[n * C + c], g);
      } else {
        for (int n = 0; n < N; ++n) g = __fadd_rn(g, ze[n * C + i - dc]);
      }
      g = quant(__fmul_rn(g, inv_n), P.grad);
      sga_element(sw[i], g, sa[i], lr, g_th, P.w_scale, P.lo, P.hi,
                  P.a_scale, sw + i, sa + i);
    }
    __syncthreads();
  }

  // state out, once
  for (int i = tid; i < total; i += kHeadThreads) {
    if (i < dc) {
      const int d = i / C, c = i - d * C;
      R.w[i] = sw[c * D + d];
      R.aw[i] = sa[c * D + d];
    } else {
      R.b[i - dc] = sw[i];
      R.ab[i - dc] = sa[i];
    }
  }
}

// The exponent of each m[i], as head_train_kernel computes it (the card
// check of the exponent on every value the loop can meet).
__global__ void error_exponent_kernel(const float* m, int* s, int n,
                                      int mode, int max_exponent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) s[i] = error_exponent(m[i], mode, max_exponent);
}

// Shared-memory bytes of a block: state, LUT, logits, the block max and
// `feat_floats` staged feature floats.
size_t head_smem(int d, int c, int n_max, int feat_floats) {
  return sizeof(float) * ((size_t)2 * (d * c + c) + kLut + (size_t)n_max * c +
                          kHeadWarps + feat_floats);
}

}  // namespace

extern "C" {

// K2: `rows` optimizer states of `n` elements, each row with its own
// learning rate and threshold (device arrays).  Returns cudaGetLastError().
int sga_update_rows_launch(const float* w, const float* g, const float* a,
                           const float* lr, const float* g_th, float* wo,
                           float* ao, int rows, int n, float w_scale,
                           float lo, float hi, float a_scale, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  sga_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      w, g, a, lr, g_th, w_scale, lo, hi, a_scale, wo, ao, n);
  return (int)cudaGetLastError();
}

// K3's leaf descriptor as the caller passes it (TreeLeaf).
struct TreeLeafArg {
  const float* w;
  const float* g;
  const float* a;
  float* wo;
  float* ao;
  long long n;
};

// Leaves one launch of the flat entry takes.
int sga_update_tree_max_leaves() { return kTreeLeaves; }

// K3: `n_leaves` <= kTreeLeaves flat states, one scalar learning rate and
// threshold, in one launch.  Returns cudaGetLastError() (nothing launched
// when every leaf is empty), or cudaErrorInvalidValue for too many leaves
// or blocks.
int sga_update_tree_launch(const TreeLeafArg* leaves, int n_leaves, float lr,
                           float g_th, float w_scale, float lo, float hi,
                           float a_scale, void* stream) {
  if (n_leaves <= 0) return (int)cudaSuccess;
  if (n_leaves > kTreeLeaves) return (int)cudaErrorInvalidValue;
  TreeParams P;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const TreeLeafArg& s = leaves[i];
    if (s.n < 0) return (int)cudaErrorInvalidValue;
    P.leaf[i] = TreeLeaf{s.w, s.g, s.a, s.wo, s.ao, s.n};
    P.first_block[i] = (int)blocks;
    blocks += (s.n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  P.first_block[n_leaves] = (int)blocks;
  if (blocks == 0) return (int)cudaSuccess;
  P.n_leaves = n_leaves;
  P.lr = lr, P.g_th = g_th, P.w_scale = w_scale, P.lo = lo, P.hi = hi;
  P.a_scale = a_scale;
  sga_tree_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// error_exponent of n values m (>= 0) into s, on `stream`; mode 1 ceil,
// 2 floor.  Returns cudaGetLastError().
int head_error_exponent_launch(const float* m, int* s, int n, int mode,
                               int max_exponent, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  error_exponent_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      m, s, n, mode, max_exponent);
  return (int)cudaGetLastError();
}

// The argument rows of head_train_rows_launch (HeadRow without `stage`,
// which the launch decides).
struct HeadRowArg {
  float* w;
  float* b;
  float* aw;
  float* ab;
  const float* feats;
  const float* onehot;
  int n, start, epochs, unused;
};

// Rows one launch takes.
int head_train_max_rows() { return kHeadRows; }

// Bytes of shared memory a block of `n` utterances needs at least (its
// features read from L2).
int head_train_smem(int d, int c, int n) {
  return (int)head_smem(d, c, n, 0);
}

// A training tick's budget for `n_rows` <= kHeadRows session rows in one
// launch: each row runs rows[i].epochs epochs from rows[i].start on its
// state, in place.  `fmts` holds (scale, 1/scale, min code, max code) of
// the activation, error and gradient formats.  Returns cudaGetLastError(),
// or -1 if a block's state does not fit the device's shared memory
// (nothing launched).
int head_train_rows_launch(const HeadRowArg* rows, int n_rows,
                           const float* lut, int d, int c, const float* fmts,
                           float lut_min, float lut_inv_step, float w_scale,
                           float lo, float hi, float a_scale, float lr_init,
                           float lr_min, int halve_every, int scale_mode,
                           float fixed_scale, int max_exponent,
                           void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  if (n_rows > kHeadRows || d <= 0 || c <= 0 || halve_every <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  HeadParams P;
  P.n_max = 0;
  for (int i = 0; i < n_rows; ++i) P.n_max = std::max(P.n_max, rows[i].n);
  if (head_smem(d, c, P.n_max, 0) > (size_t)optin) return -1;
  // the feature region: the largest row's features that still fit
  P.feat_floats = 0;
  for (int i = 0; i < n_rows; ++i) {
    const int f = rows[i].n * d;
    if (f > P.feat_floats && head_smem(d, c, P.n_max, f) <= (size_t)optin)
      P.feat_floats = f;
  }
  for (int i = 0; i < n_rows; ++i) {
    HeadRow& r = P.rows[i];
    r.w = rows[i].w, r.b = rows[i].b, r.aw = rows[i].aw, r.ab = rows[i].ab;
    r.feats = rows[i].feats, r.onehot = rows[i].onehot;
    r.n = rows[i].n, r.start = rows[i].start, r.epochs = rows[i].epochs;
    r.stage = rows[i].n * d <= P.feat_floats;
  }
  P.lut = lut;
  P.d = d, P.c = c;
  QFmt* q[3] = {&P.act, &P.err, &P.grad};
  for (int i = 0; i < 3; ++i)
    *q[i] = QFmt{fmts[4 * i], fmts[4 * i + 1], fmts[4 * i + 2],
                 fmts[4 * i + 3]};
  P.lut_min = lut_min, P.lut_inv_step = lut_inv_step;
  P.w_scale = w_scale, P.lo = lo, P.hi = hi, P.a_scale = a_scale;
  P.half_lsb = w_scale / 2.0f;
  P.lr_init = lr_init, P.lr_min = lr_min, P.halve_every = halve_every;
  P.scale_mode = scale_mode, P.fixed_scale = fixed_scale;
  P.max_exponent = max_exponent;
  const size_t smem = head_smem(d, c, P.n_max, P.feat_floats);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(head_train_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  head_train_kernel<<<n_rows, kHeadThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
