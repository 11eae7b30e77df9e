// imc_fused: one whole grouped IMC layer of the KWS net in one launch.
//
// Replaces the Pallas TPU kernel `imc_fused` (src/repro/kernels/imc_mav/
// imc_mav.py:141, with `_fused_kernel`, `_fused_kernel_noise` and
// `_epilogue`).  It computes the same function, not the same blocks:
//
//   counts[b, t, ch] = sum over taps k and group channels c of
//                      x[b, t*stride + k, g*cpg + c] * w[k, c, ch]
//   pre  = ((counts + off) + bias) [+ noise]      (fp32, in this order)
//   act  = (pre * flip) >= 0 ? +1 : -1
//   out[b, tp, a*groups + g] = max over r < pool of act[b, tp*pool + r, g*cog + a]
//
// i.e. grouped ±1 convolution, chip offset, word-line bias, optional
// pre-sign noise operand, BN-decoder flip, SA sign, OR-maxpool and the
// channel shuffle, with no pre-activation ever written to device memory.
// The add order is the reference's (repro/core/imc.py::mav_sa), so the
// result is bit-identical to the plain version in ../ref.py.
//
// What bounds it on an H100: the layer moves its ±1 activations in and out
// of HBM (fp32, 4 bytes each) and does 72 multiply-adds per output
// element, about 48 operations per byte at the paper's first IMC layer.
// That is below the tensor cores' ridge, so the floor is the bytes moved
// at 3.35 TB/s.  The design keeps HBM traffic at that floor: an implicit
// im2col stages each block's input rows once in shared memory (no patch
// tensor in HBM), the counts and the epilogue stay in registers, and one
// thread owns a whole pool window, so OR-pooling needs no exchange between
// threads.  This first version issues the products on the CUDA cores with
// both operands read from shared memory (two loads per product), so in
// practice it is bound by shared-memory loads rather than by HBM; holding
// each thread's 72 weights in registers, or int8 tensor-core products, is
// the next step.
//
// Layouts (all fp32, contiguous):
//   x     (B, T, C_in)            ±1 activations, C_in = groups * cpg
//   wp    (groups, k*cpg, cog)    ±1 weights, group-major (models/kws.py
//                                 packs the reference's (k, cpg, C_out))
//   bias, flip, off   (C_out,)    pre-shuffle channel order; off may be null
//   noise (B, noise_t, C_out)     optional (null), pre-pool rows
//   out   (B, t_pool, C_out)      post-shuffle channel order
// Grid: (groups, ceil(t_pool / kCols), B); one block per group, tile of
// pooled output columns and stream.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // pooled output columns per block

__global__ void __launch_bounds__(kThreads)
imc_fused_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                 const float* __restrict__ bias,
                 const float* __restrict__ flip,
                 const float* __restrict__ off,
                 const float* __restrict__ noise, float* __restrict__ out,
                 int T, int c_in, int k, int cpg, int c_out, int groups,
                 int stride, int pool, int t_pool, int noise_t) {
  extern __shared__ float smem[];
  const int cog = c_out / groups;
  const int kg = k * cpg;
  const int g = blockIdx.x;
  const int p0 = blockIdx.y * kCols;  // first pooled column of the tile
  const int b = blockIdx.z;
  const int n_cols = min(kCols, t_pool - p0);
  const int row0 = p0 * pool * stride;  // first input row the tile reads
  const int n_rows = (n_cols * pool - 1) * stride + k;

  float* w_s = smem;             // [kg][cog]: this group's weights
  float* x_s = smem + kg * cog;  // [n_rows][cpg]: this group's input rows

  const float* wg = wp + (size_t)g * kg * cog;
  for (int i = threadIdx.x; i < kg * cog; i += blockDim.x) w_s[i] = wg[i];
  const float* xb = x + ((size_t)b * T + row0) * c_in + (size_t)g * cpg;
  for (int i = threadIdx.x; i < n_rows * cpg; i += blockDim.x) {
    const int r = i / cpg, c = i - r * cpg;
    x_s[i] = xb[(size_t)r * c_in + c];
  }
  __syncthreads();

  // One thread per (pooled column j, group channel a); consecutive threads
  // take consecutive channels, so weight reads are conflict-free and the
  // input reads are broadcasts.
  for (int item = threadIdx.x; item < n_cols * cog; item += blockDim.x) {
    const int j = item / cog, a = item - j * cog;
    const int ch = g * cog + a;  // pre-shuffle channel
    const float bias_c = bias[ch], flip_c = flip[ch];
    float act = -1.f;
    for (int r = 0; r < pool; ++r) {
      const int t = (p0 + j) * pool + r;  // conv column
      const float* xr = x_s + (size_t)(j * pool + r) * stride * cpg;
      float counts = 0.f;
      for (int q = 0; q < kg; ++q) counts += xr[q] * w_s[q * cog + a];
      float pre = counts;
      if (off != nullptr) pre = pre + off[ch];
      pre = pre + bias_c;
      if (noise != nullptr)
        pre = pre + noise[((size_t)b * noise_t + t) * c_out + ch];
      pre = pre * flip_c;
      act = fmaxf(act, pre >= 0.f ? 1.f : -1.f);
    }
    out[((size_t)b * t_pool + p0 + j) * c_out + (size_t)a * groups + g] = act;
  }
}

}  // namespace

extern "C" {

// Launches one layer on `stream`; returns cudaGetLastError() (0 = queued).
int imc_fused_launch(const float* x, const float* wp, const float* bias,
                     const float* flip, const float* off, const float* noise,
                     float* out, int B, int T, int c_in, int k, int cpg,
                     int c_out, int groups, int stride, int pool, int t_pool,
                     int noise_t, void* stream) {
  const int cog = c_out / groups;
  const int max_rows = (kCols * pool - 1) * stride + k;
  const size_t smem =
      sizeof(float) * ((size_t)k * cpg * cog + (size_t)max_rows * cpg);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        imc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(groups, (t_pool + kCols - 1) / kCols, B);
  imc_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, wp, bias, flip, off, noise, out, T, c_in, k, cpg, c_out, groups,
      stride, pool, t_pool, noise_t);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
