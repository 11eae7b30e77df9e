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
// ridge, so the floor is the bytes at 3.35 TB/s.  One thread per element
// with coalesced float loads reaches that floor at large N; at the
// customization path's shape (B sessions x 5770 head elements, ~0.2 MB)
// the launch latency sets its time, which no layout can change.
//
// Layouts (all fp32, contiguous): w, g, a, wo, ao (rows, n); the
// row-batched entry takes lr and g_th as (rows,) device arrays, the flat
// entry as scalars.  Grid: (ceil(n / 256), rows), a plain tail guard.

#include <cuda_runtime.h>
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
                  const float* __restrict__ th_rows, float lr, float g_th,
                  float w_scale, float lo, float hi, float a_scale,
                  float* __restrict__ wo, float* __restrict__ ao, int n) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  if (lr_rows != nullptr) {
    lr = lr_rows[row];
    g_th = th_rows[row];
  }
  const size_t i = (size_t)row * n + col;
  sga_element(w[i], g[i], a[i], lr, g_th, w_scale, lo, hi, a_scale, wo + i,
              ao + i);
}

int launch(const float* w, const float* g, const float* a,
           const float* lr_rows, const float* th_rows, float lr, float g_th,
           float* wo, float* ao, int rows, int n, float w_scale, float lo,
           float hi, float a_scale, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  sga_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      w, g, a, lr_rows, th_rows, lr, g_th, w_scale, lo, hi, a_scale, wo, ao,
      n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: `rows` optimizer states of `n` elements, each row with its own
// learning rate and threshold (device arrays).  Returns cudaGetLastError().
int sga_update_rows_launch(const float* w, const float* g, const float* a,
                           const float* lr, const float* g_th, float* wo,
                           float* ao, int rows, int n, float w_scale,
                           float lo, float hi, float a_scale, void* stream) {
  return launch(w, g, a, lr, g_th, 0.0f, 0.0f, wo, ao, rows, n, w_scale, lo,
                hi, a_scale, stream);
}

// K3: one flat state of `n` elements with scalar learning rate and
// threshold.  Returns cudaGetLastError().
int sga_update_launch(const float* w, const float* g, const float* a,
                      float lr, float g_th, float* wo, float* ao, int n,
                      float w_scale, float lo, float hi, float a_scale,
                      void* stream) {
  return launch(w, g, a, nullptr, nullptr, lr, g_th, wo, ao, 1, n, w_scale,
                lo, hi, a_scale, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
