// One millisecond of the scan tracker's correlator: carrier wipeoff of the
// shared I/Q chunk per channel, fused with the 2K+1 lag-window dot products.
//
//   phase[l] = theta_s + (2 pi / fs) f_s l
//   a[l] = I[l] cos(phase) + Q[l] sin(phase)       (chunk * e^{-j phase})
//   b[l] = Q[l] cos(phase) - I[l] sin(phase)
//   out[s, 0, j] = sum_l wide[s, base_s + k + l] a[l],   j = n_lags - 1 - k
//   out[s, 1, j] = sum_l wide[s, base_s + k + l] b[l]
//
// Window slice k is the replica rolled by (cp + K - k), a descending lag
// order, so entry j = n_lags - 1 - k puts the lags in ascending order.
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_kernels.py:_wipeoff_lag_kernel
// (entry wipeoff_lag_correlate_pallas), the per-ms correlator behind
// TrackingConfig.use_pallas_correlator.
//
// What bounds it on the H100: neither bytes nor operations but the launch.
// One call reads the chunk (16 KB), S windows of L + 2K floats (98 KB at
// S = 12) and writes S x 2 x (2K+1) floats: about 35 ns at 3.35 TB/s, and
// S x L x (4 (2K+1) + ~12) operations, about 9 ns at the float32 peak. The
// scan tracker launches it once per millisecond of signal, so a launch's few
// microseconds are what the time shows.
//
// Design: one block of 256 threads per channel. Each thread wipes a strided
// share of the chunk (neighbouring threads read neighbouring samples and
// neighbouring window words) and accumulates its share of all 2K+1 dot
// products in registers; the block then reduces with warp shuffles and one
// pass through shared memory. The window is read at its dynamic offset
// straight from device memory: the TPU kernel's lane rotate, its 8-row
// sublane padding and its 128-lane output padding are TPU layout and are not
// carried over.
//
// Numerics: float32, cosf/sinf, no fast math, -fmad=false; the phase is
// (c * f) * l + theta with c = (float)(2 pi / fs), the TPU kernel's own
// order. The plain version (gypsum_tpu_torch/ops/wipeoff_lag.py) computes the
// same terms and sums them in another order.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLags = 33;  // 2K+1 with K <= 16; the wrapper checks

__global__ void __launch_bounds__(kThreads)
wipeoff_lag_kernel(const float* __restrict__ chunk,   // [2, L]
                   const float* __restrict__ wide,    // [S, W]
                   const float* __restrict__ params,  // [S, 3]
                   float* __restrict__ out,           // [S, 2, n_lags]
                   int length, int w_len, int n_lags, float two_pi_over_fs) {
  const int s = blockIdx.x;
  const float theta = params[3 * s + 0];
  const float rate = two_pi_over_fs * params[3 * s + 1];
  int base = static_cast<int>(params[3 * s + 2]);
  // Keep every read inside the row whatever the caller passed.
  const int base_max = w_len - length - (n_lags - 1);
  base = base < 0 ? 0 : (base > base_max ? base_max : base);
  const float* win = wide + static_cast<size_t>(s) * w_len + base;
  const float* ci = chunk;
  const float* cq = chunk + length;

  float acc_a[kMaxLags];
  float acc_b[kMaxLags];
#pragma unroll
  for (int k = 0; k < kMaxLags; ++k) {
    acc_a[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  for (int l = threadIdx.x; l < length; l += kThreads) {
    const float phase = theta + rate * static_cast<float>(l);
    const float c = cosf(phase);
    const float sn = sinf(phase);
    const float i = ci[l];
    const float q = cq[l];
    const float a = i * c + q * sn;
    const float b = q * c - i * sn;
#pragma unroll
    for (int k = 0; k < kMaxLags; ++k) {
      if (k < n_lags) {
        const float w = win[k + l];
        acc_a[k] += w * a;
        acc_b[k] += w * b;
      }
    }
  }

  __shared__ float partial[kWarps][2 * kMaxLags];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMaxLags; ++k) {
    if (k < n_lags) {
      float va = acc_a[k];
      float vb = acc_b[k];
      for (int off = 16; off > 0; off >>= 1) {
        va += __shfl_down_sync(0xffffffffu, va, off);
        vb += __shfl_down_sync(0xffffffffu, vb, off);
      }
      if (lane == 0) {
        partial[warp][k] = va;
        partial[warp][kMaxLags + k] = vb;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * n_lags) {
    const int plane = threadIdx.x / n_lags;
    const int k = threadIdx.x - plane * n_lags;
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += partial[w][plane * kMaxLags + k];
    out[(static_cast<size_t>(s) * 2 + plane) * n_lags + (n_lags - 1 - k)] = v;
  }
}

}  // namespace

extern "C" int wipeoff_lag_f32(const float* chunk, const float* wide,
                               const float* params, float* out, int s_count,
                               int length, int w_len, int n_lags,
                               float two_pi_over_fs, void* stream) {
  if (n_lags < 1 || n_lags > kMaxLags || w_len < length + n_lags - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s_count > 0) {
    wipeoff_lag_kernel<<<s_count, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        chunk, wide, params, out, length, w_len, n_lags, two_pi_over_fs);
  }
  return static_cast<int>(cudaGetLastError());
}
