// Anti-alias FIR + decimate by an integer factor on interleaved I/Q samples:
//   y[n] = sum_t taps[t] * x[n * factor + t],   n < (N - T) / factor + 1
// ('VALID'; a correlation with the taps as given, which is what the plain
// version, gypsum_tpu_torch/ops/decimate.py:fir_decimate_planes, computes).
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_kernels.py:_fir_decimate_kernel
// (entry fir_decimate_pallas), the front end's bulk decimator.
//
// What bounds it on the H100: bytes. Every input sample is read once and every
// output written once (one 1000 ms block at 8.184 Msps: 65 MB in, 16 MB out,
// about 25 us at 3.35 TB/s); the arithmetic is 2 T operations per output
// value, T / factor per input value.
//
// Design: one thread per output sample, 256 outputs per block. The block
// first copies its input span, (256 - 1) * factor + T interleaved samples,
// and the taps into shared memory with coalesced 8-byte loads, so each input
// sample crosses from device memory once per block (plus the T - factor
// samples of overlap with the next block); then each thread runs the T taps
// over its own window of the tile, I and Q together as one float2. The
// samples stay interleaved [N, 2] as they lie in memory. The TPU kernel's
// re-layout into 2 * factor polyphase branch rows, its 128-lane halo block
// and its tile % 128 rule exist for the TPU's lanes and are not carried over.
//
// Numerics: float32, taps in ascending order, no fast math, and the build
// passes -fmad=false. The plain version's convolution sums in another order,
// so the two agree to float32 rounding of a T-term sum, not bit for bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fir_decimate_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
                    float2* __restrict__ y, long long n_out, int t_len,
                    int t_pad, int factor) {
  extern __shared__ float smem[];
  float* h = smem;                                         // [t_pad]
  float2* tile = reinterpret_cast<float2*>(smem + t_pad);  // [span]

  const long long out0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = n_out - out0;
  const int n_here = left < kThreads ? static_cast<int>(left) : kThreads;
  const int span = (n_here - 1) * factor + t_len;
  const float2* src = x + out0 * factor;

  for (int i = threadIdx.x; i < t_len; i += kThreads) h[i] = taps[i];
  for (int i = threadIdx.x; i < span; i += kThreads) tile[i] = src[i];
  __syncthreads();

  if (threadIdx.x < n_here) {
    const float2* w = tile + threadIdx.x * factor;
    float acc_i = 0.0f;
    float acc_q = 0.0f;
    for (int t = 0; t < t_len; ++t) {
      const float2 v = w[t];
      acc_i += h[t] * v.x;
      acc_q += h[t] * v.y;
    }
    y[out0 + threadIdx.x] = make_float2(acc_i, acc_q);
  }
}

// Bytes of dynamic shared memory one block needs (the wrapper,
// gypsum_tpu_torch/ops/fir_decimate.py, refuses a filter past the card's limit).
int smem_bytes(int t_len, int factor) {
  const int t_pad = (t_len + 1) & ~1;  // keeps the float2 tile 8-byte aligned
  return 4 * t_pad + 8 * ((kThreads - 1) * factor + t_len);
}

}  // namespace

extern "C" int fir_decimate_f32(const float* x, const float* taps, float* y,
                                long long n_out, int t_len, int factor,
                                void* stream) {
  if (n_out > 0) {
    const int t_pad = (t_len + 1) & ~1;
    const int smem = smem_bytes(t_len, factor);
    cudaError_t err = cudaFuncSetAttribute(
        fir_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (n_out + kThreads - 1) / kThreads;
    fir_decimate_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(x), taps, reinterpret_cast<float2*>(y),
        n_out, t_len, t_pad, factor);
  }
  return static_cast<int>(cudaGetLastError());
}
