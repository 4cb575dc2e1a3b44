// Per-row (max, first-index argmax, sum) over a [rows, n] float32 matrix.
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_kernels.py:_peak_reduce_kernel
// (entry peak_reduce_pallas), the acquisition engine's coarse peak search
// behind AcquisitionConfig.use_pallas_peak_reduce.
//
// What bounds it on the H100: bytes. The main-path call reads 928 rows x
// 2046 floats (7.6 MB) once and writes 12 bytes per row; at 3.35 TB/s that is
// about 2.3 us, against a few thousand operations per row.
//
// Design: one block of 256 threads per row, so the 928 rows spread over all
// 132 SMs. Threads stride over the row (neighbouring threads read
// neighbouring addresses, so every warp load is coalesced), keep a running
// (max, index, sum) in registers, then reduce across the warp with shuffles
// and across warps through shared memory. Ties go to the lowest index at
// every level: within a thread by a strict '>' over increasing indices,
// across threads by comparing indices when the maxima are equal. The TPU
// kernel streams column tiles through VMEM with a scratch accumulator across
// a sequential grid; on Hopper each row fits one block's loop and needs no
// cross-block state.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Peak {
  float max;
  int idx;
  float sum;
};

__device__ __forceinline__ Peak combine(Peak a, Peak b) {
  Peak r;
  bool take_b = (b.max > a.max) || (b.max == a.max && b.idx < a.idx);
  r.max = take_b ? b.max : a.max;
  r.idx = take_b ? b.idx : a.idx;
  r.sum = a.sum + b.sum;
  return r;
}

__device__ __forceinline__ Peak warp_reduce(Peak p) {
  for (int off = 16; off > 0; off >>= 1) {
    Peak o;
    o.max = __shfl_down_sync(0xffffffffu, p.max, off);
    o.idx = __shfl_down_sync(0xffffffffu, p.idx, off);
    o.sum = __shfl_down_sync(0xffffffffu, p.sum, off);
    p = combine(p, o);
  }
  return p;
}

__global__ void __launch_bounds__(kThreads)
peak_reduce_kernel(const float* __restrict__ x, float* __restrict__ out_max,
                   int* __restrict__ out_arg, float* __restrict__ out_sum,
                   int n) {
  const int row = blockIdx.x;
  const float* xr = x + static_cast<size_t>(row) * n;
  // idx == n marks "no element seen" and loses every tie to a real index.
  Peak p{-INFINITY, n, 0.0f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v = xr[i];
    if (v > p.max) {
      p.max = v;
      p.idx = i;
    }
    p.sum += v;
  }
  p = warp_reduce(p);

  __shared__ Peak warp_peaks[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_peaks[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < kThreads / 32 ? warp_peaks[lane] : Peak{-INFINITY, n, 0.0f};
    p = warp_reduce(p);
    if (lane == 0) {
      out_max[row] = p.max;
      // A row of -inf values: the plain version's argmax is index 0.
      out_arg[row] = p.idx < n ? p.idx : 0;
      out_sum[row] = p.sum;
    }
  }
}

}  // namespace

extern "C" int peak_reduce_f32(const float* x, float* out_max, int* out_arg,
                               float* out_sum, int rows, int n,
                               void* stream) {
  if (rows > 0) {
    peak_reduce_kernel<<<rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, out_max, out_arg, out_sum, n);
  }
  return static_cast<int>(cudaGetLastError());
}
