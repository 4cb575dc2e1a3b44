// Per-row (max, first-index argmax, sum) over a [rows, n] float32 matrix.
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_kernels.py:_peak_reduce_kernel
// (entry peak_reduce_pallas), the acquisition engine's coarse peak search
// behind AcquisitionConfig.use_pallas_peak_reduce.
//
// What bounds it on the H100: bytes. The main-path call reads 928 rows x
// 2046 floats (7.6 MB) once and writes 12 bytes per row; at 3.35 TB/s that is
// about 2.3 us, against a few thousand operations per row. The work is a pure
// stream, so the design keeps many bytes in flight on every SM and sheds
// everything else. The real caller finds the grid warm in the 50 MB L2 (the
// sweep has just written it); there the kernel takes about 3.1 us on an H100
// 80GB HBM3, of which about 1 us is what a kernel that does nothing takes.
// A caller in a Python loop pays some 25 us per call, all of it on the host
// (PERF.md has both times).
//
// Design: one warp per row, kRowsPerBlock rows per block, so the main path's
// 928 rows are one wave on the 132 SMs. There is no shared memory and no
// __syncthreads: a lane walks its row in 16-byte loads (neighbouring lanes on
// neighbouring addresses), kUnroll of them issued before the first compare,
// keeps a running (max, index, sum) in registers, and the warp reduces with
// five shuffles. Rows are n floats apart, so a row starts on a 16-byte
// boundary only by chance (at n = 2046 every second row does): each row is
// split by its own address into a scalar head (up to 3 floats), a float4
// body and a scalar tail. Any 4-byte-aligned base is legal input.
//
// Ties go to the lowest index at every level: a lane sees its elements in
// ascending index order and takes a new maximum only on a strict '>', and
// two lanes with equal maxima compare indices. idx == n marks "no element
// seen" and loses every tie to a real index.
//
// The TPU kernel streams column tiles through VMEM with a scratch accumulator
// across a sequential grid; on Hopper a row is one warp's loop and needs no
// state across blocks.
//
// The three results go into one [3, rows] buffer of 4-byte words (max, argmax
// as int32, sum), so the wrapper makes one allocation.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kUnroll = 8;        // 16-byte loads a lane has in flight

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

__device__ __forceinline__ void take(Peak& p, float v, int i) {
  if (v > p.max) {
    p.max = v;
    p.idx = i;
  }
  p.sum += v;
}

// One lane's share of a row, its elements taken in ascending index order.
__device__ __forceinline__ Peak lane_reduce_row(const float* __restrict__ xr,
                                                int n, int lane) {
  Peak p{-INFINITY, n, 0.0f};
  // Floats before the row's first 16-byte boundary.
  int head = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) >> 2;
  head = head < n ? head : n;
  if (lane < head) take(p, xr[lane], lane);

  const float4* body = reinterpret_cast<const float4*>(xr + head);
  const int n_vec = (n - head) >> 2;
  for (int v0 = 0; v0 < n_vec; v0 += 32 * kUnroll) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + 32 * u + lane;
      q[u] = v < n_vec ? body[v] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + 32 * u + lane;
      if (v < n_vec) {
        const int i = head + 4 * v;
        take(p, q[u].x, i);
        take(p, q[u].y, i + 1);
        take(p, q[u].z, i + 2);
        take(p, q[u].w, i + 3);
      }
    }
  }

  const int tail = head + 4 * n_vec + lane;  // at most 3 floats are left
  if (tail < n) take(p, xr[tail], tail);
  return p;
}

__device__ __forceinline__ void write_row(float* __restrict__ out, int rows,
                                          int row, int n, Peak p) {
  out[row] = p.max;
  // A row of -inf values: the plain version's argmax is index 0.
  reinterpret_cast<int*>(out)[rows + row] = p.idx < n ? p.idx : 0;
  out[2 * rows + row] = p.sum;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
peak_reduce_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int rows, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  Peak p = lane_reduce_row(x + static_cast<size_t>(row) * n, n, lane);
  p = warp_reduce(p);
  if (lane == 0) write_row(out, rows, row, n, p);
}

}  // namespace

// out is [3, rows] 4-byte words: max, argmax (int32), sum.
extern "C" int peak_reduce_f32(const float* x, float* out, int rows, int n,
                               void* stream) {
  if (rows > 0) {
    peak_reduce_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}
