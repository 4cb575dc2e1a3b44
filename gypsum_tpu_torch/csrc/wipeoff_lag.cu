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
// What bounds it on the H100: neither bytes nor operations. One call reads
// the chunk (16 KB), S windows of L + 2K floats (98 KB at S = 12) and writes
// S x 2 x (2K+1) floats: about 35 ns at 3.35 TB/s, and S x L x (4 (2K+1) +
// ~12) operations, about 9 ns at the float32 peak. Its floor is the duration
// of a kernel that does nothing (about 1 us on this card), and what stands
// above that floor is the longest chain of dependent steps inside one block:
// parameters -> window -> sincosf -> dot products -> the sum across blocks.
// A caller in a Python loop does not see any of it: one call costs the host
// some 20 us (PERF.md has both times).
//
// Design: a grid of (n_split, S) blocks, n_split chosen by the wrapper so
// that the grid is about one wave on the card (8 at S = 12). Block (r, s)
// takes samples [r seg_len, (r + 1) seg_len) of channel s, cut at L (the
// wrapper's lag_segments; seg_len arrives as a plain int). A thread wipes
// one sample with one sincosf into shared memory, beside the segment's
// window of seg + n_lags - 1 replica samples; then the block's warps take
// the lags round robin, each lag a strided fused multiply-add over the
// segment and five shuffles. The blocks of one channel are one thread block
// cluster: each writes its partial sums into block 0's shared memory, and
// after a cluster barrier block 0 adds them in block order, so two runs give
// the same bits (the scan tracker integrates these sums for 1000 ms; atomics
// in arrival order would make a replay differ from run to run). The TPU
// kernel's lane rotate, its 8-row sublane padding and its 128-lane output
// padding are TPU layout and are not carried over.
//
// Numerics: float32, sincosf, no fast math; the phase is (c * f) * l + theta
// with c = (float)(2 pi / fs), each step rounded (the build's -fmad=false),
// the TPU kernel's own order. The dot products use __fmaf_rn: for the +/-1
// replicas of every path the product is exact, so the result is what a
// multiply and an add give; for other inputs it differs in the last bit. The
// plain version (gypsum_tpu_torch/ops/wipeoff_lag.py) computes the same terms
// and sums them in another order.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // 16 warps: one lag each up to 16 lags
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLags = 33;  // 2K+1 with K <= 16; the wrapper checks
constexpr int kLagsPerWarp = (kMaxLags + kWarps - 1) / kWarps;
constexpr int kTile = 512;     // samples of a segment in shared memory at once
constexpr int kDotUnroll = 8;  // shared-memory loads a lane has in flight
constexpr int kMaxSplit = 8;   // the portable cluster size

__global__ void __launch_bounds__(kThreads)
wipeoff_lag_kernel(const float* __restrict__ chunk,   // [2, L]
                   const float* __restrict__ wide,    // [S, W]
                   const float* __restrict__ params,  // [S, 3]
                   float* __restrict__ out,           // [S, 2, n_lags]
                   int length, int w_len, int n_lags, int seg_len,
                   float two_pi_over_fs) {
  __shared__ float swin[kTile + kMaxLags - 1];
  __shared__ float sa[kTile];
  __shared__ float sb[kTile];
  // Block 0's copy collects every block's partial sums.
  __shared__ float gathered[kMaxSplit][2 * kMaxLags];

  // Every block of the cluster must run before another writes into its
  // shared memory: arrive now, wait just before the first such write.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

  const int s = blockIdx.y;
  const int rank = blockIdx.x;  // the cluster spans the grid's x
  const int n_split = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float theta = params[3 * s + 0];
  const float rate = two_pi_over_fs * params[3 * s + 1];
  int base = static_cast<int>(params[3 * s + 2]);
  // Keep every read inside the row whatever the caller passed.
  const int base_max = w_len - length - (n_lags - 1);
  base = base < 0 ? 0 : (base > base_max ? base_max : base);
  const float* win = wide + static_cast<size_t>(s) * w_len + base;
  const float* ci = chunk;
  const float* cq = chunk + length;

  // This block's samples: lag_segments(length, n_split)[rank] of the wrapper.
  int seg_start = rank * seg_len;
  seg_start = seg_start < length ? seg_start : length;
  int seg_stop = seg_start + seg_len;
  seg_stop = seg_stop < length ? seg_stop : length;

  float acc_a[kLagsPerWarp];
  float acc_b[kLagsPerWarp];
#pragma unroll
  for (int j = 0; j < kLagsPerWarp; ++j) {
    acc_a[j] = 0.0f;
    acc_b[j] = 0.0f;
  }

  for (int t0 = seg_start; t0 < seg_stop; t0 += kTile) {
    const int tile_n = seg_stop - t0 < kTile ? seg_stop - t0 : kTile;
    for (int i = threadIdx.x; i < tile_n + n_lags - 1; i += kThreads) swin[i] = win[t0 + i];
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
      const int l = t0 + i;
      const float phase = theta + rate * static_cast<float>(l);
      float sn, c;
      sincosf(phase, &sn, &c);
      const float iv = ci[l];
      const float qv = cq[l];
      sa[i] = iv * c + qv * sn;
      sb[i] = qv * c - iv * sn;
    }
    __syncthreads();
    // Warp w takes lags w, w + kWarps, ...: window slice k against the wiped
    // samples, a lane's terms in ascending sample order, kDotUnroll loads
    // ahead of their multiply-adds. A term past the tile's end is 0 x 0 and
    // leaves the sum as it is.
#pragma unroll
    for (int j = 0; j < kLagsPerWarp; ++j) {
      const int k = warp + kWarps * j;
      if (k < n_lags) {
        for (int i0 = lane; i0 < tile_n; i0 += 32 * kDotUnroll) {
          float w[kDotUnroll], a[kDotUnroll], b[kDotUnroll];
#pragma unroll
          for (int u = 0; u < kDotUnroll; ++u) {
            const int i = i0 + 32 * u;
            const bool in_tile = i < tile_n;
            w[u] = in_tile ? swin[i + k] : 0.0f;
            a[u] = in_tile ? sa[i] : 0.0f;
            b[u] = in_tile ? sb[i] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kDotUnroll; ++u) {
            acc_a[j] = __fmaf_rn(w[u], a[u], acc_a[j]);
            acc_b[j] = __fmaf_rn(w[u], b[u], acc_b[j]);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites what the warps just read
  }

  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* sums = cluster.map_shared_rank(&gathered[0][0], 0) + rank * 2 * kMaxLags;
#pragma unroll
  for (int j = 0; j < kLagsPerWarp; ++j) {
    const int k = warp + kWarps * j;
    if (k < n_lags) {
      float va = acc_a[j];
      float vb = acc_b[j];
      for (int off = 16; off > 0; off >>= 1) {
        va += __shfl_down_sync(0xffffffffu, va, off);
        vb += __shfl_down_sync(0xffffffffu, vb, off);
      }
      if (lane == 0) {
        sums[k] = va;
        sums[kMaxLags + k] = vb;
      }
    }
  }

  // Every block has written its sums into block 0's shared memory; the
  // barrier's release and acquire make them visible there. Block 0 adds them
  // in block order, one of the 2 n_lags results per thread: plane 0 (I) then
  // plane 1 (Q).
  cluster.sync();
  if (rank == 0 && threadIdx.x < 2 * n_lags) {
    const int plane = threadIdx.x / n_lags;
    const int k = threadIdx.x - plane * n_lags;
    float v = 0.0f;
    for (int r = 0; r < n_split; ++r) v += gathered[r][plane * kMaxLags + k];
    out[(static_cast<size_t>(s) * 2 + plane) * n_lags + (n_lags - 1 - k)] = v;
  }
}

}  // namespace

// n_split blocks per channel, block r on samples [r seg_len, (r + 1) seg_len)
// cut at length.
extern "C" int wipeoff_lag_f32(const float* chunk, const float* wide,
                               const float* params, float* out, int s_count,
                               int length, int w_len, int n_lags, int n_split,
                               int seg_len, float two_pi_over_fs, void* stream) {
  if (n_lags < 1 || n_lags > kMaxLags || w_len < length + n_lags - 1 || n_split < 1 ||
      n_split > kMaxSplit || seg_len < 1 || static_cast<long long>(seg_len) * n_split < length) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s_count <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, s_count);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;  // the blocks of one channel
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, wipeoff_lag_kernel, chunk, wide, params, out,
                                       length, w_len, n_lags, seg_len, two_pi_over_fs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
