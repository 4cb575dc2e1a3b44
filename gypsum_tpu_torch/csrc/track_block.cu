// The whole 1 kHz tracking loop of a block in one launch: per millisecond,
// carrier wipeoff of the shared chunk with the channel's NCO state, the
// multiply-reduce of the wiped chunk against every lag of a block-static
// replica window, selection of the 2K+1 lags around the current prompt, and
// the loop filter (triangle measurement, DLL, Costas PLL, EMAs, watchdog).
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_track.py:_track_block_kernel
// (entry make_pallas_track_block_fn), the legacy whole-block tracker behind
// TrackingConfig.use_pallas_block_tracker.
//
// What bounds it on the H100: operations on paper, B x S x (4 NLE L + ~12 L)
// of them (3.6 GFLOP at B = 1000, S = 12, NLE = 35: about 0.05 ms at the
// float32 peak; the samples and windows are 16 MB, 5 us), but what the time
// shows is the chain: the B milliseconds of a channel run in order, three
// block-wide barriers each, on S of the card's 132 SMs.
//
// Design, for the card rather than carried over: the TPU kernel keeps an
// [S, NLE, L] lag matrix resident in VMEM because it cannot slice at a
// dynamic lane offset; every row of that matrix is the same L + 2 K_eff
// window shifted by one sample. Here one thread block per channel holds that
// one window (about 8.3 KB) in shared memory and reads it at shifted
// offsets. Channels are independent, so there is no grid-wide
// synchronisation. Per ms:
//   1. all threads wipe the chunk into shared memory (xr, xi), 8-byte
//      coalesced loads of the interleaved [B, L, 2] samples;
//   2. each warp takes lags j = warp, warp + n_warps, ...: its lanes stride
//      over l and sum win[NLE - 1 - j + l] * x[l] (window slice k is the
//      replica rolled by (cp0 + K_eff - k), so slice NLE - 1 - j is lag
//      cp0 - K_eff + j, ascending), then a shuffle reduction;
//   3. thread 0 selects the lags around the prompt and runs the loop-filter
//      chain (loop_filter.cuh, shared with the fixup kernel), writes the 11
//      outputs and the NCO state for the next ms.
// The loop carry lives in thread 0's registers for the whole block. The TPU
// kernel's (S, 128) lane-mask accumulators, masked-sum gathers and 16-row
// output padding are TPU idiom and are not carried over: outputs are the 11
// meaningful rows, [B, 11, S], the fixup kernel's layout.
//
// Numerics: float32, cosf/sinf, no fast math, -fmad=false. The wipeoff phase
// is (c * f) * l + theta with c = (float)(2 pi / fs), and the NCO advance
// (2 pi * f) * t_ms with no FDMA offset term, both as the TPU kernel computes
// them. The plain version (gypsum_tpu_torch/ops/track_block.py) does the same
// arithmetic and sums the dot products in another order.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>
#include <math.h>

#include "loop_filter.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
track_block_kernel(const float* __restrict__ init,      // [9, S]
                   const float2* __restrict__ samples,  // [B, L] (I, Q)
                   const float* __restrict__ windows,   // [S, L + NLE - 1]
                   float* __restrict__ outs,            // [B, 11, S]
                   float* __restrict__ fin,             // [9, S]
                   int n_ms, int s_count, int nle, float two_pi_over_fs,
                   FixupParams p) {
  extern __shared__ float smem[];
  const int length = p.length;
  const int w_len = length + nle - 1;
  float* win = smem;            // [w_len]
  float* xr = win + w_len;      // [L]
  float* xi = xr + length;      // [L]
  float* all_r = xi + length;   // [NLE]
  float* all_i = all_r + nle;   // [NLE]
  __shared__ float nco[2];      // theta, Doppler for the next wipeoff

  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < w_len; i += kThreads) {
    win[i] = windows[static_cast<size_t>(s) * w_len + i];
  }
  LoopCarry c = load_carry(init, s_count, s);  // used by thread 0 only
  const float cpi0_f = init[kCPI0 * s_count + s];
  const int cpi0 = static_cast<int>(cpi0_f);
  if (threadIdx.x == 0) {
    nco[0] = c.th;
    nco[1] = c.fd;
  }
  __syncthreads();

  for (int b = 0; b < n_ms; ++b) {
    // --- 1. carrier wipeoff: x = chunk * e^{-j(theta + (2 pi / fs) f l)}.
    const float theta = nco[0];
    const float rate = two_pi_over_fs * nco[1];
    const float2* chunk = samples + static_cast<size_t>(b) * length;
    for (int l = threadIdx.x; l < length; l += kThreads) {
      const float phase = theta + rate * static_cast<float>(l);
      const float cs = cosf(phase);
      const float sn = sinf(phase);
      const float2 v = chunk[l];
      xr[l] = v.x * cs + v.y * sn;
      xi[l] = v.y * cs - v.x * sn;
    }
    __syncthreads();

    // --- 2. every lag of the window, ascending.
    for (int j = warp; j < nle; j += kWarps) {
      const float* w = win + (nle - 1 - j);
      float acc_r = 0.0f;
      float acc_i = 0.0f;
      for (int l = lane; l < length; l += 32) {
        const float wv = w[l];
        acc_r += wv * xr[l];
        acc_i += wv * xi[l];
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc_r += __shfl_down_sync(0xffffffffu, acc_r, off);
        acc_i += __shfl_down_sync(0xffffffffu, acc_i, off);
      }
      if (lane == 0) {
        all_r[j] = acc_r;
        all_i[j] = acc_i;
      }
    }
    __syncthreads();

    // --- 3. select, loop filter, outputs (pre-update loop state).
    if (threadIdx.x == 0) {
      int cp_int;
      const int first = select_first_lag(c.cp, cpi0, nle, p, &cp_int);
      const float advance = kTwoPi * c.fd * p.t_ms;
      float* o = outs + static_cast<size_t>(b) * kNOut * s_count + s;
      loop_filter_step(c, all_r + first, all_i + first, cp_int, advance, false,
                       0.0f, p, o, s_count);
      nco[0] = c.th;
      nco[1] = c.fd;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    store_carry(c, fin, s_count, s);
    fin[kCPI0 * s_count + s] = cpi0_f;
  }
}

}  // namespace

extern "C" int track_block_f32(const float* init, const float* samples,
                               const float* windows, float* outs, float* fin,
                               int n_ms, int s_count, int nle,
                               float two_pi_over_fs, const FixupParams* params,
                               void* stream) {
  if (s_count > 0) {
    const int length = params->length;
    const int smem = 4 * ((length + nle - 1) + 2 * length + 2 * nle);
    cudaError_t err = cudaFuncSetAttribute(
        track_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    track_block_kernel<<<s_count, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        init, reinterpret_cast<const float2*>(samples), windows, outs, fin,
        n_ms, s_count, nle, two_pi_over_fs, *params);
  }
  return static_cast<int>(cudaGetLastError());
}
