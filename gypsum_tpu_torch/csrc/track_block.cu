// The whole 1 kHz tracking loop of a block in one launch: per millisecond,
// carrier wipeoff of the shared chunk with the channel's NCO state, the
// multiply-reduce of the wiped chunk against the 2K+1 lags around the
// current prompt in a block-static replica window, and the loop filter
// (triangle measurement, DLL, Costas PLL, EMAs, watchdog).
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_track.py:_track_block_kernel
// (entry make_pallas_track_block_fn), the legacy whole-block tracker behind
// TrackingConfig.use_pallas_block_tracker.
//
// What bounds it on the H100: operations on paper, B x S x (4 (2K+1) L +
// ~12 L) of them (1.18 GFLOP at B = 1000, S = 12, K = 4: about 0.018 ms at
// the float32 peak; the samples and windows are 16 MB, 5 us), but what the
// time shows is the chain: the B milliseconds of a channel run in order, on
// S of the card's 132 SMs, each ms a wipe and a reduction across the block
// and then the loop filter before the next ms can start.
//
// Design: one thread block per channel holds the window of L + 2 K_eff
// replica samples in shared memory (the TPU kernel keeps an [S, NLE, L] lag
// matrix in VMEM because it cannot slice at a dynamic lane offset; every row
// of that matrix is the same window shifted by one sample). Warp 0 runs the
// chain; the other warps ("workers") wipe and correlate.
// - Only the 2K+1 lags the chain reads are summed. Their window slices
//   (NLE - 1 - (first + m), m = 0..2K) are known before the ms starts: the
//   chain's code phase after the previous ms fixes `first`. The TPU kernel
//   sums all NLE lags and selects by masked sums, its idiom, not the
//   function: 3.9x the work at NLE = 35.
// - Register tiles: a worker takes kTile consecutive samples, wipes them in
//   registers (sincosf, the samples prefetched one ms ahead into a
//   shared-memory ring with cp.async by the thread that reads them) and
//   holds a sliding run of kTile + 8 window values, read as float4 from one
//   of four copies of the window shifted by 0-3 floats (the slice's start
//   depends on the carry, so only a shifted copy makes every load aligned);
//   it sums partial products for 9 lags at a time (one group at K = 4).
//   Each warp reduces its partial sums with a reduce-scatter of shuffles
//   (reduce_scatter), and warp 0 adds the warps' sums as a tree: a fixed
//   order, so two runs give the same bits.
// - The chain is split (loop_filter.cuh: head, then tail): as soon as the
//   head has the next ms's NCO state and code phase, warp 0 publishes them
//   and releases the workers, and the tail (sub-sample measurement, the 11
//   outputs) runs while they wipe the next ms. Two named barriers a ms: the
//   publish (warp 0 arrives, workers wait) and the partial sums (workers
//   arrive, warp 0 waits). The EMAs' bias corrections are precomputed 32 ms
//   at a time by warp 0's lanes, off the chain, and the head runs its
//   divisions and floor-mods without branches, each proven exact, and again
//   with the exact operations where a proof fails (loop_filter_head).
// The loop carry lives in warp 0 lane 0's registers for the whole block.
// Outputs are the 11 meaningful rows, [B, 11, S], the fixup kernel's layout
// (the TPU kernel pads to 16 rows for its sublanes).
//
// Numerics: float32, sincosf, no fast math,
// -fmad=false except in the dot products, which use __fmaf_rn: the replicas are +/-1, so each product is
// exact and the fused add rounds as the separate add would. The wipeoff
// phase is (c * f) * l + theta with c = (float)(2 pi / fs), and the NCO
// advance (2 pi * f) * t_ms with no FDMA offset term, both as the TPU kernel
// computes them. The plain version (gypsum_tpu_torch/ops/track_block.py)
// does the same arithmetic and sums the dot products in another order.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "loop_filter.cuh"

namespace {

constexpr int kWorkerWarps = 16;
constexpr int kWorkers = kWorkerWarps * 32;
constexpr int kThreads = kWorkers + 32;      // warp 0 runs the chain
constexpr int kTile = 4;                     // consecutive samples per worker tile
constexpr int kGroup = 9;                    // lags summed per register tile
constexpr int kWin = kGroup + kTile - 1;     // window values per tile and group
constexpr int kPad = 8;                      // zeros around the window (>= kGroup - 1)
constexpr int kTermChunk = 32;               // ms of step terms per refill
constexpr int kBarPublish = 1;               // named barriers (0 is __syncthreads)
constexpr int kBarPartials = 2;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWin % 4 == 0 && kTile % 2 == 0, "float4 loads of window and samples");

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// Reduce-scatter of N values across a warp: at each offset the lanes of a
// pair keep one half of their values each and add the partner's share of
// it, so after the five offsets every value's warp-wide sum sits on one
// lane, which writes it to dst[its index]. 20 shuffles for 18 values where
// reducing each value to lane 0 takes 90; the additions run in a fixed
// order, so two runs give the same bits.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(const float (&v)[N], float* dst, int lane,
                                               int base, int n) {
  constexpr int H = (N + 1) / 2;
  float out[H];
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j];
    const float hi = j + H < N ? v[j + H] : 0.0f;
    out[j] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, O);
  }
  // This lane's values are now [base, base + n) of the original ones
  // (n <= 0: padding only).
  base = upper ? base + H : base;
  n = upper ? n - H : (n < H ? n : H);
  if constexpr (O > 1) {
    reduce_scatter<H, O / 2>(out, dst, lane, base, n);
  } else {
    if (n == 1) dst[base] = out[0];
  }
}

struct Publish {
  float th, fd;  // the NCO state for the next ms's wipeoff
  int first;     // its first selected lag
};

// Shared-memory layout, in floats from a 16-byte aligned base.
struct Layout {
  int len4;       // floats per shifted window copy
  int length_pad; // samples per ring slot
  int n_groups;   // groups of kGroup lags
  int vals;       // partial sums per warp: n_groups x (kGroup I, kGroup Q)
  int win4, ring, part, sel, total;

  __host__ __device__ Layout(int length, int nle, int k) {
    const int w_len = length + nle - 1;
    len4 = (kPad + w_len + kPad + 3) / 4 * 4;
    length_pad = (length + kTile - 1) / kTile * kTile;
    n_groups = (2 * k + 1 + kGroup - 1) / kGroup;
    vals = n_groups * 2 * kGroup;
    win4 = 0;
    ring = win4 + 4 * len4;
    part = ring + 2 * 2 * length_pad;
    sel = part + 2 * kWorkerWarps * vals;
    total = sel + 2 * 2 * n_groups * kGroup;
  }
};

template <int KT>
__global__ void __launch_bounds__(kThreads)
track_block_kernel(const float* __restrict__ init,      // [9, S]
                   const float2* __restrict__ samples,  // [B, L] (I, Q)
                   const float* __restrict__ windows,   // [S, L + NLE - 1]
                   float* __restrict__ outs,            // [B, 11, S]
                   float* __restrict__ fin,             // [9, S]
                   int n_ms, int s_count, int nle, float two_pi_over_fs,
                   FixupParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ Publish pub;
  __shared__ StepTerms terms[kTermChunk];
  const int length = p.length;
  const int w_len = length + nle - 1;
  const int k = KT > 0 ? KT : p.k_half;
  const int n_lags = 2 * k + 1;
  const Layout lay(length, nle, k);
  float* win4 = smem + lay.win4;                                  // [4][len4]
  float2* ring = reinterpret_cast<float2*>(smem + lay.ring);      // [2][length_pad]
  float* part = smem + lay.part;                                  // [2][warps][vals]
  float* sel = smem + lay.sel;                                    // [2][I, Q][groups x 9]
  const int sel_half = lay.n_groups * kGroup;

  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Copy sh of the window, shifted by sh floats: win4[sh][j] = padded[j + sh].
  for (int i = threadIdx.x; i < 4 * lay.len4; i += kThreads) {
    const int sh = i / lay.len4;
    const int src = i - sh * lay.len4 + sh - kPad;
    win4[i] = (src >= 0 && src < w_len) ? windows[static_cast<size_t>(s) * w_len + src] : 0.0f;
  }
  LoopCarry c = load_carry(init, s_count, s);  // warp 0 lane 0's is the carry
  const float cpi0_f = init[kCPI0 * s_count + s];
  const int cpi0 = static_cast<int>(cpi0_f);
  int cp_int;
  if (threadIdx.x == 0) {
    pub.th = c.th;
    pub.fd = c.fd;
    pub.first = select_first_lag(c.cp, cpi0, nle, p, &cp_int);
  }
  __syncthreads();

  if (warp > 0) {
    // ------------------------------------------------------------ workers
    const int wi = threadIdx.x - 32;
    const int wwarp = warp - 1;
    const int n_tiles = lay.length_pad / kTile;
    // This thread's samples of ms b into ring slot b & 1 (only it reads them).
    auto stage = [&](int b) {
      float2* slot = ring + (b & 1) * lay.length_pad;
      for (int t = wi; t < n_tiles; t += kWorkers) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const int l = t * kTile + i;
          if (l < length) {
            __pipeline_memcpy_async(slot + l, samples + static_cast<size_t>(b) * length + l, 8);
          }
        }
      }
      __pipeline_commit();
    };
    if (n_ms > 0) stage(0);
    for (int b = 0; b < n_ms; ++b) {
      if (b > 0) bar_sync(kBarPublish);
      const float theta = pub.th;
      const float rate = two_pi_over_fs * pub.fd;
      const int first = pub.first;
      if (b + 1 < n_ms) {
        stage(b + 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      const float2* chunk = ring + (b & 1) * lay.length_pad;
      float* pw = part + ((b & 1) * kWorkerWarps + wwarp) * lay.vals;
      // Lag m's slice starts at base + n_lags - 1 - m in the window.
      const int base = nle - n_lags - first;
      for (int g = 0; g < lay.n_groups; ++g) {
        const int a0 = kPad + base + n_lags - kGroup - g * kGroup;
        float acc_r[kGroup], acc_i[kGroup];
#pragma unroll
        for (int mm = 0; mm < kGroup; ++mm) acc_r[mm] = acc_i[mm] = 0.0f;
        for (int t = wi; t < n_tiles; t += kWorkers) {
          const int l0 = t * kTile;
          // --- wipeoff: x = chunk * e^{-j(theta + (2 pi / fs) f l)}.
          float xr[kTile], xi[kTile];
          const float4* c4 = reinterpret_cast<const float4*>(chunk + l0);
#pragma unroll
          for (int h = 0; h < kTile / 2; ++h) {
            const float4 v = c4[h];
            const float vx[2] = {v.x, v.z};
            const float vy[2] = {v.y, v.w};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              const int l = l0 + i;
              if (l < length) {
                const float phase = theta + rate * static_cast<float>(l);
                float sn, cs;
                sincosf(phase, &sn, &cs);
                xr[i] = vx[e] * cs + vy[e] * sn;
                xi[i] = vy[e] * cs - vx[e] * sn;
              } else {
                xr[i] = 0.0f;
                xi[i] = 0.0f;
              }
            }
          }
          // --- the window run: padded[a .. a + kWin), aligned in copy a & 3.
          const int a = a0 + l0;
          const int sh = a & 3;
          const float4* w4 = reinterpret_cast<const float4*>(win4 + sh * lay.len4 + (a - sh));
          float wv[kWin];
#pragma unroll
          for (int j = 0; j < kWin / 4; ++j) {
            const float4 u = w4[j];
            wv[4 * j] = u.x;
            wv[4 * j + 1] = u.y;
            wv[4 * j + 2] = u.z;
            wv[4 * j + 3] = u.w;
          }
          // --- lag g * 9 + mm, sample l0 + i: padded[a + 8 - mm + i].
#pragma unroll
          for (int mm = 0; mm < kGroup; ++mm) {
#pragma unroll
            for (int i = 0; i < kTile; ++i) {
              acc_r[mm] = __fmaf_rn(wv[kGroup - 1 - mm + i], xr[i], acc_r[mm]);
              acc_i[mm] = __fmaf_rn(wv[kGroup - 1 - mm + i], xi[i], acc_i[mm]);
            }
          }
        }
        float vals[2 * kGroup];
#pragma unroll
        for (int mm = 0; mm < kGroup; ++mm) {
          vals[mm] = acc_r[mm];
          vals[kGroup + mm] = acc_i[mm];
        }
        reduce_scatter<2 * kGroup, 16>(vals, pw + g * 2 * kGroup, lane, 0, 2 * kGroup);
      }
      __syncwarp();
      __threadfence_block();
      bar_arrive(kBarPartials);
    }
    return;
  }

  // ---------------------------------------------------------------- warp 0
  for (int b = 0; b < n_ms; ++b) {
    const int tj = b % kTermChunk;
    if (tj == 0) {
      terms[lane] = step_terms(__shfl_sync(kFull, c.step, 0), lane, p);
    }
    bar_sync(kBarPartials);
    // --- the selected lags: the workers' sums added in warp order.
    const float* pp = part + (b & 1) * kWorkerWarps * lay.vals;
    float* sb = sel + (b & 1) * 2 * sel_half;
    for (int v = lane; v < lay.vals; v += 32) {
      // The warps' sums added as a tree, in a fixed order.
      float t[kWorkerWarps];
#pragma unroll
      for (int w = 0; w < kWorkerWarps; ++w) t[w] = pp[w * lay.vals + v];
#pragma unroll
      for (int w = 1; w < kWorkerWarps; w *= 2) {
#pragma unroll
        for (int i = 0; i + w < kWorkerWarps; i += 2 * w) t[i] += t[i + w];
      }
      const float sum = t[0];
      const int g = v / (2 * kGroup);
      const int r = v - g * 2 * kGroup;
      const int q = r >= kGroup;
      sb[q * sel_half + g * kGroup + (r - q * kGroup)] = sum;
    }
    __syncwarp();
    const float* sr = sb;
    const float* si = sb + sel_half;
    StepMid mid;
    int next_cp_int = 0;
    if (lane == 0) {
      const StepTerms t = terms[tj];
      const float advance = kTwoPi * c.fd * p.t_ms;
      int next_first;
      mid = loop_filter_head<KT>(c, sr, si, cp_int, advance, false, 0.0f, t, p, cpi0, nle,
                                 &next_first, &next_cp_int);
      pub.th = c.th;
      pub.fd = c.fd;
      pub.first = next_first;
      __threadfence_block();
    }
    __syncwarp();
    if (b + 1 < n_ms) bar_arrive(kBarPublish);
    if (lane == 0) {
      // --- outputs (pre-update loop state) in the shadow of the next wipe.
      loop_filter_tail<KT>(mid, sr, si, p, outs + static_cast<size_t>(b) * kNOut * s_count + s,
                           s_count);
      cp_int = next_cp_int;
    }
    __syncwarp();
  }

  if (threadIdx.x == 0) {
    store_carry(c, fin, s_count, s);
    fin[kCPI0 * s_count + s] = cpi0_f;
  }
}

template <int KT>
cudaError_t launch(const float* init, const float* samples, const float* windows,
                   float* outs, float* fin, int n_ms, int s_count, int nle,
                   float two_pi_over_fs, const FixupParams& p, cudaStream_t stream) {
  const int smem = 4 * Layout(p.length, nle, p.k_half).total;
  cudaError_t err = cudaFuncSetAttribute(
      track_block_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  track_block_kernel<KT><<<s_count, kThreads, smem, stream>>>(
      init, reinterpret_cast<const float2*>(samples), windows, outs, fin, n_ms, s_count, nle,
      two_pi_over_fs, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int track_block_f32(const float* init, const float* samples,
                               const float* windows, float* outs, float* fin,
                               int n_ms, int s_count, int nle,
                               float two_pi_over_fs, const FixupParams* params,
                               void* stream) {
  if (s_count <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      params->k_half == 4
          ? launch<4>(init, samples, windows, outs, fin, n_ms, s_count, nle, two_pi_over_fs,
                      *params, st)
          : launch<0>(init, samples, windows, outs, fin, n_ms, s_count, nle, two_pi_over_fs,
                      *params, st);
  return static_cast<int>(err);
}
