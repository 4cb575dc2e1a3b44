// Phase 2 of the two-phase block tracker: the per-millisecond loop-filter
// updates over a block of precomputed all-lag correlations.
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_fixup.py:_fixup_kernel
// (entry make_fixup_fn), the accelerator's default fixup on the main path
// (gypsum_tpu/track/matmul.py:324-333).
//
// What bounds it on the H100: neither bytes nor operations, but the chain of
// dependent updates. Each channel's carry at ms b+1 depends on ms b, so the
// B milliseconds run in order; the work per step is ~100 float operations
// per channel, and the block reads 2 x B x S x NLE floats (at S = 12,
// B = 1000, NLE = 35: 3.4 MB, about 1 us at 3.35 TB/s). The latency of one
// thread walking 1000 dependent steps is what the time will show.
//
// Design: channels are independent, so one thread per channel holds the
// 12-float carry in registers and loops over the B milliseconds inside the
// kernel (the TPU kernel's sequential grid becomes this loop). For each ms
// the thread reads only the 2K+1 lags around its current prompt. Outputs
// [B, 11, S] are written with S fastest, so the threads of a warp store
// neighbouring words. At S = 12 this is one under-filled block: correct and
// simple first; spreading the chain's latency is later work. The TPU
// kernel's 256-channel slab split and its 128-lane padding exist only for
// VMEM and are not carried over.
//
// The per-ms chain itself (loop_filter_step) lives in loop_filter.cuh, shared
// with the whole-block tracker kernel (track_block.cu).
//
// Numerics follow the plain version (gypsum_tpu_torch/ops/fixup.py
// fixup_reference, itself the reference's fixup_step) operation for
// operation in float32:
// - floor-mod for floats is fmodf plus the divisor when the signs differ,
//   which is what jnp.mod and torch.remainder compute (exactly);
// - the integer lag-index mod is a floor-mod too (its argument can be
//   negative);
// - jnp.round rounds half to even: rintf;
// - argmax ties go to the first index (strict '>');
// - the build passes -fmad=false, so no multiply-add is contracted into an
//   FMA that the plain version does not do. Fast math is never on.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>
#include <math.h>

#include "loop_filter.cuh"

namespace {

// Carry rows past the loop carry (gypsum_tpu/ops/pallas_fixup.py:46-55): the
// lag-window center, the phase-1 wipeoff reference state, the FDMA offset.
enum { kTH0 = kCPI0 + 1, kFD0, kOFF, kNCarry };

__global__ void fixup_kernel(const float* __restrict__ init,
                             const float* __restrict__ corr_r,
                             const float* __restrict__ corr_i,
                             float* __restrict__ outs,
                             float* __restrict__ fin, int n_ms, int s_count,
                             int nle, FixupParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_count) return;

  LoopCarry c = load_carry(init, s_count, s);
  const float cpi0_f = init[kCPI0 * s_count + s];
  const float th0 = init[kTH0 * s_count + s];
  const float fd0 = init[kFD0 * s_count + s];
  const float off = init[kOFF * s_count + s];
  const int cpi0 = static_cast<int>(cpi0_f);

  // FDMA offset advance per ms, reduced mod one cycle before radians.
  const float off_cycles = off * p.t_ms;
  const float off_frac = off_cycles - rintf(off_cycles);

  for (int b = 0; b < n_ms; ++b) {
    const float* row_r = corr_r + (static_cast<size_t>(b) * s_count + s) * nle;
    const float* row_i = corr_i + (static_cast<size_t>(b) * s_count + s) * nle;
    // --- the 2K+1 lags around the current prompt, clipped to the window.
    int cp_int;
    const int first = select_first_lag(c.cp, cpi0, nle, p, &cp_int);
    // --- rotate the prompt to the loop phase: alpha = (th - th0) + pi (fd - fd0) t_ms.
    const float alpha = (c.th - th0) + kPi * (c.fd - fd0) * p.t_ms;
    const float advance = kTwoPi * (c.fd * p.t_ms + off_frac);
    // --- this ms's outputs (pre-update loop state), S fastest.
    float* o = outs + static_cast<size_t>(b) * kNOut * s_count + s;
    loop_filter_step(c, row_r + first, row_i + first, cp_int, advance, true,
                     alpha, p, o, s_count);
  }

  store_carry(c, fin, s_count, s);
  fin[kCPI0 * s_count + s] = cpi0_f;
  fin[kTH0 * s_count + s] = th0;
  fin[kFD0 * s_count + s] = fd0;
  fin[kOFF * s_count + s] = off;
}

}  // namespace

extern "C" int fixup_f32(const float* init, const float* corr_r,
                         const float* corr_i, float* outs, float* fin,
                         int n_ms, int s_count, int nle,
                         const FixupParams* params, void* stream) {
  if (s_count > 0) {
    const int threads = 32;
    const int blocks = (s_count + threads - 1) / threads;
    fixup_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        init, corr_r, corr_i, outs, fin, n_ms, s_count, nle, *params);
  }
  return static_cast<int>(cudaGetLastError());
}
