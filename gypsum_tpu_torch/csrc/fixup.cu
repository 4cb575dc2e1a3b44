// Phase 2 of the two-phase block tracker: the per-millisecond loop-filter
// updates over a block of precomputed all-lag correlations.
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_fixup.py:_fixup_kernel
// (entry make_fixup_fn), the accelerator's default fixup on the main path
// (gypsum_tpu/track/matmul.py:324-333).
//
// What bounds it on the H100: neither bytes nor operations, but the chain of
// dependent updates. Each channel's carry at ms b+1 depends on ms b, so the
// B milliseconds run in order; the work per step is ~150 float operations
// per channel, and the block reads 2 x B x S x NLE floats (at S = 12,
// B = 1000, NLE = 35: 3.4 MB, about 1 us at 3.35 TB/s). What bounds it now
// is the chain's own ALU latency (sincosf, the divisions and their proofs,
// the floor-mods, the argmax compares) times B: no load from device memory
// is on it. A timing copy with the lag reads served from registers and
// plain compare-and-subtract mods ran 0.39-0.43 ms at B = 1000 against the
// kernel's 0.48 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: channels are independent, so each channel is one warp (one block
// of 32 threads), and lane 0 holds the 12-float carry in registers and walks
// the B milliseconds (the TPU kernel's sequential grid becomes this loop).
// The loads are taken off the chain: the row of ms b is one contiguous
// NLE-float run in corr_r and one in corr_i, and the warp copies the rows of
// the next chunk of up to 32 ms into a two-slot shared-memory ring with
// cp.async before lane 0 starts on the current chunk, so the copies fly
// while the chain runs; lane 0 then reads its 2K+1 lags from shared memory.
// Rows are 140 bytes apart at NLE = 35, not 16-byte aligned, so the copies
// are 4 bytes each (a TMA bulk copy does not fit them). In the same chunk
// prologue lane j computes the step count and the two EMA bias corrections
// of the chunk's j-th ms (loop_filter.cuh:step_terms), and after lane 0 has
// run the chunk's heads (loop_filter.cuh:head_with, what the next ms needs:
// the whole chunk without branches, each division and floor-mod proven
// exact, and the chunk again with the exact operations where a proof
// fails), lane j
// runs the j-th ms's tail (the sub-sample measurement and the 11 outputs,
// [B, 11, S], S fastest): both off the chain. K = 4 (the default) is
// compiled with the 2K+1 loop unrolled; any other K runs the generic
// instantiation.
//
// The per-ms chain itself (loop_filter_head/tail) lives in loop_filter.cuh,
// shared with the whole-block tracker kernel (track_block.cu).
//
// Numerics follow the plain version (gypsum_tpu_torch/ops/fixup.py
// fixup_reference, itself the reference's fixup_step) operation for
// operation in float32, and the outputs are identical to the bit:
// - floor-mod for floats is fmodf plus the divisor when the signs differ,
//   which is what jnp.mod and torch.remainder compute (exactly); where the
//   argument lies within one period of [0, m) the same result is one
//   compare and at most one add (loop_filter.cuh:floor_mod_near);
// - the integer lag-index mod is a floor-mod too (its argument can be
//   negative);
// - jnp.round rounds half to even: rintf;
// - argmax ties go to the first index (strict '>');
// - the build passes -fmad=false, so no multiply-add is contracted into an
//   FMA that the plain version does not do. Fast math is never on.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "loop_filter.cuh"

namespace {

// Carry rows past the loop carry (gypsum_tpu/ops/pallas_fixup.py:46-55): the
// lag-window center, the phase-1 wipeoff reference state, the FDMA offset.
enum { kTH0 = kCPI0 + 1, kFD0, kOFF, kNCarry };

constexpr int kMaxChunk = 32;  // ms per ring slot: one step-terms lane each
constexpr unsigned kFull = 0xffffffffu;

// One warp per channel; `chunk` ms per ring slot (32 unless NLE is so large
// that two slots would not fit in shared memory).
template <int KT>
__global__ void __launch_bounds__(32)
fixup_kernel(const float* __restrict__ init, const float* __restrict__ corr_r,
             const float* __restrict__ corr_i, float* __restrict__ outs,
             float* __restrict__ fin, int n_ms, int s_count, int nle, int chunk,
             FixupParams p) {
  extern __shared__ float smem[];
  __shared__ StepMid mids[kMaxChunk];      // the chunk's heads, for the lanes' tails
  __shared__ int firsts[kMaxChunk];
  __shared__ StepTerms terms[kMaxChunk];
  const int row_len = 2 * nle;             // [r: nle][i: nle] per ms
  float* ring = smem;                      // [2][chunk][row_len]
  const int s = blockIdx.x;
  const int lane = threadIdx.x;

  LoopCarry c = load_carry(init, s_count, s);  // lane 0's is the carry
  const float cpi0_f = init[kCPI0 * s_count + s];
  const float th0 = init[kTH0 * s_count + s];
  const float fd0 = init[kFD0 * s_count + s];
  const float off = init[kOFF * s_count + s];
  const int cpi0 = static_cast<int>(cpi0_f);

  // FDMA offset advance per ms, reduced mod one cycle before radians.
  const float off_cycles = off * p.t_ms;
  const float off_frac = off_cycles - rintf(off_cycles);

  // The rows of chunk q into ring slot q & 1, 4-byte copies by every lane.
  auto stage = [&](int q) {
    float* slot = ring + (q & 1) * chunk * row_len;
    const int b0 = q * chunk;
    const int rows = min(chunk, n_ms - b0);
    for (int r = 0; r < rows; ++r) {
      const size_t src = (static_cast<size_t>(b0 + r) * s_count + s) * nle;
      for (int col = lane; col < nle; col += 32) {
        __pipeline_memcpy_async(slot + r * row_len + col, corr_r + src + col, 4);
        __pipeline_memcpy_async(slot + r * row_len + nle + col, corr_i + src + col, 4);
      }
    }
    __pipeline_commit();
  };

  const int n_chunks = (n_ms + chunk - 1) / chunk;
  if (n_chunks > 0) stage(0);
  int cp_int;
  int first = select_first_lag(c.cp, cpi0, nle, p, &cp_int);
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) {
      stage(q + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    terms[lane] = step_terms(__shfl_sync(kFull, c.step, 0), lane, p);
    __syncwarp();  // slot q and the terms, visible to lane 0

    const float* slot = ring + (q & 1) * chunk * row_len;
    const int rows = min(chunk, n_ms - q * chunk);
    if (lane == 0) {
      // The chunk's heads, and each next ms's 2K+1 lags.
      auto heads = [&](auto& math) {
        for (int j = 0; j < rows; ++j) {
          const float* row = slot + j * row_len;
          // --- rotate the prompt to the loop phase: alpha = (th - th0) + pi (fd - fd0) t_ms.
          const float alpha = (c.th - th0) + kPi * (c.fd - fd0) * p.t_ms;
          const float advance = kTwoPi * (c.fd * p.t_ms + off_frac);
          firsts[j] = first;
          mids[j] = head_with<KT>(math, c, row + first, row + nle + first, cp_int, advance, true,
                                  alpha, terms[j], p);
          first = select_first_lag(c.cp, cpi0, nle, p, &cp_int, math);
        }
      };
      // Without branches first (SpecMath), the whole chunk: a branch per
      // step would keep the compiler from starting a step before the last
      // one's proof is in. Where any proof failed, the chunk again from its
      // first carry with the exact operations.
      const LoopCarry start = c;
      const int first_start = first, cp_int_start = cp_int;
      SpecMath spec;
      heads(spec);
      if (!spec.ok) {
        c = start;
        first = first_start;
        cp_int = cp_int_start;
        ExactMath exact;
        heads(exact);
      }
    }
    __syncwarp();
    // --- the chunk's outputs (pre-update loop state), one ms per lane, off
    // the chain: nothing of the tail feeds the carry.
    if (lane < rows) {
      const float* row = slot + lane * row_len + firsts[lane];
      loop_filter_tail<KT>(mids[lane], row, row + nle, p,
                           outs + static_cast<size_t>(q * chunk + lane) * kNOut * s_count + s,
                           s_count);
    }
    __syncwarp();  // the lanes are done with slot q before it is staged again
  }

  if (lane == 0) {
    store_carry(c, fin, s_count, s);
    fin[kCPI0 * s_count + s] = cpi0_f;
    fin[kTH0 * s_count + s] = th0;
    fin[kFD0 * s_count + s] = fd0;
    fin[kOFF * s_count + s] = off;
  }
}

template <int KT>
cudaError_t launch(const float* init, const float* corr_r, const float* corr_i,
                   float* outs, float* fin, int n_ms, int s_count, int nle,
                   const FixupParams& p, cudaStream_t stream) {
  // Two ring slots of up to 32 ms each, within the shared memory a block
  // may have.
  constexpr int kMaxSmem = 200 * 1024;  // and the static arrays beside them
  int chunk = kMaxSmem / (2 * 2 * nle * 4);
  chunk = chunk < kMaxChunk ? chunk : kMaxChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const int smem = 2 * chunk * 2 * nle * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fixup_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fixup_kernel<KT><<<s_count, 32, smem, stream>>>(init, corr_r, corr_i, outs, fin, n_ms,
                                                  s_count, nle, chunk, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fixup_f32(const float* init, const float* corr_r,
                         const float* corr_i, float* outs, float* fin,
                         int n_ms, int s_count, int nle,
                         const FixupParams* params, void* stream) {
  if (s_count <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      params->k_half == 4
          ? launch<4>(init, corr_r, corr_i, outs, fin, n_ms, s_count, nle, *params, st)
          : launch<0>(init, corr_r, corr_i, outs, fin, n_ms, s_count, nle, *params, st);
  return static_cast<int>(err);
}
