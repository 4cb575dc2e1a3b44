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

namespace {

// Carry rows of the [12, S] init/final arrays (gypsum_tpu/ops/pallas_fixup.py:46-55).
enum { kCP, kTH, kFD, kEERR, kEERR2, kEQ, kSTEP, kLOST, kCPI0, kTH0, kFD0, kOFF,
       kNCarry };
// Output rows of the [B, 11, S] per-ms array.
enum { kOPI, kOPQ, kOCP, kOCPM, kOFD, kOTH, kOPLL, kODLL, kOLOCKED, kOQUAL,
       kOLOST, kNOut };

constexpr float kEps = 1e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

}  // namespace

// Loop constants, laid out as gypsum_tpu_torch/ops/fixup.py:_FixupParams.
struct FixupParams {
  float kp_locked, ki_locked, kp_pullin, ki_pullin;
  float lam_err, lam_q;
  float log1m_lam_err, log1m_lam_q;  // log1p(-lambda), computed in double
  float aiding_scale, dll_gain, t_ms;
  float max_err_var, min_quality, quality_drop;
  float w_chip;
  int lock_window_ms, watchdog_warmup_ms;
  int length, k_half, use_hrc;
};

namespace {

__device__ __forceinline__ float floor_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
  return r;
}

__device__ __forceinline__ int floor_mod_int(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

__global__ void fixup_kernel(const float* __restrict__ init,
                             const float* __restrict__ corr_r,
                             const float* __restrict__ corr_i,
                             float* __restrict__ outs,
                             float* __restrict__ fin, int n_ms, int s_count,
                             int nle, FixupParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_count) return;

  float cp = init[kCP * s_count + s];
  float th = init[kTH * s_count + s];
  float fd = init[kFD * s_count + s];
  float eerr = init[kEERR * s_count + s];
  float eerr2 = init[kEERR2 * s_count + s];
  float eq = init[kEQ * s_count + s];
  float step = init[kSTEP * s_count + s];
  float lost_f = init[kLOST * s_count + s];
  const float cpi0_f = init[kCPI0 * s_count + s];
  const float th0 = init[kTH0 * s_count + s];
  const float fd0 = init[kFD0 * s_count + s];
  const float off = init[kOFF * s_count + s];

  const int length = p.length;
  const int k = p.k_half;
  const int n_lags = 2 * k + 1;
  const int k_eff = (nle - 1) / 2;
  const int half = length / 2;
  const int cpi0 = static_cast<int>(cpi0_f);
  const float length_f = static_cast<float>(length);

  // FDMA offset advance per ms, reduced mod one cycle before radians.
  const float off_cycles = off * p.t_ms;
  const float off_frac = off_cycles - rintf(off_cycles);

  for (int b = 0; b < n_ms; ++b) {
    const float* row_r = corr_r + (static_cast<size_t>(b) * s_count + s) * nle;
    const float* row_i = corr_i + (static_cast<size_t>(b) * s_count + s) * nle;

    // --- the 2K+1 lags around the current prompt, clipped to the window.
    const int cp_int = floor_mod_int(static_cast<int>(floorf(cp)), length);
    const int delta = floor_mod_int(cp_int - cpi0 + half, length) - half;
    int j = delta + k_eff;
    j = j < k ? k : (j > nle - 1 - k ? nle - 1 - k : j);
    const float* sr = row_r + (j - k);
    const float* si = row_i + (j - k);

    // --- power, early/late, first-index argmax and the prompt at the peak.
    float best = 0.0f, early = 0.0f, late = 0.0f, p0_r = 0.0f, p0_i = 0.0f;
    int peak = 0;
    for (int m = 0; m < n_lags; ++m) {
      const float r = sr[m];
      const float q = si[m];
      const float pw = r * r + q * q;
      if (m == 0 || pw > best) {
        best = pw;
        peak = m;
        p0_r = r;
        p0_i = q;
      }
      if (m == k - 1) early = pw;
      if (m == k + 1) late = pw;
    }
    auto mag_at = [&](int o) {
      int m = peak + o;
      m = m < 0 ? 0 : (m > n_lags - 1 ? n_lags - 1 : m);
      const float r = sr[m];
      const float q = si[m];
      return sqrtf(r * r + q * q);
    };
    const float r0 = sqrtf(best);
    const float rp = mag_at(1);
    const float rm = mag_at(-1);
    float frac;
    if (p.use_hrc) {
      const float d1 = rm - rp;
      const float d2 = mag_at(-2) - mag_at(2);
      frac = -p.w_chip * (d1 - 0.5f * d2) / (r0 + kEps);
      frac = fminf(fmaxf(frac, -1.5f), 1.5f);
    } else {
      frac = (rp - rm) / (2.0f * (r0 - fminf(rp, rm)) + kEps);
      frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    }
    const float cp_meas = floor_mod(
        static_cast<float>(cp_int) + static_cast<float>(peak - k) + frac,
        length_f);

    // --- rotate the prompt to the loop phase: alpha = (th - th0) + pi (fd - fd0) t_ms.
    const float alpha = (th - th0) + kPi * (fd - fd0) * p.t_ms;
    const float ca = cosf(alpha);
    const float sa = sinf(alpha);
    const float pi_rot = p0_r * ca + p0_i * sa;
    const float pq_rot = p0_i * ca - p0_r * sa;

    // --- DLL with carrier aiding.
    const float dll_err = (early - late) / (early + late + kEps);
    float new_cp = cp - p.dll_gain * dll_err;
    new_cp = new_cp - p.aiding_scale * fd;
    new_cp = floor_mod(new_cp, length_f);

    // --- Costas PLL, bias-corrected lock and quality EMAs.
    const float pll_err = (pi_rot * pq_rot) / (pi_rot * pi_rot + pq_rot * pq_rot + kEps);
    const float n = step + 1.0f;
    const float corr_err = 1.0f - expf(n * p.log1m_lam_err);
    const float corr_q = 1.0f - expf(n * p.log1m_lam_q);
    const float ema_err = eerr + p.lam_err * (pll_err - eerr);
    const float ema_err_sq = eerr2 + p.lam_err * (pll_err * pll_err - eerr2);
    const float m_err = ema_err / corr_err;
    const float err_var = ema_err_sq / corr_err - m_err * m_err;
    const float quality_inst = (pi_rot * pi_rot - pq_rot * pq_rot) /
                               (pi_rot * pi_rot + pq_rot * pq_rot + kEps);
    const float ema_q_raw = eq + p.lam_q * (quality_inst - eq);
    const float ema_q = ema_q_raw / corr_q;

    const bool warmed = step >= static_cast<float>(p.lock_window_ms);
    const bool locked = warmed && (err_var < p.max_err_var) && (ema_q > p.min_quality);
    const float kp = locked ? p.kp_locked : p.kp_pullin;
    const float ki = locked ? p.ki_locked : p.ki_pullin;
    const float new_th = floor_mod(th + kTwoPi * (fd * p.t_ms + off_frac) + kp * pll_err, kTwoPi);
    const float new_fd = fd + ki * pll_err;

    const bool armed = step >= static_cast<float>(p.watchdog_warmup_ms);
    const bool lost = (lost_f > 0.5f) || (armed && ema_q < p.quality_drop);

    // --- this ms's outputs (pre-update loop state), S fastest.
    float* o = outs + static_cast<size_t>(b) * kNOut * s_count + s;
    o[kOPI * s_count] = pi_rot;
    o[kOPQ * s_count] = pq_rot;
    o[kOCP * s_count] = cp;
    o[kOCPM * s_count] = cp_meas;
    o[kOFD * s_count] = fd;
    o[kOTH * s_count] = th;
    o[kOPLL * s_count] = pll_err;
    o[kODLL * s_count] = dll_err;
    o[kOLOCKED * s_count] = locked ? 1.0f : 0.0f;
    o[kOQUAL * s_count] = ema_q;
    o[kOLOST * s_count] = lost ? 1.0f : 0.0f;

    cp = new_cp;
    th = new_th;
    fd = new_fd;
    eerr = ema_err;
    eerr2 = ema_err_sq;
    eq = ema_q_raw;
    step = n;
    lost_f = lost ? 1.0f : 0.0f;
  }

  fin[kCP * s_count + s] = cp;
  fin[kTH * s_count + s] = th;
  fin[kFD * s_count + s] = fd;
  fin[kEERR * s_count + s] = eerr;
  fin[kEERR2 * s_count + s] = eerr2;
  fin[kEQ * s_count + s] = eq;
  fin[kSTEP * s_count + s] = step;
  fin[kLOST * s_count + s] = lost_f;
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
