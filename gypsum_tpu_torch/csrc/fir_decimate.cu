// Anti-alias FIR + decimate by an integer factor on interleaved I/Q samples:
//   y[n] = sum_t taps[t] * x[n * factor + T - 1 - t],   n < (N - T) / factor + 1
// ('VALID'; the taps run reversed, a true convolution, as in the TPU kernel).
//
// Replaces the TPU kernel gypsum_tpu/ops/pallas_kernels.py:_fir_decimate_kernel
// (entry fir_decimate_pallas), the front end's bulk decimator.
//
// What bounds it on the H100: bytes. Every input sample is read once and every
// output written once (one 1000 ms block at 8.184 Msps: 65 MB in, 16 MB out,
// about 24 us at 3.35 TB/s); the arithmetic is 2 T operations per output
// value. The first design (one thread per output, the tile interleaved in
// shared memory) was held by shared-memory bank conflicts instead: lanes
// 8 * factor bytes apart made every tap load a factor-way conflict.
//
// Design (the launch plan is computed in ops/fir_decimate.py:launch_plan and
// passed in; the CPU tests check the plan and emulate this layout in numpy):
// - Polyphase. With hr[s] = taps[T - 1 - s] and s = p * factor + q, output n
//   is sum_q sum_p H[q][p] * b_q[n + p], where b_q[m] = x[m * factor + q] is
//   phase q's branch and H[q][p] = hr[p * factor + q] (zero past T), P =
//   ceil(T / factor) taps per phase.
// - A block of 128 threads computes 1024 consecutive outputs, 8 per thread.
//   It stages its span in shared memory by phase with cp.async: with width
//   W = 2 one row per pair of phases (q, q + 1), whose element m is the 16
//   bytes x[(n0 + m) * factor + q .. + 1] as they lie in device memory; with
//   W = 1 one row per phase of 8-byte (I, Q) elements (odd factors, and
//   factor 4, where it measured faster). Consecutive lanes copy consecutive
//   words: coalesced. The copies go through L1 (.ca): the same 16-byte
//   copies with .cg ran 25-35 % slower on the H100.
// - Each thread keeps a window of its row's 8 elements in registers and, per
//   tap, loads one element and runs 8 outputs x W phases x 2 planes of fmaf
//   (W = 2 or 1: 32 or 16 per 16- or 8-byte load), with the tap pair as one
//   broadcast load. Thread i's elements are 8 apart from lane i + 1's, so the
//   row is swizzled (element m at m ^ ((m >> 3) & 7), or (m >> 4) for 8-byte
//   elements): the lanes of a warp's load then hit distinct banks. The row
//   pitch is staggered so the staging stores of factors 2, 4 and 8 are
//   conflict-free too.
// - Where one tile of all phases would not fit the plan's share of shared
//   memory, the block loops over groups of phases and keeps the accumulators
//   in registers: every filter with P <= 128 (the TPU kernel's limit) fits.
// - Several blocks reside on each SM (the plan keeps a block's tile within
//   72 KB), so one block's staging overlaps another's arithmetic.
// - Each thread stores its 8 interleaved outputs as four 16-byte words.
//
// Numerics: float32, no fast math. The taps run through explicit fmaf (one
// rounding per tap; -fmad=false, which the build passes, governs only
// contraction of separate multiplies and adds), summed phase by phase. The
// plain version's convolution sums in another order, so the two agree to
// float32 rounding of a T-term sum, not bit for bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kOutputsPerBlock = kThreads * kPerThread;
constexpr int kMaxSmemBytes = 232448;

struct Plan {
  int t_len;   // T
  int factor;  // f
  int p;       // taps per phase, ceil(T / f)
  int group;   // phases staged at once (a multiple of W)
  int pitch;   // elements per row
};

// W phases of one branch sample: a row element, its taps, and its swizzle.
template <int W>
struct Elem;
template <>
struct Elem<2> {
  using V = float4;  // (I_q, Q_q, I_q+1, Q_q+1)
  using H = float2;  // (H[q][p], H[q+1][p])
  static constexpr int kShift = 3;  // 16-byte elements: 8 lanes per wavefront
  static __device__ __forceinline__ void fma(float& ai, float& aq, H h, V v) {
    ai = fmaf(h.x, v.x, ai);
    aq = fmaf(h.x, v.y, aq);
    ai = fmaf(h.y, v.z, ai);
    aq = fmaf(h.y, v.w, aq);
  }
};
template <>
struct Elem<1> {
  using V = float2;  // (I_q, Q_q)
  using H = float;
  static constexpr int kShift = 4;  // 8-byte elements: 16 lanes per wavefront
  static __device__ __forceinline__ void fma(float& ai, float& aq, H h, V v) {
    ai = fmaf(h, v.x, ai);
    aq = fmaf(h, v.y, aq);
  }
};

// Where element m of a row lies: the low 3 bits turned by a higher group, so
// that lanes reading elements 8 apart fall on distinct banks.
template <int W>
__device__ __forceinline__ int swizzle(int m) {
  return m ^ ((m >> Elem<W>::kShift) & 7);
}

// Copy bytes (<= 8 W) from global to shared memory, zero-filling the rest.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(s), "l"(src), "r"(bytes) : "memory");
  }
}

// One step: tap pair h against the window slot of each of the 8 outputs.
template <int W, int S>
__device__ __forceinline__ void step(float (&ai)[kPerThread], float (&aq)[kPerThread],
                                     const typename Elem<W>::V (&w)[8], typename Elem<W>::H h) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) Elem<W>::fma(ai[r], aq[r], h, w[(S + r) & 7]);
}

// One row (W phases) against its P taps. At tap p, output r of thread i
// reads element 8 i + p + r, which lies in window slot (p + r) & 7.
template <int W>
__device__ __forceinline__ void row_pass(float (&ai)[kPerThread], float (&aq)[kPerThread],
                                         const typename Elem<W>::V* row,
                                         const typename Elem<W>::H* h, int n_taps, int i) {
  using V = typename Elem<W>::V;
  const int base = kPerThread * i;
  V w[8];
#pragma unroll
  for (int r = 0; r < 7; ++r) w[r] = row[swizzle<W>(base + r)];
  int p0 = 0;
  for (; p0 + 8 <= n_taps; p0 += 8) {
#define FIR_STEP(S)                                        \
  w[(S + 7) & 7] = row[swizzle<W>(base + p0 + S + 7)];     \
  step<W, S>(ai, aq, w, h[p0 + S]);
    FIR_STEP(0) FIR_STEP(1) FIR_STEP(2) FIR_STEP(3)
    FIR_STEP(4) FIR_STEP(5) FIR_STEP(6) FIR_STEP(7)
  }
  const int left = n_taps - p0;  // 0..7 taps, the same for every thread
  if (left > 0) { FIR_STEP(0) }
  if (left > 1) { FIR_STEP(1) }
  if (left > 2) { FIR_STEP(2) }
  if (left > 3) { FIR_STEP(3) }
  if (left > 4) { FIR_STEP(4) }
  if (left > 5) { FIR_STEP(5) }
  if (left > 6) { FIR_STEP(6) }
#undef FIR_STEP
}

template <int W>
__global__ void __launch_bounds__(kThreads)
fir_decimate_kernel(const float* __restrict__ x, long long n_in, const float* __restrict__ taps,
                    float* __restrict__ y, long long n_out, Plan pl) {
  using V = typename Elem<W>::V;
  using H = typename Elem<W>::H;
  extern __shared__ __align__(16) float smem[];
  const int f = pl.factor, n_taps = pl.p, t_len = pl.t_len;
  // [group / W][p] tap elements, then [group / W][pitch] row elements.
  H* hs = reinterpret_cast<H*>(smem);
  V* rows = reinterpret_cast<V*>(smem + ((pl.group * n_taps + 3) & ~3));
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kOutputsPerBlock;
  const int cols = kOutputsPerBlock + n_taps - 1;  // branch samples staged per phase

  float acc_i[kPerThread], acc_q[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc_i[r] = acc_q[r] = 0.0f;

  for (int q0 = 0; q0 < f; q0 += pl.group) {
    const int kw = min(pl.group, f - q0) / W;  // rows of this group
    if (q0 > 0) __syncthreads();  // every thread is done with the last group
    // Taps: float e of the group's tap elements is phase q0 + W k + j at tap
    // p, with e = (k P + p) W + j.
    float* hf = reinterpret_cast<float*>(hs);
    for (int e = tid; e < kw * n_taps * W; e += kThreads) {
      const int kp = e / W;
      const int k = kp / n_taps;
      const int s = (kp - k * n_taps) * f + q0 + W * k + (e - kp * W);
      hf[e] = s < t_len ? taps[t_len - 1 - s] : 0.0f;
    }
    // Samples: element e = m kw + k is x[(n0 + m) f + q0 + W k ...], W
    // samples; consecutive lanes copy consecutive words of each run.
    const int dm = kThreads / kw, dk = kThreads - dm * kw;
    int m = tid / kw, k = tid - m * kw;
    for (int e = tid; e < cols * kw; e += kThreads) {
      const long long idx = (n0 + m) * f + q0 + W * k;
      const long long left = n_in - idx;
      const int bytes = left >= W ? 8 * W : (left > 0 ? 8 * static_cast<int>(left) : 0);
      cp_async<W>(rows + k * pl.pitch + swizzle<W>(m), x + 2 * (bytes ? idx : 0), bytes);
      m += dm;
      k += dk;
      if (k >= kw) {
        k -= kw;
        ++m;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int r = 0; r < kw; ++r) {
      row_pass<W>(acc_i, acc_q, rows + r * pl.pitch, hs + r * n_taps, n_taps, tid);
    }
  }

  const long long out = n0 + static_cast<long long>(tid) * kPerThread;
  if (out + kPerThread <= n_out) {
    float4* dst = reinterpret_cast<float4*>(y + 2 * out);
#pragma unroll
    for (int r = 0; r < kPerThread; r += 2) {
      dst[r >> 1] = make_float4(acc_i[r], acc_q[r], acc_i[r + 1], acc_q[r + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (out + r < n_out) {
        reinterpret_cast<float2*>(y)[out + r] = make_float2(acc_i[r], acc_q[r]);
      }
    }
  }
}

template <int W>
int launch(const float* x, long long n_in, const float* taps, float* y, long long n_out,
           const Plan& pl, int smem, cudaStream_t stream) {
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fir_decimate_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fir_decimate_kernel<W>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attributes_set = true;
  }
  if (n_out > 0) {
    const long long blocks = (n_out + kOutputsPerBlock - 1) / kOutputsPerBlock;
    fir_decimate_kernel<W><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        x, n_in, taps, y, n_out, pl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n_in, 2] float32 (16-byte aligned for width 2, 8-byte for width 1),
// taps: [t_len] float32, y: [n_out, 2] float32 (16-byte aligned). The plan's
// smem_bytes must equal the bytes this entry computes from it.
extern "C" int fir_decimate_f32(const float* x, long long n_in, const float* taps, float* y,
                                long long n_out, int t_len, int factor, int width,
                                int taps_per_phase, int group, int pitch, int smem_bytes,
                                void* stream) {
  if (width != 1 && width != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int tap_words = (group * taps_per_phase + 3) & ~3;
  const int smem = 4 * tap_words + group / width * pitch * 8 * width;
  if (smem != smem_bytes || smem > kMaxSmemBytes || group < width || group % width ||
      factor % width || group > factor ||
      taps_per_phase != (t_len + factor - 1) / factor ||
      pitch < ((kOutputsPerBlock + taps_per_phase - 1 + 7) & ~7)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl{t_len, factor, taps_per_phase, group, pitch};
  const auto s = static_cast<cudaStream_t>(stream);
  return width == 2 ? launch<2>(x, n_in, taps, y, n_out, pl, smem, s)
                    : launch<1>(x, n_in, taps, y, n_out, pl, smem, s);
}
