// The pool of captures, one int8 I/Q sample per thread: the benchmark's
// traffic generator on the card (portbench/generator.py says what is
// synthesized; its synth_plain is this arithmetic in PyTorch, operation for
// operation). Positions and phases in double, the carrier's sine and cosine
// and the sums in float, built with -fmad=false so that no product and sum
// are fused where the PyTorch version rounds twice.

#include <cstdint>
#include <cuda_runtime.h>

struct SatArrays {
  const double* chip_rate;  // [C, S]
  const double* chip0;      // [C, S]
  const double* freq;       // [C, S] Hz: offset + Doppler
  const double* cycles0;    // [C, S]
  const float* amp;         // [C, S]
  const int* code_row;      // [C, S]
  const int8_t* codes;      // [rows, N] {0, 1}
  const int8_t* symbols;    // [C, S, n_sym] +/-1
  const int* stagger;       // [C]
};

struct Shape {
  int n_caps, n_sats, length, chips, periods, n_sym, capture_ms, block_ms, ring;
  double fs;
  float sigma;
  unsigned s1, s2;
};

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void synth_kernel(SatArrays a, Shape sh, int8_t* __restrict__ pool) {
  const int cap = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)sh.capture_ms * sh.length;
  if (idx >= total) return;
  const int t = (int)(idx / sh.length);
  const int l = (int)(idx - (long long)t * sh.length);
  const double tabs = (double)idx / sh.fs;
  const double chips = (double)sh.chips;
  float acc_i = 0.0f, acc_q = 0.0f;
  for (int s = 0; s < sh.n_sats; ++s) {
    const int k = cap * sh.n_sats + s;
    const double pos = a.chip_rate[k] * tabs + a.chip0[k];
    double epoch = floor(pos / chips);
    double frac = pos - epoch * chips;
    if (frac < 0.0) {
      frac += chips;
      epoch -= 1.0;
    } else if (frac >= chips) {
      frac -= chips;
      epoch += 1.0;
    }
    int cidx = (int)floor(frac);
    cidx = cidx < 0 ? 0 : (cidx > sh.chips - 1 ? sh.chips - 1 : cidx);
    const float chip = (float)a.codes[(long long)a.code_row[k] * sh.chips + cidx] * 2.0f - 1.0f;
    const long long e = (long long)epoch;
    long long si = (e / sh.periods) % sh.n_sym;
    if (si < 0) si += sh.n_sym;
    const float sym = (float)a.symbols[(long long)k * sh.n_sym + si];
    const double cyc = a.freq[k] * tabs + a.cycles0[k];
    const float ph = (float)(6.283185307179586 * (cyc - floor(cyc)));
    const float v = a.amp[k] * (chip * sym);
    acc_i = acc_i + v * cosf(ph);
    acc_q = acc_q + v * sinf(ph);
  }
  const unsigned row = (unsigned)((long long)cap * sh.capture_ms + t);
  const unsigned k1 = mix32(row ^ sh.s1);
  const unsigned ha = mix32(k1 ^ mix32((2u * (unsigned)l) ^ sh.s2));
  const unsigned hb = mix32(k1 ^ mix32((2u * (unsigned)l + 1u) ^ sh.s2));
  const float u1 = ((float)(ha >> 9) + 0.5f) * 1.1920928955078125e-07f;
  const float u2 = (float)(hb >> 9) * 1.1920928955078125e-07f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = 6.2831855f * u2;
  acc_i = acc_i + sh.sigma * (r * cosf(ang));
  acc_q = acc_q + sh.sigma * (r * sinf(ang));
  acc_i = fminf(fmaxf(rintf(acc_i), -127.0f), 127.0f);
  acc_q = fminf(fmaxf(rintf(acc_q), -127.0f), 127.0f);
  // Playback order: ring block j holds this stream's ms ((j + o_n) mod R) B + m.
  const int blk = t / sh.block_ms, m = t - blk * sh.block_ms;
  const int j = ((blk - a.stagger[cap]) % sh.ring + sh.ring) % sh.ring;
  const long long out = ((((long long)j * sh.block_ms + m) * sh.n_caps + cap) * sh.length + l) * 2;
  pool[out] = (int8_t)acc_i;
  pool[out + 1] = (int8_t)acc_q;
}

extern "C" int synth_pool(SatArrays a, Shape sh, int8_t* pool, cudaStream_t stream) {
  const long long total = (long long)sh.capture_ms * sh.length;
  const int threads = 256;
  dim3 grid((unsigned)((total + threads - 1) / threads), (unsigned)sh.n_caps);
  synth_kernel<<<grid, threads, 0, stream>>>(a, sh, pool);
  return (int)cudaGetLastError();
}
