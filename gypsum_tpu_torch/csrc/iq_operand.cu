// Phase 1's sample operand: a block's I/Q words straight to each stream's
// [cr; ci] rows, in the precision of the two-phase tracker's product.
//
// Replaces no TPU kernel. The JAX package leaves the samples' side of phase 1
// (dequantize, the real and imaginary planes, the bf16 cast) to XLA, which
// fuses it into the product's operand (gypsum_tpu/track/matmul.py). Run as
// plain PyTorch on the card the same chain was five passes and a
// concatenation per stream: int8 words to float32 planes, to complex64, to
// the two planes, to bf16, and [cr; ci] per product, some 9 GB of traffic a
// block of the GPS farm for 0.52 GB of output.
//
// What bounds it on the H100: bytes. Each input byte is read once and each
// output byte written once, with no intermediate in device memory: at the
// farm's block ([1000, 64, 2046, 2] int8) 262 MB in and 524 MB of bf16 out,
// 0.235 ms at 3.35 TB/s, against a few operations a sample.
//
// Design: the output is what costs, two bytes out for each byte in, so the
// stores are 16 bytes a thread. A thread cannot store 16 bytes straight from
// its own loads: a millisecond's row of L = 2046 bf16 values starts only 4
// bytes aligned (2 x 2046 bytes apart), and the input rows of one stream lie
// N x 2L words apart. So a block of threads takes R consecutive milliseconds
// of one stream (kMaxRows, or as many as fit 48 KB of shared memory, or one
// wider row in up to 227 KB): it copies their R rows of 2L words into shared
// memory, where they lie end to end as the output does (sample j of the
// group at words 2j and 2j + 1), then writes the group's R x L values of
// each plane, one contiguous run in the output, as a scalar head up to a
// 16-byte boundary, 16-byte stores, and a scalar tail. The copy in takes
// four words (two complex samples) a load where L is even and the base
// allows it, one word otherwise, each thread's loads of all R rows issued
// before its first store to shared memory. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W, a thread that loads two samples and stores
// 4 bytes to each plane (no shared memory) ran 0.365 ms at the farm's block,
// 64 % of the bound; the staged copy about 0.29 ms (PERF.md).
//
// Layout of the output: [N, 2B, L] with stream n's rows at n * stream_stride
// elements; the wrapper pads stream_stride so that every stream's rows start
// a multiple of 256 bytes from the base, as a fresh allocation of their own.
//
// Numerics, the plain version's (ops/iq_operand.py:iq_operand_reference):
// v = float(x) - offset in float32 (the wrapper passes offset 0 for float32
// words, which subtracts nothing), then for a bf16 operand one rounding to
// nearest, ties to even (__float2bfloat16_rn), which is PyTorch's
// float-to-bf16 conversion. The output is identical to the bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 8;                 // milliseconds a block stages
constexpr int kSharedBytes = 48 * 1024;     // without the opt-in attribute
constexpr int kMaxSharedBytes = 227 * 1024;  // with it, for one row

// Four I/Q words (two complex samples) in one aligned load.
template <typename T>
struct Quad;
template <>
struct Quad<int8_t> {
  using type = char4;
};
template <>
struct Quad<uint8_t> {
  using type = uchar4;
};
template <>
struct Quad<int16_t> {
  using type = short4;
};
template <>
struct Quad<float> {
  using type = float4;
};

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }

// 16 bytes of output: eight bf16 or four float32 values.
template <typename O>
struct Vec16 {
  static constexpr int kCount = 16 / sizeof(O);
  O v[kCount];
};

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  Vec16<__nv_bfloat16> out;
#pragma unroll
  for (int k = 0; k < 8; ++k) out.v[k] = __float2bfloat16_rn(f[k]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(out.v);
}

__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// One plane of the staged group: count values, value j from word 2j + part
// of the stage, to the contiguous run at p.
template <typename T, typename O>
__device__ __forceinline__ void write_plane(O* __restrict__ p, const T* __restrict__ stage,
                                            int part, int count, float offset) {
  constexpr int kVec = Vec16<O>::kCount;
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
  const int head = min(((16 - misalign) & 15) / static_cast<int>(sizeof(O)), count);
  if (static_cast<int>(threadIdx.x) < head) {
    store_one(p + threadIdx.x, static_cast<float>(stage[2 * threadIdx.x + part]) - offset);
  }
  const int n_vec = (count - head) / kVec;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int j0 = head + v * kVec;
    float f[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) f[k] = static_cast<float>(stage[2 * (j0 + k) + part]) - offset;
    store_vec(p + j0, f);
  }
  const int tail = head + n_vec * kVec + threadIdx.x;  // fewer than kVec values left
  if (tail < count) store_one(p + tail, static_cast<float>(stage[2 * tail + part]) - offset);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
iq_operand_kernel(const T* __restrict__ x, O* __restrict__ out, int n_streams, int b_count,
                  int length, long long stream_stride, int rows, bool quads, float offset) {
  extern __shared__ int4 shared[];
  T* stage = reinterpret_cast<T*>(shared);
  const int groups = (b_count + rows - 1) / rows;
  const int n = blockIdx.x / groups;
  const int b0 = (blockIdx.x - n * groups) * rows;
  const int n_rows = min(rows, b_count - b0);
  // Row r of the group is input row (b0 + r) * N + n, 2L words. A thread
  // issues its loads of every row before it stores the first.
  if (quads) {
    using Q = typename Quad<T>::type;
    const int per_row = length >> 1;
    Q* dst = reinterpret_cast<Q*>(stage);
    const Q* src = reinterpret_cast<const Q*>(x) +
                   (static_cast<long long>(b0) * n_streams + n) * per_row;
    const long long row_stride = static_cast<long long>(n_streams) * per_row;
    for (int i = threadIdx.x; i < per_row; i += kThreads) {
      Q q[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < n_rows) q[r] = src[r * row_stride + i];
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < n_rows) dst[r * per_row + i] = q[r];
      }
    }
  } else {
    const int per_row = 2 * length;
    for (int r = 0; r < n_rows; ++r) {
      const T* row = x + (static_cast<long long>(b0 + r) * n_streams + n) * per_row;
      for (int i = threadIdx.x; i < per_row; i += kThreads) stage[r * per_row + i] = row[i];
    }
  }
  __syncthreads();
  O* re = out + n * stream_stride + static_cast<long long>(b0) * length;
  const int count = n_rows * length;
  write_plane(re, stage, 0, count, offset);
  write_plane(re + static_cast<long long>(b_count) * length, stage, 1, count, offset);
}

template <typename T, typename O>
int launch(const void* x, void* out, int n_streams, int b_count, int length,
           long long stream_stride, float offset, cudaStream_t stream) {
  if (n_streams <= 0 || b_count <= 0 || length <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long row_bytes = 2ll * length * sizeof(T);
  if (row_bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = kSharedBytes / row_bytes;
  const int rows = static_cast<int>(fit < 1 ? 1 : (fit < kMaxRows ? fit : kMaxRows));
  const long long blocks = static_cast<long long>(n_streams) * ((b_count + rows - 1) / rows);
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const long long shared_bytes = rows * row_bytes;
  if (shared_bytes > kSharedBytes) {  // one row wider than 48 KB: opt in to more
    const cudaError_t err = cudaFuncSetAttribute(
        iq_operand_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using Q = typename Quad<T>::type;
  const bool quads = length % 2 == 0 && reinterpret_cast<uintptr_t>(x) % sizeof(Q) == 0;
  iq_operand_kernel<T, O><<<static_cast<unsigned>(blocks), kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<O*>(out), n_streams, b_count, length, stream_stride,
      rows, quads, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_as(int in_dtype, const void* x, void* out, int n_streams, int b_count, int length,
              long long stream_stride, float offset, cudaStream_t stream) {
  switch (in_dtype) {
    case 0:
      return launch<int8_t, O>(x, out, n_streams, b_count, length, stream_stride, offset, stream);
    case 1:
      return launch<uint8_t, O>(x, out, n_streams, b_count, length, stream_stride, offset, stream);
    case 2:
      return launch<int16_t, O>(x, out, n_streams, b_count, length, stream_stride, offset, stream);
    case 3:
      return launch<float, O>(x, out, n_streams, b_count, length, stream_stride, offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [B, N, L, 2] contiguous words of in_dtype (0 int8, 1 uint8, 2 int16,
// 3 float32); out: stream n's [2B, L] rows at n * stream_stride elements, of
// bf16 (out_bf16 = 1) or float32 (0). A row of 2L words must fit 227 KB of
// shared memory (L up to 116224 int8 samples, 29056 float32).
extern "C" int iq_operand(const void* x, void* out, int in_dtype, int out_bf16, int n_streams,
                          int b_count, int length, long long stream_stride, float offset,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_as<__nv_bfloat16>(in_dtype, x, out, n_streams, b_count, length, stream_stride,
                                    offset, s);
  }
  return launch_as<float>(in_dtype, x, out, n_streams, b_count, length, stream_stride, offset, s);
}
