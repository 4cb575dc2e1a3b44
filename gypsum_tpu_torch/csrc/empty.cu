// A kernel that does nothing: the yardstick for what a launch alone costs.
//
// It replaces no TPU kernel and the receiver never calls it. chip_smoke.py
// launches it through the same CudaKernel.launch as K1-K5, at a short
// kernel's grid, and times it the same two ways: its device time is the
// floor of any kernel's duration on this card, its issue time the floor of
// the launch path on the host.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
