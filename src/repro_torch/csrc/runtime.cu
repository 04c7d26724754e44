// Shared runtime helpers of the kernel library: the text of a CUDA error
// code, so the Python wrappers can raise with a readable message, and an
// empty kernel whose back-to-back launches time the launch floor.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel on `stream` with `blocks` CTAs of `threads`;
// returns cudaGetLastError().
extern "C" int repro_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
