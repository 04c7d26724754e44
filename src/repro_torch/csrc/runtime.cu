// Shared runtime helper of the kernel library: the text of a CUDA error
// code, so the Python wrappers can raise with a readable message.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
