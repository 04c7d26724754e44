// Row-wise ascending sort of int32 keys: a bitonic compare-exchange network
// over one row held in shared memory.
//
// Replaces: src/repro/kernels/bitonic_sort/bitonic_sort.py::bitonic_sort
// (the pl.pallas_call at :64, body _kernel at :39).
//
// What bounds it on the H100: bytes.  A row is read once and written once
// (8 bytes per key), while the network does L/2 * log2(L) * (log2(L)+1) / 2
// compare-exchanges per row, all in shared memory.  On the mapping path the
// rows are short (L = 128 or 4096) and there are a few hundred of them, so
// the kernel is launch- and latency-bound long before either roof.
//
// Design: one CTA per row.  The row is staged in shared memory, padded
// there with INT32_MAX to the power-of-two lane count Lp (at most
// 8192 x 4 B = 32 KiB, so no opt-in above 48 KiB is needed), each thread
// owns Lp / (2 * blockDim) compare-exchange pairs per stage, and a
// __syncthreads separates the stages.  The TPU kernel's sub-vector
// reversals (a layout trick for the VPU) become plain shared-memory
// indexing: the partner of i at distance j is i + j with bit j of i clear.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPad = 0x7FFFFFFF;       // INT32_MAX, the reference's pad

__global__ void bitonic_sort_kernel(const int* __restrict__ in,
                                    int* __restrict__ out, int L, int Lp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s = reinterpret_cast<int*>(smem_raw);
  const size_t row = blockIdx.x;
  const int* src = in + row * L;
  // lanes past the row's L keys hold the INT32_MAX pad, which sorts last
  for (int i = threadIdx.x; i < Lp; i += blockDim.x)
    s[i] = i < L ? src[i] : kPad;
  __syncthreads();
  const int half = Lp >> 1;
  for (int k = 2; k <= Lp; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // the p-th index whose bit j is clear, and its partner i ^ j
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int ixj = i + j;
        const int a = s[i];
        const int b = s[ixj];
        const bool up = (i & k) == 0;   // k == Lp: (i & Lp) == 0 for all i
        if (up ? (a > b) : (a < b)) {
          s[i] = b;
          s[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  int* dst = out + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) dst[i] = s[i];
}

}  // namespace

// in, out: (rows, L) int32, contiguous; Lp a power of two in [L, 8192],
// the lane count each row is padded to in shared memory.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int bitonic_sort_rows(const int* in, int* out, int rows, int L,
                                 int Lp, void* stream) {
  int threads = Lp / 2;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(Lp) * sizeof(int);
  bitonic_sort_kernel<<<rows, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(in, out, L, Lp);
  return static_cast<int>(cudaGetLastError());
}
