// Clipping gathers of the hash-table query: out[q] = table[clip(idx[q])]
// over the 1-D bucket-offset table, and out[w, q] = table[w, clip(idx[q])]
// over the (W, N) packed entry rows, clip(i) = min(max(i, 0), N - 1).
//
// Replaces: src/repro/kernels/pluto_lookup/pluto_lookup.py::pluto_lookup
// (the pl.pallas_call at :125, body _kernel at :40) and ::pluto_lookup_rows
// (the pl.pallas_call at :97, body _kernel_rows at :63).
//
// What bounds it on the H100: bytes.  Each query reads its index and W
// table words and writes W words.  The index reads and output writes are
// coalesced; the table reads are random, but the largest packed entry
// plane (D5, ~33 MB) and the 1 MB bucket table stay in the 50 MB L2.
//
// Design: one thread per query, a direct load of the row it names.  The
// TPU's one-hot MXU sweep of every table tile against every query block,
// and its split of 32-bit words into exact f32 halves, were workarounds for
// a machine without a gather; they do not carry over.  The rows variant
// loads all W words of its row and writes plane w at [w * Q + q], so each
// plane's writes stay coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clip_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int* __restrict__ table, const int* __restrict__ idx,
              int* __restrict__ out, int64_t Q, int N) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q < Q) out[q] = table[clip_index(idx[q], N)];
}

__global__ void __launch_bounds__(kThreads)
lookup_rows_kernel(const int* __restrict__ table,
                   const int* __restrict__ idx, int* __restrict__ out,
                   int64_t Q, int N, int W) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= Q) return;
  const int64_t i = clip_index(idx[q], N);
  for (int w = 0; w < W; ++w) out[w * Q + q] = table[w * int64_t{N} + i];
}

unsigned blocks_for(int64_t Q) {
  return static_cast<unsigned>((Q + kThreads - 1) / kThreads);
}

}  // namespace

// table: (N,) int32; idx, out: (Q,) int32; all contiguous.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int pluto_lookup(const int* table, const int* idx, int* out,
                            int64_t Q, int N, void* stream) {
  lookup_kernel<<<blocks_for(Q), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, idx, out, Q, N);
  return static_cast<int>(cudaGetLastError());
}

// table: (W, N) int32; idx: (Q,) int32; out: (W, Q) int32; all contiguous.
extern "C" int pluto_lookup_rows(const int* table, const int* idx, int* out,
                                 int64_t Q, int N, int W, void* stream) {
  lookup_rows_kernel<<<blocks_for(Q), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(table, idx, out,
                                                            Q, N, W);
  return static_cast<int>(cudaGetLastError());
}
