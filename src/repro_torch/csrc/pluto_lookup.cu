// Clipping gathers of the hash-table query: out[q] = table[clip(idx[q])]
// over the 1-D bucket-offset table, and out[w, q] = table[w, clip(idx[q])]
// over the (W, N) packed entry rows, clip(i) = min(max(i, 0), N - 1).
//
// Replaces: src/repro/kernels/pluto_lookup/pluto_lookup.py::pluto_lookup
// (the pl.pallas_call at :125, body _kernel at :40) and ::pluto_lookup_rows
// (the pl.pallas_call at :97, body _kernel_rows at :63).
//
// What bounds it on the H100: bytes by count, latency in practice.  Each
// query reads its index and W table words and writes W words.  The index
// reads and output writes are coalesced; the table reads are random, but
// the largest packed entry plane (D5, ~33 MB) and the 1 MB bucket table
// stay in the 50 MB L2.  The 1-D gather of a D5 chunk (196,608 queries,
// 1.6 MB moved, 0.5 us at the HBM rate) is the launch, two dependent L2
// round trips (the index, then the table word it names) and the L2
// sectors its random reads touch: one 32-byte sector for each 4-byte word.
//
// Design: the TPU's one-hot MXU sweep of every table tile against every
// query block, and its split of 32-bit words into exact f32 halves, were
// workarounds for a machine without a gather; they do not carry over.
//  - The 1-D gather pairs the two halves of idx in neighbouring lanes:
//    lanes 2k and 2k+1 take query k of the first half and query k of the
//    second.  The query issues its bucket offsets as the stacked
//    (bucket, bucket + 1), so a warp's 32 table loads fall as 16 pairs of
//    adjacent words, mostly one sector a pair, and the sectors it touches
//    nearly halve; any other idx is gathered just as right.  Each thread
//    takes kQ such slots a grid apart, issues all their index loads, then
//    all their table loads, then the stores (192 CTAs for a D5 chunk, under
//    one wave).  The loads and stores are 4 bytes a lane and coalesced in
//    two runs a warp, so no pointer needs 16-byte alignment.  (Consecutive
//    queries a thread with 16-byte index loads and stores were slower: a
//    thread's gathers do not share a warp instruction, so they touch as
//    many sectors, and fewer CTAs leave SMs unevenly loaded.)
//  - The rows variant is one thread per query: it loads all W words of
//    its row and writes plane w at [w * Q + q], so each plane's writes
//    stay coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 4;                 // 1-D gather: slots a thread

__device__ __forceinline__ int clip_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The 1-D gather.  Slot s of the grid's kQ * T slots (T threads) is query
// s/2 of the first half of idx (s even) or of the second (s odd); thread t
// takes slots t, t + T, ..., and thread 0 also the last query when Q is
// odd.
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int* __restrict__ table, const int* __restrict__ idx,
              int* __restrict__ out, int64_t Q, int N) {
  const int64_t half = Q / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t T = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t q[kQ];
  int v[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int64_t s = t + k * T;
    q[k] = (s >> 1) < half ? (s >> 1) + (s & 1) * half : -1;
    if (q[k] >= 0) v[k] = __ldg(idx + q[k]);
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    if (q[k] >= 0) v[k] = __ldg(table + clip_index(v[k], N));
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    if (q[k] >= 0) out[q[k]] = v[k];
  if (t == 0 && (Q & 1))
    out[Q - 1] = __ldg(table + clip_index(__ldg(idx + Q - 1), N));
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
  // Q / 2 * 2 slots, kQ a thread; one block at least (the odd query)
  const int64_t per_block = int64_t{kQ} * kThreads;
  const int64_t blocks = (Q / 2 * 2 + per_block - 1) / per_block;
  lookup_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(table, idx, out, Q,
                                                         N);
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
