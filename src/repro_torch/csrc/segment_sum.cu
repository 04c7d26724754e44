// In-order segment sums of an f32 signal: sums[r, e] adds the samples
// i < valid_len with eid[r, i] == e in sample order, starting from 0, and
// counts[r, e] counts them.
//
// A helper of the float event detection, not the port of a TPU kernel: it
// stands for the reference's jax.ops.segment_sum
// (src/repro/core/events.py:301, segment_means_reference), which XLA's CPU
// scatter adds in update order.  Float addition does not associate, so an
// atomic scatter (torch's index_add_ on CUDA) gives other bits, and other
// bits from run to run.
//
// What bounds it: latency.  One thread per read walks its S samples in
// order (S dependent f32 adds); the bytes are R*S*8 in and R*E*8 out.
// The running sum of the current segment stays in a register and goes to
// memory only when the event id changes; a segment met again (never, for
// the nondecreasing ids the detection gives) resumes from its stored sum,
// so the order is the sample order for any ids.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, const int* __restrict__ eid,
                   float* sums, float* cnts, int R, int S, int valid_len,
                   int n_seg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* xr = x + static_cast<size_t>(r) * S;
  const int* er = eid + static_cast<size_t>(r) * S;
  float* sr = sums + static_cast<size_t>(r) * n_seg;
  float* cr = cnts + static_cast<size_t>(r) * n_seg;
  for (int e = 0; e < n_seg; ++e) {
    sr[e] = 0.0f;
    cr[e] = 0.0f;
  }
  int cur = er[0];
  float acc = 0.0f;
  int n = 0;
  for (int i = 0; i < valid_len; ++i) {
    const int e = er[i];
    if (e != cur) {
      sr[cur] = acc;
      cr[cur] = __fadd_rn(cr[cur], static_cast<float>(n));
      cur = e;
      acc = sr[cur];
      n = 0;
    }
    acc = __fadd_rn(acc, xr[i]);
    ++n;
  }
  sr[cur] = acc;
  cr[cur] = __fadd_rn(cr[cur], static_cast<float>(n));
}

}  // namespace

// x: (R, S) f32; eid: (R, S) int32 in [0, n_seg); sums, counts: (R, n_seg)
// f32; all contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int segment_sum_rows(const float* x, const int* eid, float* sums,
                                float* counts, int R, int S, int valid_len,
                                int n_seg, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  segment_sum_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, eid, sums, counts, R, S, valid_len, n_seg);
  return static_cast<int>(cudaGetLastError());
}
