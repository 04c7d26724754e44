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
// What bounds it: latency.  The bytes are R*S*8 in and R*n_seg*8 out
// (1.5 us at the HBM rate for 512 rows of 1024 samples); the order fixes
// one add after another within a segment, never across segments.  A
// chunk's rows are one wave, and a row's path is the load of its samples,
// four barriers and its longest segment's chain of dependent f32 adds
// (216 samples at most in the D5 chunk chip_smoke.py times).
//
// Design: one CTA per read, segment-parallel.  The row is staged into
// shared memory in tiles of kTile samples (coalesced loads); each segment's
// running sum and count stay in shared memory from tile to tile.  In a tile
// whose ids never decrease (the detection's clamped cumsum gives such ids)
// every segment is one run: the run boundaries mark each segment's first
// and last sample, and one thread per segment adds its run in order from
// shared memory, a few cycles a sample.  A tile whose ids do decrease,
// which a block-wide vote finds, is summed exactly too: one thread per
// segment scans the whole tile in sample order.  Either way each sum is
// ((0 + x[a]) + x[b]) + ... in sample order, and each count an integer,
// written as f32 (exact below 2^24 samples, which the wrapper requires).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;      // samples staged per pass

size_t smem_bytes(int n_seg) {
  return 8 * static_cast<size_t>(kTile) + 16 * static_cast<size_t>(n_seg);
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, const int* __restrict__ eid,
                   float* __restrict__ sums, float* __restrict__ cnts, int S,
                   int valid_len, int n_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);     // kTile samples
  int* es = reinterpret_cast<int*>(xs + kTile);       // kTile ids
  float* acc = reinterpret_cast<float*>(es + kTile);  // n_seg running sums
  int* cnt = reinterpret_cast<int*>(acc + n_seg);     // n_seg running counts
  int* first = cnt + n_seg;   // a segment's run in the tile: [first, last)
  int* last = first + n_seg;
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const float* xr = x + r * S;
  const int* er = eid + r * S;

  for (int e = tid; e < n_seg; e += kThreads) {
    acc[e] = 0.0f;
    cnt[e] = 0;
    first[e] = 0;
    last[e] = 0;
  }
  for (int t0 = 0; t0 < valid_len; t0 += kTile) {
    const int n = min(kTile, valid_len - t0);
    __syncthreads();                  // the previous tile is summed
    for (int i = tid; i < n; i += kThreads) {
      xs[i] = xr[t0 + i];
      es[i] = er[t0 + i];
    }
    __syncthreads();
    bool descends = false;
    for (int i = tid; i < n; i += kThreads) {
      const int e = es[i];
      if (i > 0 && es[i - 1] > e) descends = true;
      if (i == 0 || es[i - 1] != e) first[e] = i;
      if (i == n - 1 || es[i + 1] != e) last[e] = i + 1;
    }
    if (__syncthreads_or(descends)) {
      for (int e = tid; e < n_seg; e += kThreads) {
        float a = acc[e];
        int c = cnt[e];
        for (int i = 0; i < n; ++i) {
          if (es[i] == e) {
            a = __fadd_rn(a, xs[i]);
            ++c;
          }
        }
        acc[e] = a;
        cnt[e] = c;
        first[e] = 0;
        last[e] = 0;
      }
    } else {
      for (int e = tid; e < n_seg; e += kThreads) {
        const int a0 = first[e], a1 = last[e];
        if (a1 > a0) {
          float a = acc[e];
#pragma unroll 8
          for (int i = a0; i < a1; ++i) a = __fadd_rn(a, xs[i]);
          acc[e] = a;
          cnt[e] += a1 - a0;
          first[e] = 0;
          last[e] = 0;
        }
      }
    }
  }
  __syncthreads();
  float* sr = sums + r * n_seg;
  float* cr = cnts + r * n_seg;
  for (int e = tid; e < n_seg; e += kThreads) {
    sr[e] = acc[e];
    cr[e] = static_cast<float>(cnt[e]);
  }
}

}  // namespace

// x: (R, S) f32; eid: (R, S) int32 in [0, n_seg); sums, counts: (R, n_seg)
// f32; all contiguous; valid_len < 2^24.  Launches on `stream`; returns
// cudaGetLastError(), or the error of cudaFuncSetAttribute when n_seg needs
// more shared memory than a CTA may take.
extern "C" int segment_sum_rows(const float* x, const int* eid, float* sums,
                                float* counts, int R, int S, int valid_len,
                                int n_seg, void* stream) {
  const size_t smem = smem_bytes(n_seg);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  segment_sum_kernel<<<R, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, eid, sums, counts, S, valid_len, n_seg);
  return static_cast<int>(cudaGetLastError());
}
