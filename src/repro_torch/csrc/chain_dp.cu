// Banded chaining DP over sorted anchors (minimap2-style, look-back band of
// B = 32 predecessors held in a ring buffer).
//
// Replaces: src/repro/kernels/chain_dp/chain_dp.py::chain_dp_kernel
// (the pl.pallas_call at :89, body _kernel at :36).
//
// What bounds it on the H100: neither roof.  Per read it moves 17 bytes per
// anchor (q, t, valid in; f, diag0 out) and does about 15 operations per
// anchor and band slot, but anchor i depends on anchor i-1, so a read is a
// chain of A dependent steps; the card is latency-bound, and only many
// reads in flight at once hide that.
//
// Design: one warp per read, one lane per band slot.  Lane l holds the band
// entry of the anchor i with i % 32 == l, so the ring buffer lives in
// registers and the step's best predecessor is a warp-shuffle max.  Ties go
// to the OLDEST slot (age rank k = (lane - i) mod B, then a shuffle min of
// k), as the reference's age-ordered window does.  Anchors are loaded 32 at
// a time, one per lane, and broadcast with shuffles; after 32 steps lane l
// holds f and diag0 of anchor base + l, so the outputs are written as one
// coalesced store per block of 32.
//
// Float exactness: the reference (the JAX DP compiled by XLA on the CPU)
// contracts cand = bf - gap_cost*gap - skip_cost*skip into two fused
// multiply-adds, so the kernel evaluates exactly
// fma(-skip_cost, skip, fma(-gap_cost, gap, bf)) with __fmaf_rn, and the
// plain torch version (core/chaining.fma_f32) does the same.  Every other
// float operation rounds on its own: the library is built with -fmad=false.
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;              // one lane per band slot
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;          // chaining.NEG
constexpr int kSent = -(1 << 30);      // chaining._SENT

__global__ void chain_dp_kernel(const int* __restrict__ q,
                                const int* __restrict__ t,
                                const unsigned char* __restrict__ valid,
                                float* __restrict__ f_out,
                                int* __restrict__ d_out, int rows, int A,
                                int max_gap, float gap_cost, float skip_cost,
                                float anchor_score) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;               // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * A;
  float bf = kNeg;
  int bd = 0;
  int bt = kSent;
  int bq = kSent;
  for (int base = 0; base < A; base += kBand) {
    const int n = min(kBand, A - base);
    int my_t = 0, my_q = 0, my_v = 0;
    if (lane < n) {
      my_t = t[off + base + lane];
      my_q = q[off + base + lane];
      my_v = valid[off + base + lane];
    }
    for (int s = 0; s < n; ++s) {
      const int i = base + s;
      const int ti = __shfl_sync(kFull, my_t, s);
      const int qi = __shfl_sync(kFull, my_q, s);
      const int vi = __shfl_sync(kFull, my_v, s);
      const int dt = ti - bt;
      const int dq = qi - bq;
      const bool ok = dt > 0 && dq > 0 && dt <= max_gap && dq <= max_gap;
      const float gap = static_cast<float>(abs(dt - dq));
      const float skip = static_cast<float>(min(dt, dq));
      float cand = __fmaf_rn(-skip_cost, skip,
                             __fmaf_rn(-gap_cost, gap, bf));
      if (!(ok && bf > kNeg * 0.5f)) cand = kNeg;
      float best = cand;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
      // oldest-first tie-break: age rank k = 0 is the oldest band slot
      const int k = (lane - i) & (kBand - 1);
      int kbest = (cand == best) ? k : kBand;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        kbest = min(kbest, __shfl_xor_sync(kFull, kbest, o));
      const int dbest = __shfl_sync(kFull, bd, (kbest + i) & (kBand - 1));
      float fi = __fadd_rn(anchor_score, fmaxf(best, 0.0f));
      if (!vi) fi = kNeg;
      const int di = (best > 0.0f) ? dbest : ti - qi;
      if (lane == (i & (kBand - 1))) {
        bf = fi;
        bd = di;
        bt = ti;
        bq = qi;
      }
    }
    if (lane < n) {
      f_out[off + base + lane] = bf;
      d_out[off + base + lane] = bd;
    }
  }
}

}  // namespace

// q, t: (rows, A) int32; valid: (rows, A) bool (one byte each); f_out
// (rows, A) f32, d_out (rows, A) int32; all contiguous.  The band is fixed
// at 32 (the wrapper rejects any other chain_band).  Launches on `stream`;
// returns cudaGetLastError() of the launch.
extern "C" int chain_dp_rows(const int* q, const int* t,
                             const unsigned char* valid, float* f_out,
                             int* d_out, int rows, int A, int max_gap,
                             float gap_cost, float skip_cost,
                             float anchor_score, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_dp_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      q, t, valid, f_out, d_out, rows, A, max_gap, gap_cost, skip_cost,
      anchor_score);
  return static_cast<int>(cudaGetLastError());
}
