// The fixed-point event detection of one read by one CTA, shared by the
// fused cheap-phase kernel (cheap_fused.cu) and the event-detection kernel
// (event_detect.cu): the Q-format samples are staged in shared memory, the
// integer (sqrt-free) t-statistic boundary test runs per sample, peaks are
// picked within +-peak_r, a block-wide scan of the boundary flags gives
// each sample its event id (clamped to E-1), and shared-memory integer
// atomics add the segment sums and counts, exact in any order.
//
// Exactness: the arithmetic follows the reference's boundary_mask_fixed
// operation for operation, in int32 (the config's static bounds keep every
// term in range); the peak score is the IEEE division
// (float)lhs / ((float)rhs + 1); >> on a negative int is arithmetic.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kFill = -3.0e38f;     // peak-pick border fill

// The detection's part of the config.
struct DetectParams {
  int S, E, tw, tau2, eps, peak_r;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Inclusive prefix sum of v in thread order; *total gets the block sum.
// `red` holds 32 ints; blockDim.x is a multiple of 32.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[w] = x;
  __syncthreads();
  int pre = 0, tot = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    const int s = red[k];
    if (k < w) pre += s;
    tot += s;
  }
  *total = tot;
  return pre + x;
}

// Detects the events of the read `xrow` (S int32 Q-format samples in
// device memory).  Shared scratch: x and score (S each), above (S bytes),
// sums and cnts (E each), red (32).  On return (after a barrier) sums[e]
// and cnts[e] hold each event's integer sample sum and count, and the
// result is n_events = min(boundaries + 1, E).
__device__ int detect_fixed_block(const int* __restrict__ xrow,
                                  const DetectParams& p, int* x,
                                  float* score, unsigned char* above,
                                  int* sums, int* cnts, int* red) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int S = p.S, E = p.E;

  // ---- stage the read's Q-format samples ---------------------------------
  for (int i = tid; i < S; i += NT) x[i] = xrow[i];
  for (int e = tid; e < E; e += NT) {
    sums[e] = 0;
    cnts[e] = 0;
  }
  __syncthreads();

  // ---- integer (sqrt-free) t-stat boundary test --------------------------
  for (int i = tid; i < S; i += NT) {
    int sl = 0, sr = 0, ql = 0, qr = 0;
    for (int d = 0; d < p.tw; ++d) {
      const int il = i - d - 1;
      if (il >= 0) {
        const int v = x[il];
        sl += v;
        ql += v * v;
      }
      const int ir = i + d;
      if (ir < S) {
        const int v = x[ir];
        sr += v;
        qr += v * v;
      }
    }
    const int diff = (sr - sl) >> 2;
    const int ssd_l = p.tw * ql - sl * sl;
    const int ssd_r = p.tw * qr - sr * sr;
    const int lhs = diff * diff * p.tw;
    const int rhs = p.tau2 * (((ssd_l + ssd_r) >> 4) + p.eps);
    above[i] = lhs > rhs;
    score[i] = __fdiv_rn(static_cast<float>(lhs),
                         __fadd_rn(static_cast<float>(rhs), 1.0f));
  }
  __syncthreads();

  // ---- peak pick, event-id prefix scan, integer segment sums -------------
  int carry = 0;
  for (int c0 = 0; c0 < S; c0 += NT) {
    const int i = c0 + tid;
    int b = 0, xi = 0;
    if (i < S) {
      const float sc = score[i];
      float wmax = sc, lmax = sc;
      for (int d = 1; d <= p.peak_r; ++d) {
        const float lft = (i - d >= 0) ? score[i - d] : kFill;
        const float rgt = (i + d < S) ? score[i + d] : kFill;
        wmax = fmaxf(wmax, fmaxf(lft, rgt));
        lmax = fmaxf(lmax, lft);
      }
      b = (sc >= wmax && sc >= lmax && above[i]) ? 1 : 0;
      xi = x[i];
    }
    int chunk_total;
    const int eid = carry + block_scan(b, red, &chunk_total);
    if (i < S) {
      const int e = min(eid, E - 1);
      atomicAdd(&sums[e], xi);
      atomicAdd(&cnts[e], 1);
    }
    carry += chunk_total;
  }
  __syncthreads();
  return min(carry + 1, E);
}

}  // namespace
