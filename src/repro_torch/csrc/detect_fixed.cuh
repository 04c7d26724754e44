// The fixed-point event detection of one read by one CTA, shared by the
// fused cheap-phase kernel (cheap_fused.cu) and the event-detection kernel
// (event_detect.cu): the Q-format samples are staged in shared memory, the
// integer (sqrt-free) t-statistic boundary test runs per sample, peaks are
// picked within +-peak_r, a block-wide scan of the boundary flags gives
// each sample its event id (clamped to E-1), and shared-memory integer
// atomics add the segment sums and counts, exact in any order.
//
// The peak pick gives each thread a contiguous run of samples, so one block
// scan numbers them all and a thread adds each of its events' samples in
// one atomic.  The window widths may be template constants (the shipped
// tw and peak_r), so their loops unroll; 0 takes them from DetectParams.
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

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Inclusive prefix sum of v in thread order; *total gets the block sum.
// `red` holds 32 ints, read by no thread since the last barrier;
// blockDim.x is a multiple of 32.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int x = warp_inclusive_scan(v);
  if (lane == 31) red[w] = x;
  __syncthreads();
  const int s = warp_inclusive_scan(lane < nw ? red[lane] : 0);
  const int before = __shfl_sync(kFull, s, (w + 31) & 31);  // warps < w
  *total = __shfl_sync(kFull, s, nw - 1);
  return (w > 0 ? before : 0) + x;
}

// Detects the events of the read `xrow` (S int32 Q-format samples in
// device memory).  Shared scratch: x and score (S each), above (S bytes),
// sums and cnts (E each), red (32).  On return (after a barrier) sums[e]
// and cnts[e] hold each event's integer sample sum and count, and the
// result is n_events = min(boundaries + 1, E).
template <int kTw = 0, int kPeakR = 0>
__device__ int detect_fixed_block(const int* __restrict__ xrow,
                                  const DetectParams& p, int* x,
                                  float* score, unsigned char* above,
                                  int* sums, int* cnts, int* red) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int S = p.S, E = p.E;
  const int tw = kTw ? kTw : p.tw;
  const int peak_r = kPeakR ? kPeakR : p.peak_r;

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
#pragma unroll
    for (int d = 0; d < tw; ++d) {
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
    const int ssd_l = tw * ql - sl * sl;
    const int ssd_r = tw * qr - sr * sr;
    const int lhs = diff * diff * tw;
    const int rhs = p.tau2 * (((ssd_l + ssd_r) >> 4) + p.eps);
    above[i] = lhs > rhs;
    score[i] = __fdiv_rn(static_cast<float>(lhs),
                         __fadd_rn(static_cast<float>(rhs), 1.0f));
  }
  __syncthreads();

  // ---- peak pick, event-id prefix scan, integer segment sums -------------
  // Thread t takes samples [c0 + t*per, c0 + (t+1)*per) of each pass; a
  // pass holds NT*per samples, per <= 32 (one flag bit each).
  const int per = min((S + NT - 1) / NT, 32);
  int carry = 0;
  for (int c0 = 0; c0 < S; c0 += NT * per) {
    if (c0 > 0) __syncthreads();      // red of the previous pass is read
    const int i0 = c0 + tid * per;
    unsigned bits = 0;
    for (int j = 0; j < per; ++j) {
      const int i = i0 + j;
      if (i < S) {
        const float sc = score[i];
        float wmax = sc, lmax = sc;
#pragma unroll
        for (int d = 1; d <= peak_r; ++d) {
          const float lft = (i - d >= 0) ? score[i - d] : kFill;
          const float rgt = (i + d < S) ? score[i + d] : kFill;
          wmax = fmaxf(wmax, fmaxf(lft, rgt));
          lmax = fmaxf(lmax, lft);
        }
        if (sc >= wmax && sc >= lmax && above[i]) bits |= 1u << j;
      }
    }
    int pass_total;
    const int nb = __popc(bits);
    int id = carry + block_scan(nb, red, &pass_total) - nb;
    int cur = -1, s_acc = 0, c_acc = 0;
    for (int j = 0; j < per; ++j) {
      const int i = i0 + j;
      if (i < S) {
        id += (bits >> j) & 1;
        const int e = min(id, E - 1);
        if (e != cur) {
          if (c_acc) {
            atomicAdd(&sums[cur], s_acc);
            atomicAdd(&cnts[cur], c_acc);
          }
          cur = e;
          s_acc = 0;
          c_acc = 0;
        }
        s_acc += x[i];
        ++c_acc;
      }
    }
    if (c_acc) {
      atomicAdd(&sums[cur], s_acc);
      atomicAdd(&cnts[cur], c_acc);
    }
    carry += pass_total;
  }
  __syncthreads();
  return min(carry + 1, E);
}

}  // namespace
