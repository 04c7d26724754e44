// The fixed-point event detection of one read by one CTA, shared by the
// fused cheap-phase kernel (cheap_fused.cu) and the event-detection kernel
// (event_detect.cu): the integer (sqrt-free) t-statistic boundary test runs
// per sample, peaks are picked within +-peak_r, a block-wide scan of the
// boundary flags gives each sample its event id (clamped to E-1), and
// shared-memory integer atomics add the segment sums and counts, exact in
// any order.  Two bodies, one arithmetic:
//
//  - detect_fixed_regs, for window widths known at compile time (the
//    shipped tw = 4, peak_r = 3): each thread holds a run of kP contiguous
//    samples in registers, loaded with 16-byte loads together with the
//    tw-sample halos on either side (read again from L1, not exchanged),
//    and slides its window sums along the run in uint32 (exact: the sums
//    themselves fit int32).  The +-peak_r neighbours of the peak test come
//    from the neighbouring lanes by shuffles, from the neighbouring warps
//    through a few words of shared memory, and (only when S exceeds one
//    pass of kNT*kP samples) from a recomputation at the pass's two ends.
//    There is no shared score array, so no bank conflicts, and a pass
//    takes two barriers: the warp-edge exchange and the block scan;
//  - detect_fixed_block, for any other window widths: the samples staged in
//    shared memory, the windows read there with runtime bounds.
//
// Each thread's run is contiguous, so one block scan numbers its samples
// and a thread adds each of its events' samples in one atomic.
//
// Exactness: the arithmetic follows the reference's boundary_mask_fixed
// operation for operation, in int32 (the config's static bounds keep every
// term in range); the peak score is the IEEE division
// (float)lhs / ((float)rhs + 1); >> on a negative int is arithmetic; the
// peak-pick border fill kFill is below every score (scores are >= 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
// blockDim.x is a multiple of 32.  The warp totals are added by two warp
// reductions (REDUX), not a second shuffle scan.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int x = warp_inclusive_scan(v);
  if (lane == 31) red[w] = x;
  __syncthreads();
  const int rv = lane < nw ? red[lane] : 0;
  *total = __reduce_add_sync(kFull, rv);
  return __reduce_add_sync(kFull, lane < w ? rv : 0) + x;   // warps < w
}

// The boundary test of one sample from its window sums: *above gets
// lhs > rhs, and the peak score lhs / (rhs + 1) is returned.
__device__ __forceinline__ float tstat_score(int sl, int sr, int ql, int qr,
                                             int tw, const DetectParams& p,
                                             bool* above) {
  const int diff = (sr - sl) >> 2;
  const int ssd_l = tw * ql - sl * sl;
  const int ssd_r = tw * qr - sr * sr;
  const int lhs = diff * diff * tw;
  const int rhs = p.tau2 * (((ssd_l + ssd_r) >> 4) + p.eps);
  *above = lhs > rhs;
  return __fdiv_rn(static_cast<float>(lhs),
                   __fadd_rn(static_cast<float>(rhs), 1.0f));
}

// ---------------------------------------------------------------------------
// Register body (compile-time windows).
// ---------------------------------------------------------------------------

// v[0..3] = row[j..j+3], 0 outside [0, S); one 16-byte load when the four
// lie in the row and the row is 16-byte aligned (j is a multiple of 4).
__device__ __forceinline__ void load4(const int* __restrict__ row, int j,
                                      int S, bool vec, int* v) {
  if (vec && j >= 0 && j + 4 <= S) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(row + j));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = (j + k >= 0 && j + k < S) ? __ldg(row + j + k) : 0;
  }
}

// The score of sample i from the row in device memory (kFill outside the
// row): the peak test's neighbours beyond a pass's ends.
template <int kTw>
__device__ float score_at(const int* __restrict__ row, int i,
                          const DetectParams& p) {
  if (i < 0 || i >= p.S) return kFill;
  unsigned sl = 0, sr = 0, ql = 0, qr = 0;
#pragma unroll
  for (int d = 0; d < kTw; ++d) {
    const int il = i - d - 1, ir = i + d;
    const unsigned a = il >= 0 ? __ldg(row + il) : 0;
    const unsigned b = ir < p.S ? __ldg(row + ir) : 0;
    sl += a;
    ql += a * a;
    sr += b;
    qr += b * b;
  }
  bool above;
  return tstat_score(static_cast<int>(sl), static_cast<int>(sr),
                     static_cast<int>(ql), static_cast<int>(qr), kTw, p,
                     &above);
}

// Detects the events of the read `xrow` (S int32 Q-format samples in
// device memory) with kNT threads, kP samples each a pass.  Shared
// scratch: edge (2 * kPeakR * kNT / 32 floats), sums and cnts (E each),
// red (32).  On return (after a barrier) sums[e] and cnts[e] hold each
// event's integer sample sum and count, and the result is
// n_events = min(boundaries + 1, E).
template <int kNT, int kP, int kTw, int kPeakR>
__device__ int detect_fixed_regs(const int* __restrict__ xrow,
                                 const DetectParams& p, float* edge,
                                 int* sums, int* cnts, int* red) {
  static_assert(kNT % 32 == 0 && kP % 4 == 0 && kP <= 32, "kNT, kP");
  static_assert(kTw >= 1 && kPeakR >= 1 && kPeakR <= kP, "windows");
  constexpr int kNW = kNT / 32;
  constexpr int kL = (kTw + 3) / 4 * 4;      // left halo, whole int4s
  constexpr int kR = (kTw + 2) / 4 * 4;      // right halo (tw - 1 samples)
  constexpr int kX = kL + kP + kR;           // xe[k] = x[i0 - kL + k]
  constexpr int kT = kNT * kP;               // samples a pass
  constexpr int kW = kP + kTw;               // window sums a thread needs
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int S = p.S, E = p.E;
  const bool vec = (reinterpret_cast<uintptr_t>(xrow) & 15) == 0;
  float* efirst = edge;                      // [w][d]: warp w's first scores
  float* elast = edge + kNW * kPeakR;        // [w][d]: its last, backwards

  for (int e = tid; e < E; e += kNT) {
    sums[e] = 0;
    cnts[e] = 0;
  }
  int carry = 0;
  for (int c0 = 0; c0 < S; c0 += kT) {
    const int i0 = c0 + tid * kP;

    // ---- the run and its halos: registers, 16-byte loads ----------------
    int xe[kX];
#pragma unroll
    for (int k = 0; k < kX; k += 4) load4(xrow, i0 - kL + k, S, vec, &xe[k]);

    // ---- window sums, slid along the run: ws[m] sums the kTw samples
    //      from i0 - kTw + m; sample j's left window is ws[j], its right
    //      window ws[j + kTw] --------------------------------------------
    unsigned ws[kW], wq[kW];
    {
      unsigned s = 0, q = 0;
#pragma unroll
      for (int d = 0; d < kTw; ++d) {
        const unsigned v = xe[kL - kTw + d];
        s += v;
        q += v * v;
      }
      ws[0] = s;
      wq[0] = q;
#pragma unroll
      for (int m = 1; m < kW; ++m) {
        const unsigned a = xe[kL + m - 1], b = xe[kL - kTw + m - 1];
        s += a - b;
        q += a * a - b * b;
        ws[m] = s;
        wq[m] = q;
      }
    }

    // ---- boundary test and score of each sample ---------------------------
    float sc[kP];
    unsigned above = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      bool ab;
      sc[j] = tstat_score(static_cast<int>(ws[j]),
                          static_cast<int>(ws[j + kTw]),
                          static_cast<int>(wq[j]),
                          static_cast<int>(wq[j + kTw]), kTw, p, &ab);
      if (i0 + j >= S) {
        sc[j] = kFill;
        ab = false;
      }
      above |= static_cast<unsigned>(ab) << j;
    }

    // ---- the peak test's neighbours: lanes by shuffle, warps through
    //      shared memory, the pass's ends recomputed ---------------------
    float lh[kPeakR], rh[kPeakR];    // scores at i0 - d, i0 + kP - 1 + d
#pragma unroll
    for (int d = 1; d <= kPeakR; ++d) {
      lh[d - 1] = __shfl_up_sync(kFull, sc[kP - d], 1);
      rh[d - 1] = __shfl_down_sync(kFull, sc[d - 1], 1);
    }
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < kPeakR; ++d) efirst[w * kPeakR + d] = sc[d];
    }
    if (lane == 31) {
#pragma unroll
      for (int d = 0; d < kPeakR; ++d) elast[w * kPeakR + d] = sc[kP - 1 - d];
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < kPeakR; ++d)
        lh[d] = w > 0 ? elast[(w - 1) * kPeakR + d]
                      : score_at<kTw>(xrow, c0 - 1 - d, p);
    }
    if (lane == 31) {
#pragma unroll
      for (int d = 0; d < kPeakR; ++d)
        rh[d] = w < kNW - 1 ? efirst[(w + 1) * kPeakR + d]
                            : score_at<kTw>(xrow, c0 + kT + d, p);
    }

    // ---- peak pick: above, and no neighbour within +-peak_r scores more
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      bool peak = (above >> j) & 1;
#pragma unroll
      for (int d = 1; d <= kPeakR; ++d) {
        const float lft = j - d >= 0 ? sc[j - d] : lh[d - j - 1];
        const float rgt = j + d < kP ? sc[j + d] : rh[j + d - kP];
        peak = peak && sc[j] >= lft && sc[j] >= rgt;
      }
      bits |= static_cast<unsigned>(peak) << j;
    }

    // ---- event ids (block scan) and the run's segment sums ---------------
    int pass_total;
    const int nb = __popc(bits);
    int id = carry + block_scan(nb, red, &pass_total) - nb;
    int cur = -1, s_acc = 0, c_acc = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      if (i0 + j < S) {
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
        s_acc += xe[kL + j];
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

// ---------------------------------------------------------------------------
// Shared-memory body (runtime windows).
// ---------------------------------------------------------------------------

// Detects the events of the read `xrow` (S int32 Q-format samples in
// device memory) for any tw and peak_r.  Shared scratch: x and score (S
// each), above (S bytes), sums and cnts (E each), red (32).  On return
// (after a barrier) sums[e] and cnts[e] hold each event's integer sample
// sum and count, and the result is n_events = min(boundaries + 1, E).
__device__ int detect_fixed_block(const int* __restrict__ xrow,
                                  const DetectParams& p, int* x,
                                  float* score, unsigned char* above,
                                  int* sums, int* cnts, int* red) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int S = p.S, E = p.E, tw = p.tw, peak_r = p.peak_r;

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
    bool ab;
    score[i] = tstat_score(sl, sr, ql, qr, tw, p, &ab);
    above[i] = ab;
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
