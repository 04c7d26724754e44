// Banded chaining DP over sorted anchors (minimap2-style, look-back band of
// B predecessors held in a ring buffer).  Two kernels: the shipped one for
// the default B = 32 (chain_dp_kernel, one lane per band slot, below), and
// one for any other band (chain_dp_band_kernel, after it).
//
// Replaces: src/repro/kernels/chain_dp/chain_dp.py::chain_dp_kernel
// (the pl.pallas_call at :89, body _kernel at :36).
//
// What bounds it on the H100: neither roof.  Per read it moves 17 bytes per
// anchor (q, t, valid in; f, diag0 out) and does about 15 operations per
// anchor and band slot, but anchor i depends on anchor i-1, so a read is a
// chain of A dependent steps, and with one warp per read (512 reads on 528
// schedulers) each scheduler runs one warp: the time is A times one step.
//
// Design: one warp per read, one lane per band slot.  Lane l holds the band
// entry (f, diag0, t, q) of the newest anchor j with j % 32 == l, so the
// ring buffer lives in registers.  Anchors are loaded 32 at a time, one per
// lane (the next block is fetched while the current one runs), and after
// the block's 32 steps lane l holds f and diag0 of anchor base + l, written
// as one coalesced store.
//
// Step i looks back at anchors i-32 .. i-1.  It is split in two, so that
// only the newest anchor's candidate lies on the anchor-to-anchor chain:
//   - the 31 OLDER slots (anchors i-32 .. i-2) were final before step i-1
//     began, so the loop body of step i-1 reduces them for step i, beside
//     its own chain.  Each lane forms its slot's candidate, maps it to an
//     order-preserving int32 image, and one __reduce_max_sync gives the
//     best; one __reduce_min_sync over the age ranks k = (l - i) mod 32 of
//     the slots that reach it gives the oldest, and one shuffle fetches
//     that slot's diag0.
//   - the NEWEST slot (anchor i-1): every lane holds f, diag0, t and q of
//     anchor i-1 (it computed them itself), so it forms that candidate with
//     no shuffle and merges it with a STRICT `cand_new > older_best`: the
//     newest slot has the largest age rank, so on a tie the older slot wins,
//     as the reference's oldest-first rule says.
// The anchors' coordinates a step needs are shuffled out one step early,
// and dt, dq, ok, gap and skip depend on them alone, so only bf is on the
// chain.  Merging only the newest slot on the chain measured fastest: the
// newest 2, 3 or 4 slots give the reduction more steps of slack but put
// more candidates and registers on every step, and were slower (PERF.md).
//
// What the SASS shows (sm_90a; ptxas: 48 registers, no spills; counts
// from chip_smoke.py's build phase): the loop runs 4 steps unrolled in 301
// instructions, about 75 a step, 4 shuffles and 2 REDUX among them.  The
// chain itself is 8 dependent instructions (FFMA, FFMA, FSEL, FSETP, FSEL,
// FMNMX, FADD, FSEL; about 35 cycles); the older slots' reduction (about
// 12 dependent instructions and the two REDUX) runs beside the next step's
// chain.  The measured step is about 150 cycles (0.0392 ms for 512
// anchors at 1,980 MHz, PERF.md): one warp per scheduler issues its 75
// instructions at about half an instruction a cycle, so the step's
// instruction stream, not the chain's latency, sets the pace.  The
// schedule matters as much as the count: the slot key written as a select
// (INT_MIN for the newest slot, else the image) in place of the min with
// a cap gave 305 instructions and a step 58% slower.
//
// The int32 image x -> i ^ ((i >> 31) & 0x7fffffff), i the bits of x,
// orders finite floats as < does, and equal images are equal floats,
// except that -0.0 and +0.0 map apart.  -0.0 cannot occur here: a
// candidate is NEG or fma(-skip_cost, skip, fma(-gap_cost, gap, bf)) with
// bf > NEG/2, and bf is NEG or anchor_score + max(best, 0) >= anchor_score,
// which is > 0 in every config of the repo; an FMA whose exact result is
// zero rounds to +0.0 unless both its product and its addend are -0.0.
// The image maps -0.0 to +0.0's all the same (one select, off the chain),
// so the order equals fmaxf's and =='s for any anchor_score.
//
// Float exactness: the reference (the JAX DP compiled by XLA on the CPU)
// contracts cand = bf - gap_cost*gap - skip_cost*skip into two fused
// multiply-adds, so the kernel evaluates exactly
// fma(-skip_cost, skip, fma(-gap_cost, gap, bf)) with __fmaf_rn for every
// candidate, the newest's included, and the plain torch version
// (core/chaining.fma_f32) does the same.  The split changes the order of
// evaluation only, never a rounding.  Every other float operation rounds
// on its own: the library is built with -fmad=false.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kBand = 32;              // one lane per band slot
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;          // chaining.NEG
constexpr int kSent = -(1 << 30);      // chaining._SENT

struct Costs {
  int max_gap;
  float neg_gap_cost, neg_skip_cost, anchor_score;
};

// the candidate score of a predecessor with score bf at (dt, dq) back
__device__ __forceinline__ float candidate(float bf, int dt, int dq,
                                           const Costs& c) {
  const bool ok = dt > 0 && dq > 0 && dt <= c.max_gap && dq <= c.max_gap;
  const float gap = static_cast<float>(abs(dt - dq));
  const float skip = static_cast<float>(min(dt, dq));
  const float cand = __fmaf_rn(c.neg_skip_cost, skip,
                               __fmaf_rn(c.neg_gap_cost, gap, bf));
  return (ok && bf > kNeg * 0.5f) ? cand : kNeg;
}

// order-preserving int32 image of a finite float, -0.0 taken as +0.0
__device__ __forceinline__ int order_key(float x) {
  int i = __float_as_int(x);
  i = i == INT_MIN ? 0 : i;
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    chain_dp_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ f_out, int* __restrict__ d_out,
                    int rows, int A, Costs c) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;               // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * A;
  // this lane's slot: f, diag0, t and q of its newest anchor (a sentinel
  // before anchor 0)
  float bf = kNeg;
  int bd = 0, bt = kSent, bq = kSent;
  // the anchors of the current block and of the next, one per lane
  int cur_t = 0, cur_q = 0, cur_v = 0;
  if (lane < A) {
    cur_t = __ldg(t + off + lane);
    cur_q = __ldg(q + off + lane);
    cur_v = __ldg(valid + off + lane);
  }
  // The chain's scalars, the same in every lane: the newest anchor's entry
  // (anchor i-1: f, diag0, t, q), the older slots' best for step i, and the
  // coordinates of anchors i and i+1 (anchor i+1's fetched a step before
  // the step that first reads them).  Before anchor 0 every slot is a
  // sentinel: f = NEG, diag0 = 0, t = q = _SENT, and so is the best of an
  // all-sentinel band.
  float new_f = kNeg, older_f = kNeg;
  int new_d = 0, new_t = kSent, new_q = kSent, older_d = 0;
  int t_i = __shfl_sync(kFull, cur_t, 0), q_i = __shfl_sync(kFull, cur_q, 0),
      v_i = __shfl_sync(kFull, cur_v, 0);
  int t_n = __shfl_sync(kFull, cur_t, 1), q_n = __shfl_sync(kFull, cur_q, 1),
      v_n = __shfl_sync(kFull, cur_v, 1);
  for (int base = 0; base < A; base += kBand) {
    const int n = min(kBand, A - base);
    int nxt_t = 0, nxt_q = 0, nxt_v = 0;
    if (base + kBand + lane < A) {
      nxt_t = __ldg(t + off + base + kBand + lane);
      nxt_q = __ldg(q + off + base + kBand + lane);
      nxt_v = __ldg(valid + off + base + kBand + lane);
    }
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      // Off the chain: the older slots of step i + 1 (i = base + s), whose
      // anchors i-31 .. i-1 are all final.  Lane s holds the newest anchor
      // of that step (anchor i), which the chain merges, and offers
      // INT_MIN.  Past the last anchor the step is computed on zeros and
      // never used.
      const int ahead = s + 1;
      const int src = ahead & (kBand - 1);      // the oldest slot's lane
      const int fetch = ahead + 1;              // anchor i+2, for step i+1
      const bool here = fetch < kBand;
      const int tf = __shfl_sync(kFull, here ? cur_t : nxt_t,
                                 fetch & (kBand - 1));
      const int qf = __shfl_sync(kFull, here ? cur_q : nxt_q,
                                 fetch & (kBand - 1));
      const int vf = __shfl_sync(kFull, here ? cur_v : nxt_v,
                                 fetch & (kBand - 1));
      const int rank = (lane - ahead) & (kBand - 1);   // 0 = oldest
      const int cap = rank >= kBand - 1 ? INT_MIN : INT_MAX;
      const float cand_o = candidate(bf, t_n - bt, q_n - bq, c);
      const int key = min(order_key(cand_o), cap);
      const int kmax = __reduce_max_sync(kFull, key);
      const int kbest = __reduce_min_sync(
          kFull, key == kmax ? static_cast<unsigned>(rank) : kBand);
      const float next_f = from_key(kmax);
      const int next_d = __shfl_sync(kFull, bd, (kbest + src) & (kBand - 1));
      // On the chain, step i: the newest anchor's candidate merged into the
      // older slots' best by a strict > (on a tie the older slot, of
      // smaller age rank, keeps it)
      float best = older_f;
      int dbest = older_d;
      const float cand = candidate(new_f, t_i - new_t, q_i - new_q, c);
      if (cand > best) {
        best = cand;
        dbest = new_d;
      }
      float fi = __fadd_rn(c.anchor_score, fmaxf(best, 0.0f));
      if (!v_i) fi = kNeg;
      const int di = best > 0.0f ? dbest : t_i - q_i;
      if (lane == s) {
        bf = fi;
        bd = di;
        bt = t_i;
        bq = q_i;
      }
      new_f = fi;
      new_d = di;
      new_t = t_i;
      new_q = q_i;
      older_f = next_f;
      older_d = next_d;
      t_i = t_n;
      q_i = q_n;
      v_i = v_n;
      t_n = tf;
      q_n = qf;
      v_n = vf;
    }
    if (lane < n) {
      f_out[off + base + lane] = bf;
      d_out[off + base + lane] = bd;
    }
    cur_t = nxt_t;
    cur_q = nxt_q;
    cur_v = nxt_v;
  }
}

// ---------------------------------------------------------------------------
// Any band B >= 1 (chain_band != 32).
//
// One warp per read; band slot s (the newest anchor j with j % B == s) lives
// in lane s % 32, at register (or scratch entry) s / 32: SLOTS = ceil(B / 32)
// slots a lane, the lanes past B masked off when B < 32.  Up to 2 slots a
// lane the band stays in registers (B <= 64); a wider band lives in a
// global scratch row of B int4 entries per read, each entry read and written
// by the one lane that owns it, so no lane ever sees another's writes.
// More slots would not stay in registers: ptxas puts a band of 4 or 8
// slots a lane in a local-memory stack frame, the scratch row's memory
// class.
//
// Step i is the reference's step as written: every lane forms the
// candidates of its slots, keeps the best by (score, then smallest age rank
// k = (s - i) mod B, 0 the oldest), and the warp reduces that pair: a
// __reduce_max_sync of the order-preserving score image, a __reduce_min_sync
// of the age ranks that reach it, and one shuffle of diag0 from the lane
// owning the winning slot (s = (i + k) mod B).  So the tie rule is the
// reference's, first (oldest) index on equal score, across slots and lanes.
// The same candidate() (two __fmaf_rn) and __fadd_rn as the B = 32 kernel.
// The wrapper passes B = min(chain_band, A): with B >= A every earlier
// anchor of the read is in the band, as it is with any wider band, and the
// extra slots are sentinels whose candidate is NEG.
//
// What bounds it: as the B = 32 kernel, the anchor-to-anchor chain; here
// the whole step is on it (no look-ahead split), SLOTS candidates, two
// REDUX and four shuffles a step.  A simple kernel first (PERF.md).
template <int SLOTS>   // > 0: slots a lane in registers; 0: band in scratch
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    chain_dp_band_kernel(const int* __restrict__ q, const int* __restrict__ t,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ f_out, int* __restrict__ d_out,
                         int rows, int A, int B, Costs c,
                         int4* __restrict__ scratch) {
  constexpr int kRegs = SLOTS > 0 ? SLOTS : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;               // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * A;
  float bf[kRegs];
  int bd[kRegs], bt[kRegs], bq[kRegs];
  int4* band = nullptr;
  if constexpr (SLOTS > 0) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      bf[j] = kNeg;
      bd[j] = 0;
      bt[j] = kSent;
      bq[j] = kSent;
    }
  } else {
    band = scratch + static_cast<size_t>(row) * B;
    for (int sl = lane; sl < B; sl += 32)
      band[sl] = make_int4(__float_as_int(kNeg), 0, kSent, kSent);
  }
  for (int base = 0; base < A; base += 32) {
    const int n = min(32, A - base);
    int cur_t = 0, cur_q = 0, cur_v = 0;
    if (lane < n) {
      cur_t = __ldg(t + off + base + lane);
      cur_q = __ldg(q + off + base + lane);
      cur_v = __ldg(valid + off + base + lane);
    }
    float out_f = kNeg;
    int out_d = 0;
    for (int s = 0; s < n; ++s) {
      const int i = base + s;
      const int ti = __shfl_sync(kFull, cur_t, s);
      const int qi = __shfl_sync(kFull, cur_q, s);
      const int vi = __shfl_sync(kFull, cur_v, s);
      const int r = i % B;               // anchor i's slot, the oldest's
      // this lane's best slot: highest score image, then smallest age rank
      int lk = INT_MIN, la = B, ld = 0;
      auto consider = [&](float f, int d, int st, int sq, int sl) {
        const int key = order_key(candidate(f, ti - st, qi - sq, c));
        const int age = sl >= r ? sl - r : sl - r + B;
        if (key > lk || (key == lk && age < la)) {
          lk = key;
          la = age;
          ld = d;
        }
      };
      if constexpr (SLOTS > 0) {
#pragma unroll
        for (int j = 0; j < SLOTS; ++j)
          if (j * 32 + lane < B) consider(bf[j], bd[j], bt[j], bq[j],
                                          j * 32 + lane);
      } else {
        for (int sl = lane; sl < B; sl += 32) {
          const int4 e = band[sl];
          consider(__int_as_float(e.x), e.y, e.z, e.w, sl);
        }
      }
      const int kmax = __reduce_max_sync(kFull, lk);
      const int kbest = static_cast<int>(__reduce_min_sync(
          kFull, lk == kmax ? static_cast<unsigned>(la)
                            : static_cast<unsigned>(B)));
      const int sbest = kbest + r >= B ? kbest + r - B : kbest + r;
      const int dbest = __shfl_sync(kFull, ld, sbest & 31);
      const float best = from_key(kmax);
      float fi = __fadd_rn(c.anchor_score, fmaxf(best, 0.0f));
      if (!vi) fi = kNeg;
      const int di = best > 0.0f ? dbest : ti - qi;
      if (lane == (r & 31)) {
        if constexpr (SLOTS > 0) {
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) {
            if (j == (r >> 5)) {
              bf[j] = fi;
              bd[j] = di;
              bt[j] = ti;
              bq[j] = qi;
            }
          }
        } else {
          band[r] = make_int4(__float_as_int(fi), di, ti, qi);
        }
      }
      if (lane == s) {
        out_f = fi;
        out_d = di;
      }
    }
    if (lane < n) {
      f_out[off + base + lane] = out_f;
      d_out[off + base + lane] = out_d;
    }
  }
}

}  // namespace

// q, t: (rows, A) int32; valid: (rows, A) bool (one byte each); f_out
// (rows, A) f32, d_out (rows, A) int32; all contiguous.  The band is fixed
// at 32 (the wrapper launches chain_dp_band_rows for any other chain_band).
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int chain_dp_rows(const int* q, const int* t,
                             const unsigned char* valid, float* f_out,
                             int* d_out, int rows, int A, int max_gap,
                             float gap_cost, float skip_cost,
                             float anchor_score, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const Costs c{max_gap, -gap_cost, -skip_cost, anchor_score};
  chain_dp_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      q, t, valid, f_out, d_out, rows, A, c);
  return static_cast<int>(cudaGetLastError());
}

// The same DP at band B = min(chain_band, A) >= 1 (any chain_band but 32):
// B <= 64 keeps the band in registers (1 or 2 slots a lane); a wider
// band needs `scratch`, (rows, B) int4 (16 bytes an entry), else it may be
// null.  Launches on `stream`; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue, without a launch, for B < 1 or a missing scratch).
extern "C" int chain_dp_band_rows(const int* q, const int* t,
                                  const unsigned char* valid, float* f_out,
                                  int* d_out, int rows, int A, int B,
                                  int max_gap, float gap_cost,
                                  float skip_cost, float anchor_score,
                                  void* scratch, void* stream) {
  const int slots = (B + 31) / 32;
  if (B < 1 || (slots > 2 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const Costs c{max_gap, -gap_cost, -skip_cost, anchor_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* band = static_cast<int4*>(scratch);
  if (slots == 1)
    chain_dp_band_kernel<1><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        q, t, valid, f_out, d_out, rows, A, B, c, band);
  else if (slots == 2)
    chain_dp_band_kernel<2><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        q, t, valid, f_out, d_out, rows, A, B, c, band);
  else
    chain_dp_band_kernel<0><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        q, t, valid, f_out, d_out, rows, A, B, c, band);
  return static_cast<int>(cudaGetLastError());
}
