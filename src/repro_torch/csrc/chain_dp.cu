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
// Any band B >= 1 (chain_band != 32): chain_dp_band_kernel<KR, kFar, kWide>.
//
// The shipped kernel's split at any band.  One warp per read.  R0 is the
// shipped kernel's register set: lane l holds the newest anchor j with
// j % 32 == l, written in place at step j.  R1..R_KR hold what R0 held 1..KR
// blocks of 32 anchors back: at each block's end R_k <- R_{k-1}, R1 <- R0
// (three moves a set every 32 steps; nothing is indexed by a runtime B).
// In a lane R0 has not overwritten yet in this block, R1 repeats R0's
// slot at the same distance back, which is harmless.  At step i = base + s,
// set k > 0 holds anchor i - (32k - y) in lane l (y = l - s), R0 anchor
// i - (x0 + 1) (x0 = ~y & 31): a slot's distance back is an immediate less
// y, and the slot is in the band when that is at most B - 1, one compare
// (yb = y + B - 1 >= 32k), needed on the last two sets alone
// (B >= 32 KR - 30 puts R1..R_{KR-2} wholly inside) and on R0.  A band
// takes KR = ceil((B - 1) / 32) sets, none up to B = 33.
//
// Step i's chain is chain_dp_kernel's: the newest anchor's candidate
// merged by a strict > into the older slots' best, which step i - 1
// reduced beside its own chain.  Each lane scans its slots in reach, oldest
// set first, keeping the first best key and its distance back; one
// __reduce_max_sync takes the best key, a second the farthest distance
// among the lanes reaching it (the reference's oldest-first rule).  The
// winner's diag0 comes from a ring in shared memory holding every recent
// anchor's diag0 (d_ring(KR) entries a warp, each written by all lanes
// alike), so no set carries diag0; with R0 alone, the winner's lane
// shuffles it, as in the shipped kernel.
//
// A slot costs about 15 instructions, chosen for the pipes: the H100's
// integer ALU accepts a warp instruction every other cycle, the FMA pipe
// every cycle.  In reach is dt - 1 and dq - 1 below max_gap as unsigned
// (two ISETP); gap and skip come from the floats whose bits are
// 2^23 + dt - 1 and 2^23 + dq - 1 (VIADD, then FADD, and FMNMX + FADD),
// exact below 2^23, in place of two quarter-rate I2F; f is kept as -inf
// where it is <= NEG/2, so no slot tests it; the slot is taken under the
// reach predicate (ISETP, two SEL), with no select of NEG.  The key is the
// candidate's bits: positive floats order as their bits do, and only a
// positive best counts (fi = anchor_score + max(best, 0); diag0 is taken
// only when best > 0), so NEG, -inf and slots out of reach need no order
// among themselves.  max_gap >= 2^23 takes the instance that converts with
// I2F (kWide: KR = 16, every set tested against the band).
//
// Past B = 513 the sets beyond R16 (kFar) are read back each step from
// where the lane itself wrote them: set k > 16 holds anchor
// base + lane - 32 k, whose f and diag0 this lane stored to the outputs
// k blocks ago and whose t and q are inputs.  Neither a scratch row nor a
// band cap: any B up to A runs.  Measured while this design was chosen
// (PERF.md): at B = 64, 96, 128, 300 and 512 every split of the sets
// between registers and a shared-memory ring was slower than all
// registers, so every band up to 513 keeps its sets in registers.
//
// Resources (ptxas, sm_90a; scripts/bench_chain_band.py): no instance
// spills or keeps a stack; 48 registers at KR = 0, 70 at 2, 80 at 4, 90
// at 10, 109 at 16.  The anchor loop's SASS: 75.5 instructions a step at
// KR = 0, 112 at 2, 147 at 4, 226 at 10, 314 at 16, 14.7 a set; 3
// shuffles and 2 REDUX a step, and no I2F but the chain's two.
//
// What bounds it: as the shipped kernel, one warp's instruction stream on
// each scheduler.  On 512 x 512 anchors B <= 33 takes 0.0365 ms, under
// the shipped kernel's 0.0395; B = 300 takes 0.0835 ms, 323 cycles a step
// at 1980 MHz for 226 instructions, where the chain's 35 cycles a step
// alone would take 0.0091 ms (PERF.md).
constexpr int kMaxRegSets = 16;          // sets R1..R16 beside R0
constexpr int kWideGap = 1 << 23;        // the magic conversion's range
constexpr float kMagic = 8388608.0f;     // 2^23, bits 0x4B000000

// entries of the warp's diag0 ring: a power of two covering R0..R_KR
__host__ __device__ constexpr int d_ring(int kr) {
  int n = 32;
  while (n < 32 * (kr + 1)) n *= 2;
  return n;
}

// the int32 difference a - b, wrapping as the reference's int32 does
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// one block an SM is all a launch of 512 reads needs: ptxas then schedules
// for registers, not occupancy
template <int KR, bool kFar, bool kWide>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
    chain_dp_band_kernel(const int* __restrict__ q, const int* __restrict__ t,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ f_out, int* __restrict__ d_out,
                         int rows, int A, int B, int H, Costs c) {
  constexpr int kD = d_ring(KR);
  __shared__ int band_smem[kWarpsPerBlock * kD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;               // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * A;
  const unsigned mg = c.max_gap > 0 ? static_cast<unsigned>(c.max_gap) : 0u;
  const float inf = __int_as_float(0x7f800000);
  // diag0 of anchor a at dring[a % kD], written by every lane alike
  int* dring = band_smem + warp * kD;
  // R0 (f0, t0, q0) and R1..R_KR (rf, rt, rq; index 0 unused): f is -inf
  // where the anchor's f <= NEG/2, so a slot needs no test of it.  Sets
  // R_{KR+1}..R_{KR+H} are read back from the outputs and inputs.
  float f0 = -inf, rf[KR + 1];
  int t0 = kSent, q0 = kSent, rt[KR + 1], rq[KR + 1];
#pragma unroll
  for (int k = 1; k <= KR; ++k) {
    rf[k] = -inf;
    rt[k] = kSent;
    rq[k] = kSent;
  }
  int cur_t = 0, cur_q = 0, cur_v = 0;
  if (lane < A) {
    cur_t = __ldg(t + off + lane);
    cur_q = __ldg(q + off + lane);
    cur_v = __ldg(valid + off + lane);
  }
  // as chain_dp_kernel: the newest anchor's entry, the older slots' best
  // (0, not NEG, when none is positive: only a positive best counts), and
  // the coordinates of anchors i and i+1
  float new_f = kNeg, older_f = 0.0f;
  int new_d = 0, new_t = kSent, new_q = kSent, older_d = 0;
  int t_i = __shfl_sync(kFull, cur_t, 0), q_i = __shfl_sync(kFull, cur_q, 0),
      v_i = __shfl_sync(kFull, cur_v, 0);
  int t_n = __shfl_sync(kFull, cur_t, 1), q_n = __shfl_sync(kFull, cur_q, 1),
      v_n = __shfl_sync(kFull, cur_v, 1);
  float out_f = kNeg;
  int out_d = 0;
  for (int base = 0; base < A; base += 32) {
    const int n = min(32, A - base);
    int nxt_t = 0, nxt_q = 0, nxt_v = 0;
    if (base + 32 + lane < A) {
      nxt_t = __ldg(t + off + base + 32 + lane);
      nxt_q = __ldg(q + off + base + 32 + lane);
      nxt_v = __ldg(valid + off + base + 32 + lane);
    }
#pragma unroll (KR <= 4 ? 4 : 2)
    for (int s = 0; s < n; ++s) {
      // Off the chain: the older slots of step i + 1 (i = base + s), those
      // 1 .. B-1 anchors back from i, before anchor i lands in R0.  Set
      // k > 0 holds anchor i - (32k - y) in this lane (y = lane - s), R0
      // anchor i - (x0 + 1), x0 = ~y & 31.  Each lane keeps the first best
      // key among its in-band slots, oldest set first, with its distance
      // back (as lb - y); the warp takes the best key and the farthest
      // slot reaching it, whose diag0 the ring holds.
      const int fetch = s + 2;                  // anchor i+2, for step i+1
      const bool here = fetch < 32;
      const int tf = __shfl_sync(kFull, here ? cur_t : nxt_t, fetch & 31);
      const int qf = __shfl_sync(kFull, here ? cur_q : nxt_q, fetch & 31);
      const int vf = __shfl_sync(kFull, here ? cur_v : nxt_v, fetch & 31);
      const int y = lane - s;
      const int yb = y + B - 1;                 // in band: 32k - y <= B - 1
      const int tn1 = wrap_sub(t_n, 1), qn1 = wrap_sub(q_n, 1);
      int lk = INT_MIN, lb = 0, ld = 0;
      // a slot at (dt, dq) = (t_n - st, q_n - sq): ok is dt, dq in
      // [1, max_gap]; gap and skip are exact, as the reference's I2F.
      // The lane keeps its first best key among its slots in reach, oldest
      // set first, the slot's distance back (as b - y) and, for a set read
      // back or for R0 alone, its diag0
      auto consider = [&](float f, int st, int sq, bool in_band, int b,
                          bool keep_d, int d) {
        const int dt1 = wrap_sub(tn1, st), dq1 = wrap_sub(qn1, sq);
        const bool ok = static_cast<unsigned>(dt1) < mg &&
                        static_cast<unsigned>(dq1) < mg && in_band;
        float gap, skip;
        if constexpr (kWide) {
          gap = __int2float_rn(abs(wrap_sub(dt1, dq1)));
          skip = __int2float_rn(min(dt1, dq1) + 1);
        } else {
          // 2^23 + dt - 1 and 2^23 + dq - 1, exact below 2^23
          const float mt =
              __uint_as_float(0x4B000000u + static_cast<unsigned>(dt1));
          const float mq =
              __uint_as_float(0x4B000000u + static_cast<unsigned>(dq1));
          gap = fabsf(__fsub_rn(mt, mq));
          skip = __fsub_rn(fminf(mt, mq), kMagic - 1.0f);
        }
        const int key = __float_as_int(__fmaf_rn(
            c.neg_skip_cost, skip, __fmaf_rn(c.neg_gap_cost, gap, f)));
        if (ok && key > lk) {
          lk = key;
          lb = b;
          if (keep_d) ld = d;
        }
      };
      if constexpr (kFar) {
        // set k holds anchor base + lane - 32 k: this lane wrote its f and
        // diag0 k blocks ago (plain loads, not __ldg: this kernel writes
        // them); before anchor 0, a sentinel
        for (int k32 = 32 * (KR + H); k32 > 32 * KR; k32 -= 32) {
          const int a = base + lane - k32;
          float f = -inf;
          int d = 0, st = kSent, sq = kSent;
          if (a >= 0) {
            const float fa = f_out[off + a];
            f = fa > kNeg * 0.5f ? fa : -inf;
            d = d_out[off + a];
            st = __ldg(t + off + a);
            sq = __ldg(q + off + a);
          }
          consider(f, st, sq, yb >= k32, k32, true, d);
        }
      }
      // R1..R_{KR-2} lie wholly in the band (B > 32 KR - 30 where
      // KR <= ceil((B - 1) / 32)); the wide instance tests every set
#pragma unroll
      for (int k = KR; k >= 1; --k)
        consider(rf[k], rt[k], rq[k],
                 (kWide || k >= KR - 1) ? yb >= 32 * k : true, 32 * k, false,
                 0);
      const int x0 = ~y & 31;
      consider(f0, t0, q0, x0 < B - 1, x0 + 1 + y, KR == 0, out_d);
      // Positive floats order as their bits do; a best that is not
      // positive extends no chain, whatever its value
      const int kmax = __reduce_max_sync(kFull, lk);
      const unsigned bmax = __reduce_max_sync(
          kFull, lk == kmax ? static_cast<unsigned>(lb - y) : 0u);
      const float next_f = kmax > 0 ? __int_as_float(kmax) : 0.0f;
      // the winner's diag0: from its lane (R0 alone, or a set read back),
      // else from the diag0 ring
      int next_d = 0;
      if constexpr (KR > 0)
        next_d = dring[(base + s - static_cast<int>(bmax)) & (kD - 1)];
      if constexpr (KR == 0 || kFar) {
        const int lane_d = __shfl_sync(kFull, ld, (s - static_cast<int>(bmax))
                                                     & 31);
        if (KR == 0 || bmax > 32u * KR + 31u) next_d = lane_d;
      }
      // On the chain, step i: as chain_dp_kernel
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
      if constexpr (KR > 0) dring[(base + s) & (kD - 1)] = di;
      if (lane == s) {
        f0 = fi > kNeg * 0.5f ? fi : -inf;
        t0 = t_i;
        q0 = q_i;
        out_f = fi;
        out_d = di;
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
      f_out[off + base + lane] = out_f;
      d_out[off + base + lane] = out_d;
    }
    // the block's end: R_k <- R_{k-1}
#pragma unroll
    for (int k = KR; k >= 2; --k) {
      rf[k] = rf[k - 1];
      rt[k] = rt[k - 1];
      rq[k] = rq[k - 1];
    }
    if constexpr (KR >= 1) {
      rf[1] = f0;
      rt[1] = t0;
      rq[1] = q0;
    }
    cur_t = nxt_t;
    cur_q = nxt_q;
    cur_v = nxt_v;
  }
}

template <int KR, bool kFar, bool kWide>
int launch_band(const int* q, const int* t, const unsigned char* valid,
                float* f_out, int* d_out, int rows, int A, int B, int H,
                const Costs& c, cudaStream_t stream) {
  chain_dp_band_kernel<KR, kFar, kWide>
      <<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, 0,
         stream>>>(q, t, valid, f_out, d_out, rows, A, B, H, c);
  return static_cast<int>(cudaGetLastError());
}

// the instance with R1..R_kr in registers and no set read back
template <int KR>
int dispatch_band(int kr, const int* q, const int* t,
                  const unsigned char* valid, float* f_out, int* d_out,
                  int rows, int A, int B, const Costs& c,
                  cudaStream_t stream) {
  if (kr == KR)
    return launch_band<KR, false, false>(q, t, valid, f_out, d_out, rows, A,
                                         B, 0, c, stream);
  if constexpr (KR < kMaxRegSets) {
    return dispatch_band<KR + 1>(kr, q, t, valid, f_out, d_out, rows, A, B,
                                 c, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
// R0 and ceil((B - 1) / 32) register sets up to B = 513, the sets past R16
// read back from the outputs beyond that.  max_gap >= 2^23 takes the I2F
// instance, which tests every set against the band.  Launches on `stream`;
// returns cudaGetLastError() of the launch (cudaErrorInvalidValue, without
// a launch, for B < 1).
extern "C" int chain_dp_band_rows(const int* q, const int* t,
                                  const unsigned char* valid, float* f_out,
                                  int* d_out, int rows, int A, int B,
                                  int max_gap, float gap_cost,
                                  float skip_cost, float anchor_score,
                                  void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sets = B <= 33 ? 0 : (B - 2) / 32 + 1;    // ceil((B - 1) / 32)
  const int far = max(sets - kMaxRegSets, 0);
  const Costs c{max_gap, -gap_cost, -skip_cost, anchor_score};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_gap >= kWideGap)
    return launch_band<kMaxRegSets, true, true>(q, t, valid, f_out, d_out,
                                                rows, A, B, far, c, s);
  if (far > 0)
    return launch_band<kMaxRegSets, true, false>(q, t, valid, f_out, d_out,
                                                 rows, A, B, far, c, s);
  return dispatch_band<0>(sets, q, t, valid, f_out, d_out, rows, A, B, c, s);
}
