// The whole MARS cheap phase for one read per CTA: integer t-stat event
// detection, Q-format quantization, seed hashing (+ minimizer winnowing),
// the two-gather query of the packed index, the frequency filter, the
// first-match exact count and the seed-and-vote filter.
//
// Replaces: src/repro/kernels/cheap_fused/cheap_fused.py::cheap_fused_fixed
// (the pl.pallas_call at :367, body _kernel at :162, index sweep
// _sweep_gather at :119).
//
// What bounds it on the H100: the instructions it issues and the latency
// of its phases, not its bytes.  Per read it reads S int32 samples and,
// per seed, two bucket offsets and H packed two-word entry rows (random
// gathers, but the whole packed index of the largest dataset is ~33 MB and
// stays in the 50 MB L2), and writes E*H t_pos words, E*H keep flags and 9
// counters: 18.8 MB for a chunk of 512 reads, 5.6 us at the HBM rate.  A
// chunk is one wave, about four reads an SM, and those reads pass through
// the same phases together: the SM's issue rate bounds the wide phases,
// and the narrow ones (the Newton steps in one warp, the L2 round trips,
// the barriers) leave it waiting.
//
// Design: one CTA of 256 threads per read; everything between the input
// samples and the outputs stays in shared memory (~47 KB at S=1024, E=192,
// H=16, 4096 vote bins, so four CTAs an SM and 528 slots for a chunk's 512
// reads).  The TPU kernel's workarounds are dropped: its one-hot f32
// matmuls (segment sums, gathers, vote histogram) become integer
// shared-memory atomics, exact in any order, and its double-buffered DMA
// sweep of the whole index becomes direct loads of exactly the bucket
// offsets and entry rows each seed probes.  The detection half (boundary
// test, peaks, the block-wide scan into event ids, segment sums) is
// detect_fixed.cuh, shared with event_detect.cu: the shipped instance
// takes its register body (4 samples a thread, no shared sample or score
// array), the generic one its shared-memory body.  To cut the instruction
// count:
//  - the 24-step integer Newton square root runs in one warp, in unsigned
//    arithmetic, beside the mean and variance sums, and its result goes to
//    the block through shared memory (the parent ran it in all the
//    CTA's warps, in signed floor divisions); the steps end early once
//    the sequence reaches a fixed point or a two-cycle, whose value after
//    24 steps is then known (the event means of a read need 10-13);
//  - the shipped config (H = 16, 4096 vote bins, step 192, tw = 4,
//    peak_r = 3) has its own template instance, where / H, % vote_bins and
//    / step are shifts, masks and a multiply, and the window loops unroll;
//    every other config takes the generic instance of the same kernel;
//  - each thread issues its entry-row gathers kBatch slots at a time
//    before it uses any, so their L2 latencies overlap, and the exact
//    count's one reload per seed is in flight during the vote test;
//  - the seven counters are reduced together: one warp reduction each
//    (REDUX) and one barrier;
//  - 256 threads a read, not 512: the same work in half the warps needs
//    48 registers a thread, which four CTAs an SM still hold (at 512
//    threads, 48 registers admit three CTAs, two waves a chunk, and a cap
//    of 32 spills).
//
// Exactness: the arithmetic follows the reference operation for operation.
// The boundary score is the IEEE division (float)lhs / ((float)rhs + 1);
// the event mean is (float)sum / max((float)cnt, 1) / 2^f; the requantized
// mean is rintf (round half to even, as jnp.round); every integer division
// is a FLOOR division (the reference's //), and left shifts of signed
// values are multiplications.  Where both operands are non-negative (the
// Newton steps, the symbol step, / H, % vote_bins) the floor division is
// the unsigned one.  The variance is non-negative for the samples the
// wrapper's callers give (|xq| <= 8 * 2^f, so var < 2^25), and the Newton
// steps then never leave [0, 2^31).  The library is built with
// -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "detect_fixed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;         // CTAs an SM: a chunk is one wave
constexpr int kBatch = 3;             // entry-row gathers in flight a thread
constexpr int kDiagShift = 1 << 20;   // vote.DIAG_SHIFT
constexpr int kCounters = 9;          // COUNTER_COLS
constexpr int kSums = 7;              // counters reduced over the block

}  // namespace

// Mirrored by repro_torch.kernels.build.CheapParams (ctypes).
struct CheapParams {
  int S, E, H, tw, tau2, eps, peak_r, frac_bits;
  int seed_w, seed_q, minimizer_r, levels, clip_q, step_q;
  int n_buckets, n_entries, thresh_freq, use_freq, use_vote;
  int vlog2, nbins, thresh_vote;
};

namespace {

// Shared-memory carve-up, identical on host (sizing) and device.
struct Layout {
  size_t x, score, sums, cnts, eq, sym, keys, start, cntb, fmi, tpos, hist,
      red, above, sv0, sv, hit, bytes;
  __host__ __device__ explicit Layout(const CheapParams& p) {
    const size_t S = p.S, E = p.E, EH = static_cast<size_t>(p.E) * p.H;
    size_t o = 0;
    x = o;     o += 4 * S;
    score = o; o += 4 * S;
    sums = o;  o += 4 * E;
    cnts = o;  o += 4 * E;
    eq = o;    o += 4 * E;
    sym = o;   o += 4 * E;
    keys = o;  o += 4 * E;
    start = o; o += 4 * E;
    cntb = o;  o += 4 * E;
    fmi = o;   o += 4 * E;
    tpos = o;  o += 4 * EH;
    hist = o;  o += 4 * static_cast<size_t>(p.use_vote ? p.nbins : 0);
    red = o;   o += 4 * 32 * kSums;
    above = o; o += S;
    sv0 = o;   o += E;
    sv = o;    o += E;
    hit = o;   o += EH;
    bytes = (o + 15) & ~static_cast<size_t>(15);
  }
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// kH, kBins, kStepQ, kTw, kPeakR: the config's H, vote_bins, step_q,
// tstat_window and peak_window as constants, or 0 to read them from p.
template <int kH, int kBins, int kStepQ, int kTw, int kPeakR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cheap_fused_kernel(const int* __restrict__ xq, const int* __restrict__ bs,
                   const int* __restrict__ ent, int* __restrict__ t_pos_out,
                   int* __restrict__ keep_out, int* __restrict__ cnt_out,
                   CheapParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(p);
  int* x = reinterpret_cast<int*>(smem_raw + L.x);
  float* score = reinterpret_cast<float*>(smem_raw + L.score);
  int* sums = reinterpret_cast<int*>(smem_raw + L.sums);
  int* cnts = reinterpret_cast<int*>(smem_raw + L.cnts);
  int* eqa = reinterpret_cast<int*>(smem_raw + L.eq);
  int* syma = reinterpret_cast<int*>(smem_raw + L.sym);
  unsigned* keys = reinterpret_cast<unsigned*>(smem_raw + L.keys);
  int* starta = reinterpret_cast<int*>(smem_raw + L.start);
  int* cntb = reinterpret_cast<int*>(smem_raw + L.cntb);
  int* fmi = reinterpret_cast<int*>(smem_raw + L.fmi);
  int* tposa = reinterpret_cast<int*>(smem_raw + L.tpos);
  int* hist = reinterpret_cast<int*>(smem_raw + L.hist);
  int* red = reinterpret_cast<int*>(smem_raw + L.red);
  unsigned char* above = smem_raw + L.above;
  unsigned char* sv0 = smem_raw + L.sv0;
  unsigned char* sv = smem_raw + L.sv;
  unsigned char* hit = smem_raw + L.hit;

  const int tid = threadIdx.x, lane = tid & 31, NT = kThreads;
  const unsigned H = kH ? kH : p.H;
  const unsigned nbins = kBins ? kBins : p.nbins;
  const unsigned step_q = kStepQ ? kStepQ : max(p.step_q, 1);
  const int S = p.S, E = p.E, EH = p.E * static_cast<int>(H);
  const size_t r = blockIdx.x;
  const unsigned mask = static_cast<unsigned>(p.n_buckets - 1);
  const int N = p.n_entries;

  // ---- event detection: boundary test, peaks, event ids, segment sums --
  const DetectParams dp{p.S, p.E, p.tw, p.tau2, p.eps, p.peak_r};
  int nev;
  if constexpr (kTw != 0 && kPeakR != 0)
    nev = detect_fixed_regs<kThreads, 4, kTw, kPeakR>(    // edge: red[32..]
        xq + r * S, dp, reinterpret_cast<float*>(red + 32), sums, cnts, red);
  else
    nev = detect_fixed_block(xq + r * S, dp, x, score, above, sums, cnts,
                             red);

  // ---- event means -> Q-format -------------------------------------------
  const float fscale = static_cast<float>(1 << p.frac_bits);
  for (int e = tid; e < E; e += NT) {
    const float m = __fdiv_rn(
        __fdiv_rn(static_cast<float>(sums[e]),
                  fmaxf(static_cast<float>(cnts[e]), 1.0f)),
        fscale);
    eqa[e] = static_cast<int>(rintf(__fmul_rn(m, fscale)));
  }
  __syncthreads();

  // ---- one warp: mean, variance, 24 Newton steps of the integer sqrt ----
  if (tid < 32) {
    const int n = max(nev, 1);
    int part = 0;
    for (int e = lane; e < nev; e += 32) part += eqa[e];
    const int mean = floordiv(__reduce_add_sync(kFull, part), n);
    part = 0;
    for (int e = lane; e < nev; e += 32) {
      const int d2 = (eqa[e] - mean) >> 1;
      part += d2 * d2;
    }
    const unsigned var = static_cast<unsigned>(
        floordiv(__reduce_add_sync(kFull, part), n) * 4);
    // the steps stop once the rest is fixed: at a fixed point, or in a
    // two-cycle (var = k^2 - 1), where the parity of the steps left picks
    // the value after all 24
    unsigned sq = max(var, 1u), before = 0xffffffffu;
    for (int it = 0; it < 24; ++it) {
      const unsigned nxt = (sq + var / max(sq, 1u)) >> 1;
      if (nxt == sq) break;
      if (nxt == before) {
        if (!((23 - it) & 1)) sq = nxt;
        break;
      }
      before = sq;
      sq = nxt;
    }
    if (lane == 0) {
      red[0] = mean;
      red[1] = max(static_cast<int>(sq), 1);
    }
  }
  __syncthreads();

  // ---- integer z-score -> symbols ----------------------------------------
  {
    const int mean = red[0], sd = red[1];
    for (int e = tid; e < E; e += NT) {
      int zq = floordiv((eqa[e] - mean) * (1 << p.frac_bits), sd);
      zq = min(max(zq, -p.clip_q), p.clip_q - 1);
      // zq + clip_q >= 0, unless clip_q <= 0, where step_q is 1 and the
      // unsigned division gives back the signed value
      const int sym = static_cast<int>(
          static_cast<unsigned>(zq + p.clip_q) / step_q);
      syma[e] = min(max(sym, 0), p.levels - 1);
    }
  }
  __syncthreads();

  // ---- seeds: circular w-symbol window -> mix32; query 1: bucket bounds --
  for (int e = tid; e < E; e += NT) {
    unsigned key = 0;
    for (int j = 0; j < p.seed_w; ++j) {
      int ej = e + j;
      if (ej >= E) ej -= E;
      key = (key << p.seed_q) | static_cast<unsigned>(syma[ej]);
    }
    key = mix32(key);
    const int bkt = static_cast<int>(key & mask);
    const int st = bs[bkt];
    const int cb = bs[bkt + 1] - st;
    keys[e] = key;
    starta[e] = st;
    cntb[e] = cb;
    fmi[e] = H;
    sv0[e] = (e + p.seed_w <= nev) ? 1 : 0;
  }
  if (p.use_vote)
    for (int k = tid; k < static_cast<int>(nbins); k += NT) hist[k] = 0;
  __syncthreads();

  // ---- minimizer winnowing (off in the shipped configs) ------------------
  const unsigned char* seed_ok = sv0;
  if (p.minimizer_r > 0) {
    for (int e = tid; e < E; e += NT) {
      const unsigned big = 0xFFFFFFFFu;
      const unsigned kv = sv0[e] ? keys[e] : big;
      unsigned wmin = kv;
      for (int d = 1; d <= p.minimizer_r; ++d) {
        const unsigned lft = (e - d >= 0 && sv0[e - d]) ? keys[e - d] : big;
        const unsigned rgt = (e + d < E && sv0[e + d]) ? keys[e + d] : big;
        wmin = min(wmin, min(lft, rgt));
      }
      sv[e] = sv0[e] && kv == wmin;
    }
    seed_ok = sv;
    __syncthreads();
  }

  // ---- query 2: H packed entry rows per seed, match, frequency filter,
  //      first match, votes -------------------------------------------------
  int raw = 0, post = 0, n_clip = 0;
  for (int s0 = tid; s0 < EH; s0 += kBatch * NT) {
    int pw[kBatch], tpw[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int s = s0 + k * NT;
      if (s < EH) {
        const unsigned e = static_cast<unsigned>(s) / H;
        const int idx = min(starta[e] + (s - static_cast<int>(e * H)), N - 1);
        pw[k] = ent[idx];
        tpw[k] = ent[static_cast<size_t>(N) + idx];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int s = s0 + k * NT;
      if (s < EH) {
        const int e = static_cast<int>(static_cast<unsigned>(s) / H);
        const int h = s - e * static_cast<int>(H);
        const unsigned pu = static_cast<unsigned>(pw[k]);
        const int tp = tpw[k];
        const unsigned key = keys[e];
        const int kc = static_cast<int>(pu & mask);
        const bool inb = h < cntb[e];
        const bool km = ((pu ^ key) & ~mask) == 0;
        const bool rawh = inb && km && seed_ok[e];
        const bool hv = p.use_freq ? (rawh && kc <= p.thresh_freq) : rawh;
        if (inb && km) atomicMin(&fmi[e], h);
        tposa[s] = tp;
        hit[s] = hv;
        raw += rawh;
        post += hv;
        if (p.use_vote && hv) {
          const int shifted = (tp - e) + kDiagShift;
          n_clip += shifted < 0;
          const unsigned wid = static_cast<unsigned>(max(shifted, 0))
                               >> p.vlog2;
          atomicAdd(&hist[wid % nbins], 1);
          atomicAdd(&hist[(wid + 1) % nbins], 1);
        }
      }
    }
  }
  __syncthreads();

  // ---- seed counters and the exact count (first match per seed) ---------
  int n_seeds = 0, probes = 0, exact = 0;
  for (int e = tid; e < E; e += NT) {
    if (!seed_ok[e]) continue;
    ++n_seeds;
    probes += min(cntb[e], static_cast<int>(H));
    const int fh = fmi[e];
    if (e != tid && fh < static_cast<int>(H))      // only when E > NT
      exact += static_cast<int>(
          static_cast<unsigned>(ent[min(starta[e] + fh, N - 1)]) & mask);
  }
  // seed tid's first matching word: its reload is used after the vote test
  const bool mine = tid < E && seed_ok[tid] && fmi[tid] < static_cast<int>(H);
  const unsigned first_word =
      mine ? static_cast<unsigned>(ent[min(starta[tid] + fmi[tid], N - 1)])
           : 0u;

  // ---- the vote keep test; the output planes ------------------------------
  int anchors = 0;
  for (int s = tid; s < EH; s += NT) {
    const bool hv = hit[s];
    const int tp = tposa[s];
    bool kp = hv;
    if (p.use_vote && hv) {
      const int e = static_cast<int>(static_cast<unsigned>(s) / H);
      const unsigned wid = static_cast<unsigned>(
          max((tp - e) + kDiagShift, 0)) >> p.vlog2;
      const int v1 = hist[wid % nbins];
      const int v2 = hist[(wid + 1) % nbins];
      kp = max(v1, v2) >= p.thresh_vote;
    }
    t_pos_out[r * EH + s] = tp;
    keep_out[r * EH + s] = kp ? 1 : 0;
    anchors += kp;
  }
  exact += static_cast<int>(first_word & mask);

  // ---- per-read counters (COUNTER_COLS order): one barrier ---------------
  int v[kSums] = {n_seeds, probes, raw, post, exact, anchors, n_clip};
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const int t = __reduce_add_sync(kFull, v[j]);
    if (lane == 0) red[j * 32 + (tid >> 5)] = t;
  }
  __syncthreads();
  if (tid < kSums) {
    int t = 0;
    for (int w = 0; w < NT / 32; ++w) t += red[tid * 32 + w];
    // n_seeds, n_bucket_probes, n_hits_raw, n_hits_postfreq, n_hits_exact
    // to columns 1..5; n_anchors_postvote, n_votes_clipped to 7, 8
    int* c = cnt_out + r * kCounters;
    c[tid + (tid < 5 ? 1 : 2)] = (tid == 6 && !p.use_vote) ? 0 : t;
    if (tid == 3) c[6] = p.use_vote ? 2 * t : 0;     // n_votes_cast
    if (tid == 0) c[0] = nev;
  }
}

template <int kH, int kBins, int kStepQ, int kTw, int kPeakR>
int launch(const int* xq, const int* bs, const int* ent, int* t_pos,
           int* keep, int* counters, int R, const CheapParams& p,
           cudaStream_t stream) {
  auto* kernel = cheap_fused_kernel<kH, kBins, kStepQ, kTw, kPeakR>;
  const size_t smem = Layout(p).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  kernel<<<R, kThreads, smem, stream>>>(xq, bs, ent, t_pos, keep, counters,
                                        p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: (R, S) int32 Q-format samples; bs: (n_buckets + 1,) int32; ent:
// (2, n_entries) int32; t_pos, keep: (R, E*H) int32; counters: (R, 9) int32;
// all contiguous.  Launches on `stream` the shipped config's instance or the
// generic one; returns cudaGetLastError(), or the error of
// cudaFuncSetAttribute when one read needs more shared memory than a CTA
// may take.
extern "C" int cheap_fused_rows(const int* xq, const int* bs, const int* ent,
                                int* t_pos, int* keep, int* counters, int R,
                                CheapParams p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.H == 16 && p.nbins == 4096 && p.step_q == 192 && p.tw == 4 &&
      p.peak_r == 3)
    return launch<16, 4096, 192, 4, 3>(xq, bs, ent, t_pos, keep, counters,
                                       R, p, st);
  return launch<0, 0, 0, 0, 0>(xq, bs, ent, t_pos, keep, counters, R, p,
                               st);
}
