// The whole MARS cheap phase for one read per CTA: integer t-stat event
// detection, Q-format quantization, seed hashing (+ minimizer winnowing),
// the two-gather query of the packed index, the frequency filter, the
// first-match exact count and the seed-and-vote filter.
//
// Replaces: src/repro/kernels/cheap_fused/cheap_fused.py::cheap_fused_fixed
// (the pl.pallas_call at :367, body _kernel at :162, index sweep
// _sweep_gather at :119).
//
// What bounds it on the H100: bytes, and in practice latency.  Per read it
// reads S int32 samples and, per seed, two bucket offsets and H packed
// two-word entry rows (random gathers, but the whole packed index of the
// largest dataset is ~33 MB and stays in the 50 MB L2), and writes E*H
// t_pos words, E*H keep flags and 9 counters.  The arithmetic is a few
// dozen integer operations per sample and per anchor slot.
//
// Design: one CTA of 512 threads per read; everything between the input
// samples and the outputs stays in shared memory (~47 KB at S=1024, E=192,
// H=16, 4096 vote bins).  The TPU kernel's workarounds are dropped: its
// one-hot f32 matmuls (segment sums, gathers, vote histogram) become integer
// shared-memory atomics, exact in any order, and its double-buffered DMA
// sweep of the whole index becomes direct loads of exactly the bucket
// offsets and entry rows each seed probes.  The sample-axis prefix sum of
// the boundary flags is a block-wide warp-shuffle scan.
//
// Exactness: the arithmetic follows the reference operation for operation.
// The boundary score is the IEEE division (float)lhs / ((float)rhs + 1);
// the event mean is (float)sum / max((float)cnt, 1) / 2^f; the requantized
// mean is rintf (round half to even, as jnp.round); every integer division
// is a FLOOR division (the reference's //), and left shifts of signed
// values are multiplications.  The library is built with -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFill = -3.0e38f;     // peak-pick border fill
constexpr int kDiagShift = 1 << 20;   // vote.DIAG_SHIFT
constexpr int kCounters = 9;          // COUNTER_COLS

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
    red = o;   o += 4 * 32;
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over the block, returned to every thread.  `red` holds 32 ints.
__device__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  __syncthreads();                       // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
  return tot;
}

// Inclusive prefix sum of v in thread order; *total gets the block sum.
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

__global__ void __launch_bounds__(kThreads)
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

  const int tid = threadIdx.x, NT = blockDim.x;
  const int S = p.S, E = p.E, H = p.H, EH = p.E * p.H;
  const size_t r = blockIdx.x;
  const unsigned mask = static_cast<unsigned>(p.n_buckets - 1);
  const int N = p.n_entries;

  // ---- stage the read's Q-format samples ---------------------------------
  for (int i = tid; i < S; i += NT) x[i] = xq[r * S + i];
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
  const int nev = min(carry + 1, E);
  __syncthreads();

  // ---- event means -> Q-format -> integer z-score -> symbols -------------
  const float fscale = static_cast<float>(1 << p.frac_bits);
  int part = 0;
  for (int e = tid; e < E; e += NT) {
    const float m = __fdiv_rn(
        __fdiv_rn(static_cast<float>(sums[e]),
                  fmaxf(static_cast<float>(cnts[e]), 1.0f)),
        fscale);
    const int q = static_cast<int>(rintf(__fmul_rn(m, fscale)));
    eqa[e] = q;
    if (e < nev) part += q;
  }
  const int n = max(nev, 1);
  const int mean = floordiv(block_sum(part, red), n);
  part = 0;
  for (int e = tid; e < E; e += NT) {
    const int d2 = (eqa[e] - mean) >> 1;
    if (e < nev) part += d2 * d2;
  }
  const int var = floordiv(block_sum(part, red), n) * 4;
  int sq = max(var, 1);
  for (int it = 0; it < 24; ++it) sq = floordiv(sq + floordiv(var, max(sq, 1)), 2);
  const int sd = max(sq, 1);
  for (int e = tid; e < E; e += NT) {
    const int d = eqa[e] - mean;
    int zq = floordiv(d * (1 << p.frac_bits), sd);
    zq = min(max(zq, -p.clip_q), p.clip_q - 1);
    int sym = floordiv(zq + p.clip_q, max(p.step_q, 1));
    syma[e] = min(max(sym, 0), p.levels - 1);
  }
  __syncthreads();

  // ---- seeds: circular w-symbol window -> mix32 (+ winnowing) ------------
  for (int e = tid; e < E; e += NT) {
    unsigned key = 0;
    for (int j = 0; j < p.seed_w; ++j) {
      int ej = e + j;
      if (ej >= E) ej -= E;
      key = (key << p.seed_q) | static_cast<unsigned>(syma[ej]);
    }
    keys[e] = mix32(key);
    sv0[e] = (e + p.seed_w <= nev) ? 1 : 0;
  }
  __syncthreads();
  for (int e = tid; e < E; e += NT) {
    unsigned char ok = sv0[e];
    if (p.minimizer_r > 0) {
      const unsigned big = 0xFFFFFFFFu;
      const unsigned kv = sv0[e] ? keys[e] : big;
      unsigned wmin = kv;
      for (int d = 1; d <= p.minimizer_r; ++d) {
        const unsigned lft = (e - d >= 0 && sv0[e - d]) ? keys[e - d] : big;
        const unsigned rgt = (e + d < E && sv0[e + d]) ? keys[e + d] : big;
        wmin = min(wmin, min(lft, rgt));
      }
      ok = ok && kv == wmin;
    }
    sv[e] = ok;
  }
  __syncthreads();

  // ---- query 1: bucket boundaries (two direct loads per seed) ------------
  int n_seeds = 0, probes = 0;
  for (int e = tid; e < E; e += NT) {
    const int bkt = static_cast<int>(keys[e] & mask);
    const int st = bs[bkt];
    const int cb = bs[bkt + 1] - st;
    starta[e] = st;
    cntb[e] = cb;
    fmi[e] = H;
    if (sv[e]) {
      ++n_seeds;
      probes += min(cb, H);
    }
  }
  if (p.use_vote)
    for (int k = tid; k < p.nbins; k += NT) hist[k] = 0;
  __syncthreads();

  // ---- query 2: H packed entry rows per seed, match, frequency filter,
  //      first match, votes -------------------------------------------------
  int raw = 0, post = 0, n_clip = 0;
  for (int s = tid; s < EH; s += NT) {
    const int e = s / H, h = s - e * H;
    const int idx = min(starta[e] + h, N - 1);
    const unsigned pu = static_cast<unsigned>(ent[idx]);
    const int tp = ent[static_cast<size_t>(N) + idx];
    const unsigned key = keys[e];
    const unsigned got = (pu & ~mask) | (key & mask);
    const int kc = static_cast<int>(pu & mask);
    const bool inb = h < cntb[e];
    const bool km = got == key;
    const bool rawh = inb && km && sv[e];
    const bool hv = p.use_freq ? (rawh && kc <= p.thresh_freq) : rawh;
    if (inb && km) atomicMin(&fmi[e], h);
    tposa[s] = tp;
    hit[s] = hv;
    raw += rawh;
    post += hv;
    if (p.use_vote && hv) {
      const int shifted = (tp - e) + kDiagShift;
      n_clip += shifted < 0;
      const int wid = max(shifted, 0) >> p.vlog2;
      atomicAdd(&hist[wid % p.nbins], 1);
      atomicAdd(&hist[(wid + 1) % p.nbins], 1);
    }
  }
  __syncthreads();

  // ---- exact count (first match per seed) and the vote keep test ---------
  int exact = 0;
  for (int e = tid; e < E; e += NT) {
    const int fh = fmi[e];
    if (fh < H && sv[e]) {
      const int idx = min(starta[e] + fh, N - 1);
      exact += static_cast<int>(static_cast<unsigned>(ent[idx]) & mask);
    }
  }
  int anchors = 0;
  for (int s = tid; s < EH; s += NT) {
    const bool hv = hit[s];
    const int tp = tposa[s];
    bool kp = hv;
    if (p.use_vote && hv) {
      const int e = s / H;
      const int wid = max((tp - e) + kDiagShift, 0) >> p.vlog2;
      const int v1 = hist[wid % p.nbins];
      const int v2 = hist[(wid + 1) % p.nbins];
      kp = max(v1, v2) >= p.thresh_vote;
    }
    t_pos_out[r * EH + s] = tp;
    keep_out[r * EH + s] = kp ? 1 : 0;
    anchors += kp;
  }

  // ---- per-read counters (COUNTER_COLS order) ----------------------------
  const int c_seeds = block_sum(n_seeds, red);
  const int c_probes = block_sum(probes, red);
  const int c_raw = block_sum(raw, red);
  const int c_post = block_sum(post, red);
  const int c_exact = block_sum(exact, red);
  const int c_anchors = block_sum(anchors, red);
  const int c_clip = block_sum(n_clip, red);
  if (tid == 0) {
    int* c = cnt_out + r * kCounters;
    c[0] = nev;
    c[1] = c_seeds;
    c[2] = c_probes;
    c[3] = c_raw;
    c[4] = c_post;
    c[5] = c_exact;
    c[6] = p.use_vote ? 2 * c_post : 0;
    c[7] = c_anchors;
    c[8] = p.use_vote ? c_clip : 0;
  }
}

}  // namespace

// xq: (R, S) int32 Q-format samples; bs: (n_buckets + 1,) int32; ent:
// (2, n_entries) int32; t_pos, keep: (R, E*H) int32; counters: (R, 9) int32;
// all contiguous.  Launches on `stream`; returns cudaGetLastError(), or the
// error of cudaFuncSetAttribute when one read needs more shared memory than
// a CTA may take.
extern "C" int cheap_fused_rows(const int* xq, const int* bs, const int* ent,
                                int* t_pos, int* keep, int* counters, int R,
                                CheapParams p, void* stream) {
  const size_t smem = Layout(p).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cheap_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  cheap_fused_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xq, bs, ent, t_pos, keep, counters, p);
  return static_cast<int>(cudaGetLastError());
}
