// Fixed-point event detection, one read per CTA: the integer (sqrt-free)
// t-statistic boundary test, peak pick, event ids and segment means of the
// early-quantized Q-format signal.
//
// Replaces: src/repro/kernels/event_detect/event_detect.py::
// event_detect_fixed (the pl.pallas_call at :124, body _kernel at :50).
//
// What bounds it on the H100: one read's latency path and the SM's issue
// rate, not its bytes.  Per read it reads S int32 samples and writes E f32
// means and one count (2.5 MB for a chunk of 512 reads of 1024 samples,
// 0.74 us at the HBM rate); the work is about 4*tw + 4*peak_r + 20 integer
// operations and one IEEE division a sample.  A chunk is one wave (four
// CTAs an SM), so the kernel takes about as long as an SM's four reads
// through their chain of load, boundary test, peak pick, block scan,
// atomics and epilogue, plus the launch.
//
// Design: the detection is the same code as the fused kernel's
// (detect_fixed.cuh), so the two agree bit for bit.  The shipped windows
// (tw = 4, peak_r = 3) have their own instance, chosen on the host:
// kThreads threads each hold kP contiguous samples in registers (three
// 16-byte loads: the run and its halos), slide their window sums along the
// run and take the peak test's neighbours by shuffles, so a read passes
// three barriers and no shared sample or score array.  256 threads x 4
// samples gave a shorter path than 128 x 8 (more warps to cover the
// latencies).  The generic instance, for any other windows, stages the
// read in shared memory.  The TPU kernel's Hillis-Steele shifted-add scan
// becomes a warp-shuffle scan plus two warp reductions (REDUX) over the
// warp totals, and its one-hot MXU matmul of the segment sums becomes
// shared-memory integer atomics (exact in any order: |x| < 2^12 and
// S * 2^12 < 2^24 keep every sum exact in f32 too).  The means are
// (float)sum / max((float)cnt, 1) / 2^frac: the first an IEEE division, the
// second exact scaling by a power of two, done as a product with 2^-frac
// (the same bits: no mean is subnormal).
#include <cuda_runtime.h>

#include "detect_fixed.cuh"

namespace {

constexpr int kThreads = 256;         // the shipped instance: 256 x 4
constexpr int kP = 4;
constexpr int kGenericThreads = 256;

// kTw, kPeakR: the shipped windows, or 0 for the generic instance.
template <int kTw, int kPeakR>
__global__ void __launch_bounds__(kTw ? kThreads : kGenericThreads)
event_detect_kernel(const int* __restrict__ xq, float* __restrict__ means,
                    int* __restrict__ n_events, DetectParams p,
                    int frac_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = p.S, E = p.E;
  const size_t r = blockIdx.x;
  int nev;
  int *sums, *cnts;
  if constexpr (kTw != 0) {
    sums = reinterpret_cast<int*>(smem_raw);
    cnts = sums + E;
    int* red = cnts + E;
    float* edge = reinterpret_cast<float*>(red + 32);
    nev = detect_fixed_regs<kThreads, kP, kTw, kPeakR>(xq + r * S, p, edge,
                                                       sums, cnts, red);
  } else {
    int* x = reinterpret_cast<int*>(smem_raw);
    float* score = reinterpret_cast<float*>(x + S);
    sums = reinterpret_cast<int*>(score + S);
    cnts = sums + E;
    int* red = cnts + E;
    unsigned char* above = reinterpret_cast<unsigned char*>(red + 32);
    nev = detect_fixed_block(xq + r * S, p, x, score, above, sums, cnts,
                             red);
  }
  // / 2^frac is exact scaling (no mean is subnormal), so the product with
  // the exact inverse gives the division's bits
  const float inv_scale = 1.0f / static_cast<float>(1 << frac_bits);
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    means[r * E + e] = __fmul_rn(
        __fdiv_rn(static_cast<float>(sums[e]),
                  fmaxf(static_cast<float>(cnts[e]), 1.0f)),
        inv_scale);
  if (threadIdx.x == 0) n_events[r] = nev;
}

template <int kTw, int kPeakR>
int launch(const int* xq, float* means, int* n_events, int R,
           const DetectParams& p, int frac_bits, cudaStream_t stream) {
  auto* kernel = event_detect_kernel<kTw, kPeakR>;
  const int threads = kTw ? kThreads : kGenericThreads;
  // sums, cnts, red; then the shipped instance's warp-edge scores, or the
  // generic one's x, score and above
  const size_t smem = 4 * static_cast<size_t>(2 * p.E + 32) +
      (kTw ? 4 * 2 * kPeakR * (kThreads / 32)
           : 4 * 2 * static_cast<size_t>(p.S) + p.S);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  kernel<<<R, threads, smem, stream>>>(xq, means, n_events, p, frac_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: (R, S) int32 Q-format samples; means: (R, E) f32; n_events: (R,)
// int32; all contiguous.  Launches on `stream` the shipped windows'
// instance or the generic one; returns cudaGetLastError(), or the error of
// cudaFuncSetAttribute when one read needs more shared memory than a CTA
// may take.
extern "C" int event_detect_rows(const int* xq, float* means, int* n_events,
                                 int R, int S, int E, int tw, int tau2,
                                 int eps, int peak_r, int frac_bits,
                                 void* stream) {
  const DetectParams p{S, E, tw, tau2, eps, peak_r};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tw == 4 && peak_r == 3)
    return launch<4, 3>(xq, means, n_events, R, p, frac_bits, st);
  return launch<0, 0>(xq, means, n_events, R, p, frac_bits, st);
}
