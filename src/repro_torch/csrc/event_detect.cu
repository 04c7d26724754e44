// Fixed-point event detection, one read per CTA: the integer (sqrt-free)
// t-statistic boundary test, peak pick, event ids and segment means of the
// early-quantized Q-format signal.
//
// Replaces: src/repro/kernels/event_detect/event_detect.py::
// event_detect_fixed (the pl.pallas_call at :124, body _kernel at :50).
//
// What bounds it on the H100: bytes, and in practice latency.  Per read it
// reads S int32 samples and writes E f32 means and one count; the work is
// about 4*tw + 4*peak_r + 20 integer operations per sample.
//
// Design: the detection is the same code as the fused kernel's
// (detect_fixed.cuh), so the two agree bit for bit.  The TPU kernel's
// Hillis-Steele shifted-add scan becomes a warp-shuffle block scan, and
// its one-hot MXU matmul of the segment sums becomes shared-memory integer
// atomics (exact in any order: |x| < 2^12 and S * 2^12 < 2^24 keep every
// sum exact in f32 too).  The means are (float)sum / max((float)cnt, 1) /
// 2^frac: two separately rounded IEEE divisions, in that order.
#include <cuda_runtime.h>

#include "detect_fixed.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
event_detect_kernel(const int* __restrict__ xq, float* __restrict__ means,
                    int* __restrict__ n_events, DetectParams p,
                    int frac_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = p.S, E = p.E;
  int* x = reinterpret_cast<int*>(smem_raw);
  float* score = reinterpret_cast<float*>(x + S);
  int* sums = reinterpret_cast<int*>(score + S);
  int* cnts = sums + E;
  int* red = cnts + E;
  unsigned char* above = reinterpret_cast<unsigned char*>(red + 32);
  const size_t r = blockIdx.x;

  const int nev = detect_fixed_block(xq + r * S, p, x, score, above, sums,
                                     cnts, red);
  const float fscale = static_cast<float>(1 << frac_bits);
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    means[r * E + e] = __fdiv_rn(
        __fdiv_rn(static_cast<float>(sums[e]),
                  fmaxf(static_cast<float>(cnts[e]), 1.0f)),
        fscale);
  if (threadIdx.x == 0) n_events[r] = nev;
}

size_t smem_bytes(int S, int E) {
  return 4 * static_cast<size_t>(2 * S + 2 * E + 32) + S;
}

}  // namespace

// xq: (R, S) int32 Q-format samples; means: (R, E) f32; n_events: (R,)
// int32; all contiguous.  Launches on `stream`; returns cudaGetLastError(),
// or the error of cudaFuncSetAttribute when one read needs more shared
// memory than a CTA may take.
extern "C" int event_detect_rows(const int* xq, float* means, int* n_events,
                                 int R, int S, int E, int tw, int tau2,
                                 int eps, int peak_r, int frac_bits,
                                 void* stream) {
  const size_t smem = smem_bytes(S, E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        event_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch to report
      return static_cast<int>(err);
    }
  }
  const DetectParams p{S, E, tw, tau2, eps, peak_r};
  event_detect_kernel<<<R, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xq, means, n_events, p, frac_bits);
  return static_cast<int>(cudaGetLastError());
}
