// Row-wise ascending sort of int32 keys: a bitonic compare-exchange network
// whose stages run in registers, warp shuffles, and (for the widest strides
// only) shared memory.
//
// Replaces: src/repro/kernels/bitonic_sort/bitonic_sort.py::bitonic_sort
// (the pl.pallas_call at :64, body _kernel at :39).
//
// The network.  A row is padded with INT32_MAX to Lp = max(128,
// next_pow2(L)) lanes (in registers: pad lanes are never loaded).  Merge k
// (k = 2, 4, ..., Lp) opens with a "flip" stage, lane i against lane
// i ^ (k - 1), and goes on with strides j = k/4, ..., 1, lane i against
// i ^ j; in every stage the lower lane keeps the minimum.  All
// compare-exchanges are ascending, so no lane carries a direction.
//
// Layout and the stage split.  Thread t of a row holds the run of 8
// consecutive lanes 8t .. 8t+7 in registers (Lp / 8 threads a row; rows of
// Lp <= 256 share a 64-thread CTA, 64 / (Lp / 8) rows each).  Lane
// i = 8t + e meets its partner at stride j as follows:
//   - j < 8: inside the thread (element e ^ j), no shuffle, no barrier;
//   - 8 <= j < 256: thread t ^ (j / 8) of the same warp, by
//     __shfl_xor_sync (a flip stage reads the partner's element 7 - e);
//   - j >= 256: another warp.  Each thread stores its 8 keys to shared
//     memory as two int4, one __syncthreads, then loads its partner's 8.
//     Two buffers alternate, so one barrier a round suffices: a thread
//     stores into a buffer only after the next round's barrier, which every
//     reader of that buffer has passed.  Thread t's two int4 sit at slots
//     2t and 2t + 1, swapped when bit 2 of t is set: the 8 threads of one
//     128-bit access phase then touch 8 distinct 16-byte bank groups, on
//     the store and on the partner's load (the partner shares t's low five
//     bits, or has them all flipped), so every round is free of bank
//     conflicts.
// For Lp = 4096 that is 78 stages: 33 in registers, 35 by shuffle and 10
// through shared memory (the other 68 need no barrier); Lp = 8192 adds
// 13 stages, 15 of the 91 through shared memory.
//
// Loads and stores: each row is read once and written once, as int4 where
// L is a multiple of 4 and both pointers are 16-byte aligned, key by key
// otherwise (the tail past L is never touched).
//
// What bounds it on the H100: the shuffles and the integer min/max of the
// compare-exchanges, not bytes.  At 512 x 3072 the batch moves 12.6 MB
// (0.0038 ms over 3.35 TB/s), while each of 262,144 threads issues 280
// shuffles and about 1,000 integer min/max (the SASS of the 4096 instance,
// counted by chip_smoke.py's build phase: 280 SHFL, 984 IMNMX, 10 BAR a
// thread).  One CTA of 512 threads and 32 KiB of shared memory per row of
// 4096 lanes; the launch bounds ask for four such CTAs per SM (2,048
// threads, so at most 32 registers a thread), which puts all 512 rows of a
// chunk in flight at once.
//
// ptxas (sm_90a): 32 registers or fewer in every instance; the 4096 and
// 8192 instances spill 8 and 4 bytes of the row's address, stored once
// before the network and loaded once after it, none inside it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRun = 8;                // keys a thread holds in registers
constexpr int kPad = 0x7FFFFFFF;       // INT32_MAX, the reference's pad
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallCta = 64;          // threads of a CTA of short rows
constexpr int kWarpStride = 32 * kRun; // the smallest stride across warps

__device__ __forceinline__ void cx(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// the compare-exchanges inside the thread: stride J < 8 (FLIP: merge
// 2 * J's opening stage, element e against e ^ (2 * J - 1))
template <int J, bool FLIP>
__device__ __forceinline__ void local_stage(int (&x)[kRun]) {
#pragma unroll
  for (int e = 0; e < kRun; ++e)
    if ((e & J) == 0) cx(x[e], x[FLIP ? (e ^ (2 * J - 1)) : (e + J)]);
}

// this thread's run against the partner's run y (already reversed for a
// flip stage): the lower thread keeps the minima
__device__ __forceinline__ void merge_runs(int (&x)[kRun],
                                           const int (&y)[kRun], bool lower) {
#pragma unroll
  for (int e = 0; e < kRun; ++e)
    x[e] = lower ? min(x[e], y[e]) : max(x[e], y[e]);
}

// a stage against thread t ^ m of the same warp (m < 32)
__device__ __forceinline__ void shfl_stage(int (&x)[kRun], int m, bool flip,
                                           bool lower) {
  int y[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e)
    y[e] = __shfl_xor_sync(kFull, flip ? x[kRun - 1 - e] : x[e], m);
  merge_runs(x, y, lower);
}

// a stage against thread p of another warp, through shared-memory buffer
// `buf` (2 * threads int4, swizzled as the header says)
__device__ __forceinline__ void smem_stage(int (&x)[kRun], int4* buf, int t,
                                           int p, bool flip, bool lower) {
  const int st = (t >> 2) & 1;
  buf[2 * t + st] = make_int4(x[0], x[1], x[2], x[3]);
  buf[2 * t + (st ^ 1)] = make_int4(x[4], x[5], x[6], x[7]);
  __syncthreads();
  const int sp = (p >> 2) & 1;
  const int4 a = buf[2 * p + sp];
  const int4 b = buf[2 * p + (sp ^ 1)];
  const int z[kRun] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int y[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) y[e] = z[flip ? kRun - 1 - e : e];
  merge_runs(x, y, lower);
}

constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

template <int LP>
struct Shape {
  static constexpr int kLog = log2i(LP);
  static constexpr int kThreadsPerRow = LP / kRun;
  static constexpr int kRowsPerCta =
      kThreadsPerRow >= kSmallCta ? 1 : kSmallCta / kThreadsPerRow;
  static constexpr int kThreads = kThreadsPerRow * kRowsPerCta;
  // rows of 512 lanes or more: 2048 threads per SM (four CTAs at 4096)
  static constexpr int kMinCtas = LP >= 2 * kWarpStride ? 2048 / kThreads : 1;
  static constexpr bool kShared = LP > kWarpStride;
  static constexpr int kSmemBytes = kShared ? 2 * LP * 4 : 0;
};

template <int LP>
__global__ void __launch_bounds__(Shape<LP>::kThreads, Shape<LP>::kMinCtas)
    bitonic_sort_kernel(const int* __restrict__ in, int* __restrict__ out,
                        int rows, int L, bool vec) {
  using S = Shape<LP>;
  extern __shared__ int4 smem[];
  const int t = threadIdx.x % S::kThreadsPerRow;
  const int base = kRun * t;
  int x[kRun];
  // a thread past the last row still joins every shuffle and barrier
  const int row =
      blockIdx.x * S::kRowsPerCta + threadIdx.x / S::kThreadsPerRow;
  const bool live = row < rows;
  const size_t first = static_cast<size_t>(row) * L + base;  // key 8t
  if (live && vec) {
    const int4* src = reinterpret_cast<const int4*>(in + first);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // L % 4 == 0: an int4 lies wholly inside the row or wholly past it
      const int4 v = base + 4 * h < L ? __ldg(src + h)
                                      : make_int4(kPad, kPad, kPad, kPad);
      x[4 * h] = v.x; x[4 * h + 1] = v.y; x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRun; ++e)
      x[e] = live && base + e < L ? __ldg(in + first + e) : kPad;
  }

  // merges 2, 4 and 8: each run of 8 sorts itself
  local_stage<1, true>(x);
  local_stage<2, true>(x);
  local_stage<1, false>(x);
  local_stage<4, true>(x);
  local_stage<2, false>(x);
  local_stage<1, false>(x);
  // merges 16 .. Lp: the strides of 8 and more cross threads
  int round = 0;
#pragma unroll
  for (int lk = 4; lk <= S::kLog; ++lk) {
    const int k = 1 << lk;
    const int mf = k / kRun - 1;           // the flip stage's partner mask
    const bool lower_f = (t & (k >> 4)) == 0;
    if (k <= kWarpStride) {
      shfl_stage(x, mf, true, lower_f);
    } else {
      smem_stage(x, smem + (round & 1) * (LP / 4), t, t ^ mf, true, lower_f);
      ++round;
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 3; --lj) {
      const int m = 1 << (lj - 3);         // stride j = 8 m
      const bool lower = (t & m) == 0;
      if (m < 32) {
        shfl_stage(x, m, false, lower);
      } else {
        smem_stage(x, smem + (round & 1) * (LP / 4), t, t ^ m, false,
                   lower);
        ++round;
      }
    }
    local_stage<4, false>(x);
    local_stage<2, false>(x);
    local_stage<1, false>(x);
  }

  if (!live) return;
  if (vec) {
    int4* dst = reinterpret_cast<int4*>(out + first);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (base + 4 * h < L)
        dst[h] = make_int4(x[4 * h], x[4 * h + 1], x[4 * h + 2],
                           x[4 * h + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kRun; ++e)
      if (base + e < L) out[first + e] = x[e];
  }
}

template <int LP>
int launch(const int* in, int* out, int rows, int L, cudaStream_t stream) {
  using S = Shape<LP>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitonic_sort_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = L % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (rows + S::kRowsPerCta - 1) / S::kRowsPerCta;
  bitonic_sort_kernel<LP><<<blocks, S::kThreads, S::kSmemBytes, stream>>>(
      in, out, rows, L, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in, out: (rows, L) int32, contiguous; Lp a power of two in [128, 8192],
// the lane count each row is padded to (in registers; the pads are never
// read or written).  Launches on `stream`; returns the CUDA error of the
// launch (cudaErrorInvalidValue for an Lp outside the range).
extern "C" int bitonic_sort_rows(const int* in, int* out, int rows, int L,
                                 int Lp, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Lp) {
    case 128: return launch<128>(in, out, rows, L, s);
    case 256: return launch<256>(in, out, rows, L, s);
    case 512: return launch<512>(in, out, rows, L, s);
    case 1024: return launch<1024>(in, out, rows, L, s);
    case 2048: return launch<2048>(in, out, rows, L, s);
    case 4096: return launch<4096>(in, out, rows, L, s);
    case 8192: return launch<8192>(in, out, rows, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
