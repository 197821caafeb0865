// Two segment sums of the nine per-pair gradients into per-gaussian sums:
// the sorted one (K5, `tpugs_segreduce_sorted`) and the interval one (K6,
// `tpugs_segreduce_interval`), further down with its own note.
//
// Sorted segment sum: per-gaussian sums of the nine per-pair gradient
// columns, once the pairs are sorted by gaussian id.
//
// Replaces: tpugs/ops/pallas/segreduce.py::_segreduce_sorted_kernel (K5)
// and tpugs/ops/pallas/segreduce.py::_segreduce_kernel (K6).
//
// Bound on the H100: bytes. Each sorted slot's nine columns are read once
// and each gaussian's nine sums written once; there is one add per byte
// pair read, far below the card's rate of operations.
//
// Design:
// - The sort by gaussian id and the per-gaussian run bounds (one
//   searchsorted of n + 1 ids over the sorted keys) stay outside, in
//   PyTorch, as the JAX package leaves its sort to XLA. Slots whose key is
//   the sentinel sort past every gaussian's run and are never read.
// - One thread per gaussian sums its run [bounds[g], bounds[g + 1]) in
//   sorted order for each column and writes column g of the [9, n] output
//   (zero for an empty run). The TPU kernel's equality one-hot matmul over
//   512-gaussian blocks was a matrix-unit artifact and is not carried over.
// - Neighbouring threads own neighbouring runs, so a warp's reads of one
//   column fall on a short contiguous span. No atomics: the sums are
//   deterministic for a given sort, and the plain PyTorch version adds in
//   the same order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 9;

__global__ void __launch_bounds__(kThreads)
segreduce_sorted_kernel(const float* __restrict__ cols, long long p,
                        const int* __restrict__ bounds, int n,
                        float* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;  // no barrier in this kernel
  const int lo = bounds[g];
  const int hi = bounds[g + 1];
#pragma unroll
  for (int r = 0; r < kCols; ++r) {
    const float* c = cols + r * p;
    float s = 0.0f;
    for (int i = lo; i < hi; ++i) s = __fadd_rn(s, c[i]);
    out[(long long)r * n + g] = s;
  }
}

// Interval segment sum (K6): rows [P, 9] f32 hold one gradient row per
// expansion slot, gaussian-major: gaussian g's slots are the interval
// [start[g], start[g] + count[g]), the intervals monotone and disjoint,
// inside [0, exp_end).
//
// Bound on the H100: bytes. Each slot of an interval is read once (36
// bytes), each gaussian's interval (8 bytes) read and its nine sums (36
// bytes) written once; one add per float read. At 2^24 gaussians, most of
// them outside the view, the [9, n] output (604 MB) is three quarters of
// the bytes and nearly all zeros of empty intervals: the kernel is a
// memset with reads in its way.
//
// Design:
// - One thread per gaussian adds its interval's rows in slot order, from
//   zero, nine sums in registers, and writes column g of the [9, n] output
//   (zero for an empty interval). The TPU kernel's interval one-hot matmul
//   over 512-gaussian blocks was a matrix-unit artifact and is not carried
//   over.
// - Neighbouring threads own neighbouring intervals, so a warp reads one
//   contiguous span of rows (a row is 36 contiguous bytes) and writes 32
//   neighbouring words per output row; a warp whose gaussians are all
//   empty reads no row and only stores. Wider designs (4 gaussians a
//   thread with int4 loads and float4 stores, or 2 with int2 and float2)
//   need 60-117 registers against this one's 32, halve the warps in
//   flight and ran no faster at the 2^24 step's intervals (PERF.md). The
//   2^24 train step feeds no interval longer than 9 slots (chip_smoke.py
//   prints the lengths), so no warp waits long on one thread's walk there.
// - No atomics: the sums are deterministic, and the plain PyTorch version
//   adds in the same order, so the two agree to the bit.
// - Contract guard, in place of a host read of the intervals' end (a pass
//   over n and a sync in every call): every interval, empty or not, is
//   checked against [0, exp_end) here, and the kernel never reads a row
//   outside it. A violating gaussian g gets NaN sums and g + 1 is stored
//   in its guard word, a word of mapped host memory (guard_words.cu). The
//   host reads the word without synchronising the device
//   (cuda_lib.check_guards) and raises once the stream has passed this
//   kernel: before every launch of the library, and at the Trainer's read
//   of each block's step stats, before it logs or saves a checkpoint.
__global__ void __launch_bounds__(kThreads)
segreduce_interval_kernel(const float* __restrict__ rows,
                          const int* __restrict__ start,
                          const int* __restrict__ count, int n,
                          long long exp_end, float* __restrict__ out,
                          int* guard) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;  // no barrier in this kernel
  const long long lo = start[g];
  const long long cnt = count[g];
  const bool bad = cnt < 0 || lo < 0 || lo + cnt > exp_end;
  if (bad) *reinterpret_cast<volatile int*>(guard) = (int)g + 1;
  const long long hi = bad ? lo : lo + cnt;
  float s[kCols];
#pragma unroll
  for (int r = 0; r < kCols; ++r) s[r] = bad ? __int_as_float(0x7fc00000) : 0.0f;
  for (long long i = lo; i < hi; ++i) {
    const float* row = rows + i * kCols;
#pragma unroll
    for (int r = 0; r < kCols; ++r) s[r] = __fadd_rn(s[r], row[r]);
  }
#pragma unroll
  for (int r = 0; r < kCols; ++r) out[(long long)r * n + g] = s[r];
}

}  // namespace

extern "C" int tpugs_segreduce_interval(int device, const void* rows,
                                        const void* start, const void* count,
                                        int n, long long exp_end, void* out,
                                        void* guard, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  segreduce_interval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)start, (const int*)count, n, exp_end,
      (float*)out, (int*)guard);
  return (int)cudaGetLastError();
}

extern "C" int tpugs_segreduce_sorted(int device, const void* cols,
                                      long long p, const void* bounds, int n,
                                      void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  segreduce_sorted_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cols, p, (const int*)bounds, n, (float*)out);
  return (int)cudaGetLastError();
}
