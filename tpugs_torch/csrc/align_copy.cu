// Align-copy: moves each tile's compact, depth-sorted attribute segment to
// its 128-aligned start and zeroes the gap up to the next 128 boundary.
//
// Replaces: tpugs/ops/pallas/pack.py::_align_copy_kernel.
//
// Bound on the H100: bytes. It reads each compact column of 16 rows once
// and writes each aligned column once; there is no arithmetic to speak of.
//
// Design:
// - One block per tile. Tile t writes exactly the columns
//   [astart[t], astart[t] + pad128(count[t])): its segment, then zeros, so
//   row 10 (valid) is 0 in the gap. It never writes outside that span. On
//   the TPU a chunk could overrun into the next tile's region because the
//   grid ran in order and the next tile overwrote it later; blocks here run
//   in parallel and in no order, so an overrun would be a data race.
// - Threads take consecutive columns, so each row's reads and writes are
//   coalesced. Columns past the last tile's span are not written; the
//   caller sizes the output to end there.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kAlign = 128;

__global__ void __launch_bounds__(kThreads)
align_copy_kernel(const float* __restrict__ attr_c, long long pc,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ astart,
                  const int* __restrict__ counts, float* __restrict__ out,
                  long long pal) {
  const int t = blockIdx.x;
  const long long src = tile_start[t];
  const long long dst = astart[t];
  const int num = counts[t];
  const int span = (num + kAlign - 1) / kAlign * kAlign;
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const bool in_seg = j < num;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      out[r * pal + dst + j] = in_seg ? attr_c[r * pc + src + j] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int tpugs_align_copy(int device, const void* attr_c, long long pc,
                                const void* tile_start, const void* astart,
                                const void* counts, int num_tiles, void* out,
                                long long pal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    align_copy_kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)attr_c, pc, (const int*)tile_start,
        (const int*)astart, (const int*)counts, (float*)out, pal);
  }
  return (int)cudaGetLastError();
}
