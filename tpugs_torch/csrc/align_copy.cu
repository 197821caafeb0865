// Align-copy: moves each tile's compact, depth-sorted attribute segment to
// its 128-aligned start and zeroes the gap up to the next 128 boundary.
//
// Replaces: tpugs/ops/pallas/pack.py::_align_copy_kernel.
//
// Bound on the H100: bytes. It reads each compact column of 16 rows once
// and writes each aligned column once; there is no arithmetic to speak of.
//
// Design:
// - The work is cut by output, not by tile. Every tile's segment starts on
//   a 128-column boundary, so each 128-column chunk of the output belongs
//   to one tile: the last whose start is at or before the chunk's first
//   column (a zero-count tile shares its start with the next one). One
//   warp per chunk finds that tile by a binary search over astart and
//   copies the chunk's 16 rows: lane l takes 4 consecutive columns, reads
//   them at their unaligned source offset and writes them as one float4 to
//   the aligned destination, or zeros past the tile's entries (so row 10,
//   valid, is 0 in the gap). The grid is p_aligned / 128 equal pieces, so
//   a tile of 8,192 entries is 64 warps of the same size as any other and
//   no tile's length sets the kernel's time; the one-block-per-tile design
//   before it ran the busiest tile's 8,192 columns in one block.
// - Every column of the output is written, those past the last tile's
//   padded end with zeros, as the plain version does. A row whose columns
//   are not 16-byte aligned (p_aligned not a multiple of 4) and the ragged
//   end store their floats one by one.
// - Contract guard, in place of a host read of the segments' bounds: the
//   threads of the grid check every tile once (grid-stride): its start a
//   multiple of 128 and at least 0, its padded segment ending at or before
//   the next tile's start (for the last tile, p_aligned), and its entries
//   inside [0, Pc) of attr_c. A violating tile t stores t + 1 in its guard
//   word, a word of mapped host memory (guard_words.cu). The host reads
//   the word without synchronising the device (cuda_lib.check_guards) and
//   raises once the stream has passed this kernel: before every launch of
//   the library, and at the host read that ends each frame of the offline
//   renderer (render CLI) and each block of the Trainer's steps, before a
//   frame is returned or a checkpoint saved. No read leaves [0, Pc): a
//   column whose source lies outside it gets NaN, and no write leaves
//   [0, p_aligned).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 chunks per block
constexpr int kWarp = 32;
constexpr int kRows = 16;
constexpr int kAlign = 128;  // columns per chunk: 4 per lane

__global__ void __launch_bounds__(kThreads)
align_copy_kernel(const float* __restrict__ attr_c, long long pc,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ astart,
                  const int* __restrict__ counts, int num_tiles,
                  float* __restrict__ out, long long pal, int* guard) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = tid; t < num_tiles; t += stride) {
    const long long a = astart[t], c = counts[t], s = tile_start[t];
    const long long next = t + 1 < num_tiles ? astart[t + 1] : pal;
    const long long end = a + (c + kAlign - 1) / kAlign * kAlign;
    if (c < 0 || a < 0 || a % kAlign != 0 || end > next
        || (c > 0 && (s < 0 || s + c > pc))) {
      *reinterpret_cast<volatile int*>(guard) = (int)t + 1;
    }
  }
  const long long c0 = tid / kWarp * kAlign;  // this warp's chunk
  if (c0 >= pal) return;  // no barrier in this kernel
  // The owner: the last tile whose start is at or before c0, or none.
  int lo = 0, hi = num_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (astart[mid] <= c0) lo = mid + 1; else hi = mid;
  }
  long long src = 0;
  int take = 0;  // columns of this chunk that hold entries
  if (lo > 0) {
    const long long k0 = c0 - astart[lo - 1];
    const long long left = counts[lo - 1] - k0;
    take = left <= 0 ? 0 : left >= kAlign ? kAlign : (int)left;
    src = tile_start[lo - 1] + k0;
  }
  const int k = (threadIdx.x & (kWarp - 1)) * 4;  // first of 4 columns
  const long long j = c0 + k;
  const bool vec = j + 4 <= pal;
  float v[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long col = src + k + e;
      v[r][e] = k + e >= take ? 0.0f
                : col >= 0 && col < pc ? attr_c[r * pc + col]
                : __int_as_float(0x7fc00000);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* o = out + r * pal + j;
    if (vec && (reinterpret_cast<unsigned long long>(o) & 15ull) == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e < pal) o[e] = v[r][e];
      }
    }
  }
}

}  // namespace

extern "C" int tpugs_align_copy(int device, const void* attr_c, long long pc,
                                const void* tile_start, const void* astart,
                                const void* counts, int num_tiles, void* out,
                                long long pal, void* guard, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    const long long warps = (pal + kAlign - 1) / kAlign;
    long long blocks = (warps * kWarp + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;  // the tiles are checked all the same
    align_copy_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)attr_c, pc, (const int*)tile_start,
        (const int*)astart, (const int*)counts, num_tiles, (float*)out, pal,
        (int*)guard);
  }
  return (int)cudaGetLastError();
}
