// Forward compositor: front-to-back alpha compositing of each tile's
// aligned, depth-sorted attribute segment.
//
// Replaces: tpugs/ops/pallas/composite_t.py::_fwd_kernel.
//
// Bound on the H100: operations. Each (pixel, entry) pair costs about 20
// float operations and one exp, against 36 bytes of attributes per entry
// that a whole tile of pixels shares. What held the one-block-per-tile
// design back was its schedule more than its arithmetic: a tile's pixels
// all walked on one SM, so the tile with the longest walk (9,468 entries on
// the 1080p frame) set a floor of about 1.5 ms, and every pixel of a tile
// was evaluated until the last one was done (2.2-2.4x the pairs needed).
//
// Design:
// - Each tile is cut into G = ceil(tile_w / 16) x ceil(tile_h / 16)
//   sub-tiles of 16x16 pixels, one block of 256 threads each at one pixel
//   a thread (composite_t.subtile_geometry; G = 1 at tiles of 16, 4 at 32,
//   16 at 64). The grid is num_tiles x G blocks; block b takes tile
//   order[b / G], `order` listing the tiles by descending entry count (the
//   wrapper's argsort on the card), so the heaviest tiles start first and
//   their sub-tiles land on different SMs.
// - A warp holds a compact 8x4 patch, so a small gaussian reaches few
//   warps and a warp's pixels die together. Pixel (x, y) of the tile keeps
//   its place in the [T, PIX] outputs (composite_t.kernel_pixels maps it).
// - Early exit at four levels. A sub-tile block votes at the top of every
//   batch, __syncthreads_or(any of my pixels still live), and leaves on its
//   own. A warp votes every kVote entries and skips the rest of the batch
//   when none of its pixels is live. A warp skips an entry whose box
//   (composite_entries.cuh) misses its patch, a test the same in every
//   lane. And it skips an entry, before its exp, when for none of its live
//   pixels the power reaches the entry's reach, log(1/255 / opac) - 0.01,
//   below which opac exp(power) < 1/255. An entry skipped so cannot
//   contribute, so every skip is exact. Skipping warps still reach every
//   barrier.
// - Entries are staged into shared memory in batches of 256, double
//   buffered with cp.async. The copies need no registers and no thread
//   waits on them, and the next batch's are in flight while this one is
//   walked; a TMA copy would only save the address arithmetic of 9 copies
//   per thread per batch, which is not where the time goes. One pass per
//   batch writes each entry's reach and box, and pads the batch to a
//   multiple of kVote with empty boxes, so a warp's walk of kVote entries
//   is unrolled without bounds checks and its loads and powers overlap.
// - Each pixel's recurrence is the plain PyTorch version's: the same
//   entries in the same order, round-to-nearest intrinsics in its order (no
//   FMA contraction), so the kernel and that version agree to the bit.
// - Contract guard, in place of a host read of the segments' bounds: a
//   block whose tile has astart < 0, astop < astart or astop > P_al stores
//   the tile + 1 in its guard word (guard_words.cu; cuda_lib.check_guards
//   raises on it) and composites that tile as empty: nothing outside attr
//   is read.
#include <cuda_runtime.h>
#include <math.h>

#include "composite_entries.cuh"

namespace {

using namespace compositor;

constexpr int kThreads = 256;  // a 16x16 sub-tile, one pixel a thread
constexpr int kSub = 16;
constexpr int kBatch = 256;
constexpr int kVote = 8;  // entries between a warp's liveness votes
constexpr float kTThreshold = 1.0f / 255.0f;

// Five blocks an SM: at most 51 registers a thread (56 unbounded), more
// warps to hide the latency of a walk's serial chain.
__global__ void __launch_bounds__(kThreads, 5)
composite_fwd_kernel(const float* __restrict__ attr, long long pal,
                     const int* __restrict__ astart,
                     const int* __restrict__ astop,
                     const int* __restrict__ order, int ntx, int tile_w,
                     int tile_h, int gw, int num_sub, int row_offset,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int* __restrict__ k_last,
                     int* guard) {
  __shared__ __align__(16) float s_attr[2][kBatch * kStride];
  const int t = order[blockIdx.x / num_sub];
  const int sub = blockIdx.x % num_sub;
  long long start = astart[t], stop = astop[t];
  if (start < 0 || stop < start || stop > pal) {
    if (sub == 0 && threadIdx.x == 0) *reinterpret_cast<volatile int*>(guard) = t + 1;
    start = stop = 0;
  }
  const int num = (int)(stop - start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = (sub % gw) * kSub + (warp & 1) * 8 + (lane & 7);
  const int y = (sub / gw) * kSub + (warp >> 1) * 4 + (lane >> 3);
  const bool on = x < tile_w && y < tile_h;
  const float px = (float)((t % ntx) * tile_w + x);
  const float py = (float)((t / ntx + row_offset) * tile_h + y);
  // The warp's 8x4 patch, the same in every lane.
  const float x0 = px - (float)(lane & 7), y0 = py - (float)(lane >> 3);
  const float x1 = x0 + 7.0f, y1 = y0 + 3.0f;
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int nc = 0, kl = -1;

  if (num > 0) stage<kThreads>(s_attr[0], attr, pal, start, min(kBatch, num));
  int buf = 0;
  for (int b0 = 0; b0 < num; b0 += kBatch, buf ^= 1) {
    if (!__syncthreads_or(on && T >= kTThreshold)) break;  // block-uniform
    // Every warp has left the walk of s_attr[buf ^ 1] (the vote above).
    if (b0 + kBatch < num) {
      stage<kThreads>(s_attr[buf ^ 1], attr, pal, start + b0 + kBatch,
                      min(kBatch, num - b0 - kBatch));
    } else {
      __pipeline_commit();  // an empty group keeps the count uniform
    }
    __pipeline_wait_prior(1);  // this batch's copies have landed
    __syncthreads();
    float* sa = s_attr[buf];
    const int nb = min(kBatch, num - b0);
    mark_reach<kThreads, true>(sa, nb, (nb + kVote - 1) / kVote * kVote);
    __syncthreads();
    for (int j0 = 0; j0 < nb; j0 += kVote) {
      if (!__any_sync(kFull, on && T >= kTThreshold)) break;  // warp-uniform
#pragma unroll
      for (int u = 0; u < kVote; ++u) {
        const float* e = sa + (j0 + u) * kStride;
        const float4 v0 = *reinterpret_cast<const float4*>(e);
        if (!box_meets(v0, x0, x1, y0, y1)) continue;  // warp-uniform
        const float4 v1 = *reinterpret_cast<const float4*>(e + 4);
        const float ca = v1.x, cbc = v1.y, cc = v1.z;
        const float dx = __fsub_rn(px, v0.x);
        const float dy = __fsub_rn(py, v0.y);
        const float power = __fadd_rn(
            __fadd_rn(__fmul_rn(ca, __fmul_rn(dx, dx)),
                      __fmul_rn(cc, __fmul_rn(dy, dy))),
            __fmul_rn(cbc, __fmul_rn(dx, dy)));
        if (!__any_sync(kFull, on && T >= kTThreshold && power >= v1.w))
          continue;  // no pixel of the warp can take this entry
        const float4 v2 = *reinterpret_cast<const float4*>(e + 8);
        const float gauss = expf(fminf(power, 0.0f));
        const float alpha = fminf(__fmul_rn(v2.x, gauss), kAlphaClamp);
        if (on && power <= 0.0f && alpha >= kAlphaMin && T >= kTThreshold) {
          const float wgt = __fmul_rn(alpha, T);
          cr = __fadd_rn(cr, __fmul_rn(wgt, v2.y));
          cg = __fadd_rn(cg, __fmul_rn(wgt, v2.z));
          cb = __fadd_rn(cb, __fmul_rn(wgt, v2.w));
          T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
          nc += 1;
          kl = b0 + j0 + u;
        }
      }
    }
  }
  __pipeline_wait_prior(0);  // no copy outlives the block

  if (on) {
    const long long q = (long long)t * tile_w * tile_h + y * tile_w + x;
    color[3 * q + 0] = cr;
    color[3 * q + 1] = cg;
    color[3 * q + 2] = cb;
    final_t[q] = T;
    n_contrib[q] = nc;
    k_last[q] = kl;
  }
}

}  // namespace

extern "C" int tpugs_composite_fwd(int device, const void* attr,
                                   long long pal, const void* astart,
                                   const void* astop, const void* order,
                                   int num_tiles, int ntx, int tile_w,
                                   int tile_h, int row_offset, void* color,
                                   void* final_t, void* n_contrib,
                                   void* k_last, void* guard, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tile_w <= 0 || tile_h <= 0) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const int gw = (tile_w + kSub - 1) / kSub, gh = (tile_h + kSub - 1) / kSub;
  composite_fwd_kernel<<<(unsigned)num_tiles * gw * gh, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)attr, pal, (const int*)astart, (const int*)astop,
      (const int*)order, ntx, tile_w, tile_h, gw, gw * gh, row_offset,
      (float*)color, (float*)final_t, (int*)n_contrib, (int*)k_last,
      (int*)guard);
  return (int)cudaGetLastError();
}
