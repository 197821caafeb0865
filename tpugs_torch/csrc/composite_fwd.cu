// Forward compositor: front-to-back alpha compositing of each tile's
// aligned, depth-sorted attribute segment.
//
// Replaces: tpugs/ops/pallas/composite_t.py::_fwd_kernel.
//
// Bound on the H100: operations. Each (pixel, entry) pair costs about 20
// float operations and one exp, against 36 bytes of attributes per entry
// that a whole tile of pixels shares.
//
// Design:
// - One block of 256 threads per tile; each thread holds PPT = ceil(pix /
//   256) pixels in registers (tiles from 16x16 to 64x64). The TPU kernel's
//   entry waves, prefix-product trees and 128-entry exit groups were vector
//   unit artifacts and are not carried over: a thread walks the entries one
//   by one with the reference's serial recurrence.
// - Entries are staged into shared memory in batches of 256 (9 floats
//   each), one coalesced column per thread.
// - Early exit is a block vote, __syncthreads_or(any of my pixels still
//   live), at the top of every batch. Its result is the same in every
//   thread, so the whole block leaves the loop together. No thread returns
//   early: every thread reaches every barrier, or the vote would deadlock.
//   The vote is also the barrier that keeps the next batch's loads from
//   overwriting entries that a slower thread is still reading.
// - The arithmetic uses round-to-nearest intrinsics in the plain PyTorch
//   version's order (no FMA contraction), so the kernel and that version
//   agree to the bit on the same device.
// - __launch_bounds__(256) matches the block size, so a launch is never
//   refused for lack of registers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 256;
constexpr int kAttr = 9;  // x y ca cb cc op r g b
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTThreshold = 1.0f / 255.0f;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ attr, long long pal,
                     const int* __restrict__ astart,
                     const int* __restrict__ astop, int ntx, int tile_w,
                     int tile_h, int pix, int row_offset,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib, int* __restrict__ k_last) {
  __shared__ float s_attr[kAttr][kBatch];
  const int t = blockIdx.x;
  const long long start = astart[t];
  const int num = astop[t] - astart[t];
  const int tx = t % ntx;
  const int ty = t / ntx + row_offset;

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
  int nc[PPT], kl[PPT];
  bool on[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    on[i] = p < pix;
    px[i] = (float)(tx * tile_w + p % tile_w);
    py[i] = (float)(ty * tile_h + p / tile_w);
    T[i] = 1.0f;
    cr[i] = cg[i] = cb[i] = 0.0f;
    nc[i] = 0;
    kl[i] = -1;
  }

  for (int b0 = 0; b0 < num; b0 += kBatch) {
    bool live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= on[i] && T[i] >= kTThreshold;
    if (!__syncthreads_or(live)) break;  // uniform across the block
    const int k = b0 + threadIdx.x;
    if (k < num) {
#pragma unroll
      for (int r = 0; r < kAttr; ++r) s_attr[r][threadIdx.x] = attr[r * pal + start + k];
    }
    __syncthreads();
    const int nb = min(kBatch, num - b0);
    for (int j = 0; j < nb; ++j) {
      const float x = s_attr[0][j], y = s_attr[1][j];
      const float ca = s_attr[2][j], cbc = s_attr[3][j], cc = s_attr[4][j];
      const float op = s_attr[5][j];
      const float r = s_attr[6][j], gr = s_attr[7][j], bl = s_attr[8][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = __fsub_rn(px[i], x);
        const float dy = __fsub_rn(py[i], y);
        const float power = __fadd_rn(
            __fadd_rn(__fmul_rn(ca, __fmul_rn(dx, dx)),
                      __fmul_rn(cc, __fmul_rn(dy, dy))),
            __fmul_rn(cbc, __fmul_rn(dx, dy)));
        const float gauss = expf(fminf(power, 0.0f));
        const float alpha = fminf(__fmul_rn(op, gauss), kAlphaClamp);
        const bool contrib = on[i] && power <= 0.0f && alpha >= kAlphaMin &&
                             T[i] >= kTThreshold;
        if (contrib) {
          const float wgt = __fmul_rn(alpha, T[i]);
          cr[i] = __fadd_rn(cr[i], __fmul_rn(wgt, r));
          cg[i] = __fadd_rn(cg[i], __fmul_rn(wgt, gr));
          cb[i] = __fadd_rn(cb[i], __fmul_rn(wgt, bl));
          T[i] = __fmul_rn(T[i], __fsub_rn(1.0f, alpha));
          nc[i] += 1;
          kl[i] = b0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!on[i]) continue;
    const long long q = (long long)t * pix + threadIdx.x + i * kThreads;
    color[3 * q + 0] = cr[i];
    color[3 * q + 1] = cg[i];
    color[3 * q + 2] = cb[i];
    final_t[q] = T[i];
    n_contrib[q] = nc[i];
    k_last[q] = kl[i];
  }
}

template <int PPT>
void launch(int num_tiles, cudaStream_t stream, const float* attr,
            long long pal, const int* astart, const int* astop, int ntx,
            int tile_w, int tile_h, int pix, int row_offset, float* color,
            float* final_t, int* n_contrib, int* k_last) {
  composite_fwd_kernel<PPT><<<num_tiles, kThreads, 0, stream>>>(
      attr, pal, astart, astop, ntx, tile_w, tile_h, pix, row_offset, color,
      final_t, n_contrib, k_last);
}

}  // namespace

extern "C" int tpugs_composite_fwd(int device, const void* attr,
                                   long long pal, const void* astart,
                                   const void* astop, int num_tiles, int ntx,
                                   int tile_w, int tile_h, int row_offset,
                                   void* color, void* final_t,
                                   void* n_contrib, void* k_last,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int pix = tile_w * tile_h;
  // Tiles up to 16 pixels per thread (64x64); the wrapper checks first.
  if (pix <= 0 || pix > 16 * kThreads) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)attr;
  const int* s0 = (const int*)astart;
  const int* s1 = (const int*)astop;
  float* c = (float*)color;
  float* ft = (float*)final_t;
  int* nc = (int*)n_contrib;
  int* kl = (int*)k_last;
  const int ppt = (pix + kThreads - 1) / kThreads;
  if (ppt <= 1) {
    launch<1>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, c, ft, nc, kl);
  } else if (ppt <= 2) {
    launch<2>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, c, ft, nc, kl);
  } else if (ppt <= 4) {
    launch<4>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, c, ft, nc, kl);
  } else if (ppt <= 8) {
    launch<8>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, c, ft, nc, kl);
  } else {
    launch<16>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, c, ft, nc, kl);
  }
  return (int)cudaGetLastError();
}
