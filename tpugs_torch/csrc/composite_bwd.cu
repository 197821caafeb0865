// Backward compositor: per-pair gradients of each tile's aligned,
// depth-sorted attribute segment, walked back to front.
//
// Replaces: tpugs/ops/pallas/composite_t.py::_bwd_kernel, both layouts:
// transposed_out=True (K4, attribute-major [9, P_al], one contiguous row per
// gradient: the sorted segment reduction's input) and transposed_out=False
// (K4b, entry-major [P_al, 9], one row of nine gradients per slot: the
// scatter-add and the interval segment sum gather whole rows). The layout is
// a runtime argument of the one kernel: the walk and the summation tree are
// the same code, only the final store's addresses differ, so the two
// layouts are bit-identical under transposition. A row is NUM_ATTR = 9
// floats, not the TPU's 128-lane row: the 128 lanes were the TPU's lane
// tile, and every consumer reads only the first nine.
//
// Bound on the H100: operations. Each (pixel, entry) pair the gradient
// needs costs 53 float operations, exp counted as one and comparisons and
// selects not counted: the forward's alpha (14), 1 - a and T's division
// (3), dC.rgb, w, g_alpha and R (11), and the nine gradient terms with their
// running sums (25). They stand against 36 bytes of attributes per entry
// that a whole tile of pixels shares; each entry's nine sums over the
// tile's pixels add warp shuffles on top.
//
// Design:
// - One block of 256 threads per tile, as the forward kernel; each thread
//   holds PPT = ceil(pix / 256) pixels in registers: T (starting at the
//   forward's final T), the suffix sum R (starting at r0), the colour
//   cotangent and k_last.
// - The walk starts at the tile's largest k_last (a block max) and goes down
//   to entry 0 in shared-memory batches of 128 loaded in reverse. Per entry
//   and pixel, with the forward's own alpha:
//     contrib = passes && e <= k_last;  a = contrib ? alpha : 0
//     om = max(1 - a, 1e-5);  T = T / om  (T before the entry, recovered by
//     division as the TPU kernel does, not by re-running the forward)
//     g_alpha = contrib ? T dC.rgb - R / om : 0;  R += a T dC.rgb
//   and the opacity and power gradients are zero where alpha_raw >= 0.99.
// - Each entry's nine per-pixel terms are summed by every thread over its
//   pixels in order, then over the warp by shuffles (a warp with no
//   contribution writes zeros), and the eight warp partials land in shared
//   memory; after the batch the block adds them in warp order and writes
//   the entries' nine rows. No atomics: the result is deterministic, and
//   the plain PyTorch version repeats this summation tree.
// - Entry-major stores go as idx -> (slot idx / 9, gradient idx % 9), so
//   neighbouring threads write neighbouring addresses in both layouts.
// - Slots past the tile's largest k_last, up to its count, are written as
//   zeros; slots past the count (alignment gaps) are not written, and the
//   caller masks them before reducing.
// - No thread returns early: every thread reaches every barrier, and the
//   loop bounds come from the block max, which all threads share.
// - The arithmetic uses round-to-nearest intrinsics in the plain version's
//   order (no FMA contraction), so the two agree to the bit on one device.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;
constexpr int kAttr = 9;  // x y ca cb cc op r g b
constexpr int kGrad = 9;  // d x, d y, d ca, d cb, d cc, d op, d r, d g, d b
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kOneMinusMin = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ attr, long long pal,
                     const int* __restrict__ astart,
                     const int* __restrict__ astop, int ntx, int tile_w,
                     int tile_h, int pix, int row_offset,
                     const float* __restrict__ d_color,
                     const float* __restrict__ r0,
                     const float* __restrict__ final_t,
                     const int* __restrict__ k_last,
                     float* __restrict__ out, int entry_major) {
  __shared__ float s_attr[kAttr][kBatch];
  __shared__ float s_part[kGrad][kWarps][kBatch];
  __shared__ int s_max[kWarps];
  const int t = blockIdx.x;
  const long long start = astart[t];
  const int num = astop[t] - astart[t];
  const int tx = t % ntx;
  const int ty = t / ntx + row_offset;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[PPT], py[PPT], T[PPT], R[PPT], dcr[PPT], dcg[PPT], dcb[PPT];
  int kl[PPT];
  int my_max = -1;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = (float)(tx * tile_w + p % tile_w);
    py[i] = (float)(ty * tile_h + p / tile_w);
    if (p < pix) {
      const long long q = (long long)t * pix + p;
      T[i] = final_t[q];
      R[i] = r0[q];
      dcr[i] = d_color[3 * q + 0];
      dcg[i] = d_color[3 * q + 1];
      dcb[i] = d_color[3 * q + 2];
      kl[i] = k_last[q];
    } else {  // no pixel: never contributes
      T[i] = 1.0f;
      R[i] = dcr[i] = dcg[i] = dcb[i] = 0.0f;
      kl[i] = -1;
    }
    my_max = max(my_max, kl[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_max = max(my_max, __shfl_xor_sync(kFull, my_max, off));
  if (lane == 0) s_max[warp] = my_max;
  __syncthreads();
  int kmax = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) kmax = max(kmax, s_max[w]);
  kmax = min(kmax, num - 1);

  // Entries past every pixel's last contributor have zero gradient.
  if (entry_major) {
    const int nz = max(num - (kmax + 1), 0) * kGrad;
    float* z = out + (start + kmax + 1) * kGrad;
    for (int idx = threadIdx.x; idx < nz; idx += kThreads) z[idx] = 0.0f;
  } else {
    for (int k = kmax + 1 + threadIdx.x; k < num; k += kThreads) {
#pragma unroll
      for (int r = 0; r < kGrad; ++r) out[r * pal + start + k] = 0.0f;
    }
  }

  for (int hi = kmax; hi >= 0; hi -= kBatch) {
    const int lo = max(hi - kBatch + 1, 0);
    const int nb = hi - lo + 1;
    __syncthreads();  // the previous batch's partials have been read
    if (threadIdx.x < nb) {
#pragma unroll
      for (int r = 0; r < kAttr; ++r)
        s_attr[r][threadIdx.x] = attr[r * pal + start + lo + threadIdx.x];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int e = lo + j;
      const float x = s_attr[0][j], y = s_attr[1][j];
      const float ca = s_attr[2][j], cbc = s_attr[3][j], cc = s_attr[4][j];
      const float op = s_attr[5][j];
      const float cr = s_attr[6][j], cg = s_attr[7][j], cb = s_attr[8][j];
      const float ca2 = __fmul_rn(2.0f, ca), cc2 = __fmul_rn(2.0f, cc);
      float g[kGrad];
#pragma unroll
      for (int r = 0; r < kGrad; ++r) g[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = __fsub_rn(px[i], x);
        const float dy = __fsub_rn(py[i], y);
        const float power = __fadd_rn(
            __fadd_rn(__fmul_rn(ca, __fmul_rn(dx, dx)),
                      __fmul_rn(cc, __fmul_rn(dy, dy))),
            __fmul_rn(cbc, __fmul_rn(dx, dy)));
        const float gauss = expf(fminf(power, 0.0f));
        const float alpha_raw = __fmul_rn(op, gauss);
        const float alpha = fminf(alpha_raw, kAlphaClamp);
        const bool contrib = power <= 0.0f && alpha >= kAlphaMin && e <= kl[i];
        const float a = contrib ? alpha : 0.0f;
        const float om = fmaxf(__fsub_rn(1.0f, a), kOneMinusMin);
        T[i] = __fdiv_rn(T[i], om);
        const float dcdot = __fadd_rn(
            __fadd_rn(__fmul_rn(dcr[i], cr), __fmul_rn(dcg[i], cg)),
            __fmul_rn(dcb[i], cb));
        const float w = __fmul_rn(a, T[i]);
        const float g_alpha =
            contrib ? __fsub_rn(__fmul_rn(T[i], dcdot), __fdiv_rn(R[i], om))
                    : 0.0f;
        R[i] = __fadd_rn(R[i], __fmul_rn(w, dcdot));
        const bool clamp_ok = alpha_raw < kAlphaClamp;
        const float g_op = clamp_ok ? __fmul_rn(g_alpha, gauss) : 0.0f;
        const float g_pow = clamp_ok ? __fmul_rn(g_alpha, alpha) : 0.0f;
        g[0] = __fadd_rn(g[0], __fmul_rn(g_pow, __fadd_rn(__fmul_rn(ca2, dx),
                                                        __fmul_rn(cbc, dy))));
        g[1] = __fadd_rn(g[1], __fmul_rn(g_pow, __fadd_rn(__fmul_rn(cbc, dx),
                                                        __fmul_rn(cc2, dy))));
        g[2] = __fadd_rn(g[2], __fmul_rn(g_pow, __fmul_rn(dx, dx)));
        g[3] = __fadd_rn(g[3], __fmul_rn(g_pow, __fmul_rn(dx, dy)));
        g[4] = __fadd_rn(g[4], __fmul_rn(g_pow, __fmul_rn(dy, dy)));
        g[5] = __fadd_rn(g[5], g_op);
        g[6] = __fadd_rn(g[6], __fmul_rn(w, dcr[i]));
        g[7] = __fadd_rn(g[7], __fmul_rn(w, dcg[i]));
        g[8] = __fadd_rn(g[8], __fmul_rn(w, dcb[i]));
        any |= contrib;
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int r = 0; r < kGrad; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            g[r] = __fadd_rn(g[r], __shfl_down_sync(kFull, g[r], off));
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGrad; ++r) g[r] = 0.0f;
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kGrad; ++r) s_part[r][warp][j] = g[r];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGrad * nb; idx += kThreads) {
      int r, j;
      if (entry_major) {
        j = idx / kGrad;
        r = idx - j * kGrad;
      } else {
        r = idx / nb;
        j = idx - r * nb;
      }
      float s = s_part[r][0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, s_part[r][w][j]);
      const long long col = start + lo + j;
      out[entry_major ? col * kGrad + r : r * pal + col] = r < 2 ? -s : s;
    }
  }
}

template <int PPT>
void launch(int num_tiles, cudaStream_t stream, const float* attr,
            long long pal, const int* astart, const int* astop, int ntx,
            int tile_w, int tile_h, int pix, int row_offset,
            const float* d_color, const float* r0, const float* final_t,
            const int* k_last, float* out, int entry_major) {
  composite_bwd_kernel<PPT><<<num_tiles, kThreads, 0, stream>>>(
      attr, pal, astart, astop, ntx, tile_w, tile_h, pix, row_offset, d_color,
      r0, final_t, k_last, out, entry_major);
}

}  // namespace

extern "C" int tpugs_composite_bwd(int device, const void* attr,
                                   long long pal, const void* astart,
                                   const void* astop, int num_tiles, int ntx,
                                   int tile_w, int tile_h, int row_offset,
                                   const void* d_color, const void* r0,
                                   const void* final_t, const void* k_last,
                                   void* out, int entry_major,
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
  const float* dc = (const float*)d_color;
  const float* rr = (const float*)r0;
  const float* ft = (const float*)final_t;
  const int* kl = (const int*)k_last;
  float* o = (float*)out;
  const int ppt = (pix + kThreads - 1) / kThreads;
  if (ppt <= 1) {
    launch<1>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, dc, rr, ft, kl, o, entry_major);
  } else if (ppt <= 2) {
    launch<2>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, dc, rr, ft, kl, o, entry_major);
  } else if (ppt <= 4) {
    launch<4>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, dc, rr, ft, kl, o, entry_major);
  } else if (ppt <= 8) {
    launch<8>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, dc, rr, ft, kl, o, entry_major);
  } else {
    launch<16>(num_tiles, s, a, pal, s0, s1, ntx, tile_w, tile_h, pix, row_offset, dc, rr, ft, kl, o, entry_major);
  }
  return (int)cudaGetLastError();
}
