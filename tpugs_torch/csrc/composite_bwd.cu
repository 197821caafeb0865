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
// tile's pixels come on top. The one-block-per-tile design before this one
// lost to three things: one SM walked a whole tile (the busiest sets the
// time), every pixel of a tile was evaluated from the tile's largest
// k_last, and each entry's nine sums took 45 warp shuffles, which run at
// a quarter of the float rate.
//
// Design:
// - Each tile is cut into G sub-tiles at two pixels a thread: 16x16 ones
//   (128 threads) where at most 8 cover the tile, else 32x16 ones (256
//   threads); G = 1 at tiles of 16, 4 at 32, 8 at 64
//   (composite_t.subtile_geometry). Each sub-tile is one block, and the G
//   blocks of a tile run as one thread block cluster (launched with
//   cudaLaunchKernelEx; the portable cluster size is 8). Blocks take tiles
//   in descending order of their largest k_last, which is their walk
//   (`order`, the wrapper's argsort on the card). A warp holds a compact
//   8x8 patch, 4 rows a slot. Each thread holds its pixels' T (from the
//   forward's final T), suffix sum R (from r0), colour cotangent and
//   k_last. Two pixels a thread halve the sums across lanes per pixel.
// - All blocks of a cluster walk the tile's entries together, from the
//   tile's largest k_last (a cluster-wide max, read from each block's
//   shared memory through distributed shared memory) down to entry 0, in
//   batches of 96 staged in shared memory (double-buffered cp.async, as in
//   composite_fwd.cu, with each entry's reach; the forward's box test
//   costs the backward more than it saves, since its warps walk only up to
//   their own largest k_last). Per entry and pixel, with
//   the forward's own alpha:
//     contrib = passes && e <= k_last;  a = contrib ? alpha : 0
//     om = max(1 - a, 1e-5);  T = T / om  (T before the entry, recovered by
//     division as the TPU kernel does, not by re-running the forward)
//     g_alpha = contrib ? T dC.rgb - R / om : 0;  R += a T dC.rgb
//   and the opacity and power gradients are zero where alpha_raw >= 0.99.
// - Work a warp skips, exactly: entries above the warp's own largest
//   k_last; and an entry for which no lane has e <= k_last and a power at
//   or above the entry's reach
//   (composite_entries.cuh), found before the exp and the divisions; and,
//   in the same way, one of a thread's two pixel slots (the top or bottom
//   half of the warp's patch). No lane contributes then: T / 1 = T, R + 0
//   = R and every term is zero, so the warp leaves its state as it is and
//   its sums are 0.
// - Sums, deterministic and without atomics or global scratch. A thread
//   adds its two pixels' terms in slot order. A warp sums four entries' 9
//   terms (36 values a lane) by a transposing butterfly: at xor 16 and
//   xor 8 each lane keeps half of its values and adds its partner's copy of
//   that half (18 and 9 shuffles), then three xor levels on the last 9: 54
//   shuffles for four entries in place of 180, and the pairing is the
//   shuffle-down tree's (l + 16, 8, 4, 2, 1), since a + b = b + a. The
//   warps' sums land in shared memory; the block adds them in warp order;
//   after a cluster barrier, block rank r adds the G blocks' partials of
//   its contiguous share of the batch's entries in rank order through
//   cluster.map_shared_rank, and stores them (a contiguous share keeps the
//   stores coalesced). The block partials are double-buffered, so one
//   cluster barrier per batch keeps the next batch from overwriting
//   partials another block still reads. composite_t._block_sum repeats this
//   tree, so the plain version agrees to the bit.
// - Entry-major stores go as idx -> (slot idx / 9, gradient idx % 9), so
//   neighbouring threads write neighbouring addresses in both layouts.
// - Slots past the tile's largest k_last, up to its count, are written as
//   zeros; slots past the count (alignment gaps) are not written, and the
//   caller masks them before reducing.
// - No thread returns early: every thread reaches every barrier, and the
//   loop bounds come from the cluster max, which all threads share. A
//   final cluster barrier keeps each block's shared memory alive while
//   another block may read it.
// - Contract guard, in place of a host read: a tile with astart < 0, astop
//   < astart or astop > P_al stores the tile + 1 in the guard word
//   (guard_words.cu) and is walked as empty: nothing is read or written
//   outside the buffers.
// - The arithmetic uses round-to-nearest intrinsics in the plain version's
//   order (no FMA contraction), so the two agree to the bit on one device.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "composite_entries.cuh"

namespace coop = cooperative_groups;

namespace {

using namespace compositor;

constexpr int kPPT = 2;  // pixels a thread: rows y and y + 4 of its patch
constexpr int kSubH = 16;
constexpr int kBatch = 96;  // entries a batch: 43.7 KB of shared memory at 8 warps
constexpr int kGrad = 9;  // d x, d y, d ca, d cb, d cc, d op, d r, d g, d b
constexpr int kQuad = 4;  // entries per butterfly
constexpr int kVals = kQuad * kGrad;  // 36 values a lane
constexpr int kMaxSub = 8;  // the portable cluster size
constexpr float kOneMinusMin = 1e-5f;

// gw x gh sub-tiles of sw x 16 pixels: sw = 16 where at most kMaxSub cover
// the tile, else 32; as composite_t.subtile_geometry(backward=True).
bool subtile_geometry(int tile_w, int tile_h, int* gw, int* gh, int* sw) {
  if (tile_w <= 0 || tile_h <= 0) return false;
  for (int w = 16; w <= 32; w += 16) {
    const int a = (tile_w + w - 1) / w, b = (tile_h + kSubH - 1) / kSubH;
    if (a * b <= kMaxSub) {
      *gw = a;
      *gh = b;
      *sw = w;
      return true;
    }
  }
  return false;
}

// kWarps warps: 4 for a 16x16 sub-tile, 8 for a 32x16 one. Six 4-warp
// blocks an SM (at most 85 registers a thread; 96 unbounded, with a few
// bytes spilled at 80): 24 warps to hide the divisions' latency.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, kWarps == 4 ? 6 : 2)
composite_bwd_kernel(const float* __restrict__ attr, long long pal,
                     const int* __restrict__ astart,
                     const int* __restrict__ astop,
                     const int* __restrict__ order, int ntx, int tile_w,
                     int tile_h, int gw, int num_sub, int row_offset,
                     const float* __restrict__ d_color,
                     const float* __restrict__ r0,
                     const float* __restrict__ final_t,
                     const int* __restrict__ k_last,
                     float* __restrict__ out, int entry_major, int* guard) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kAcross = kWarps / 2;  // warps across the sub-tile
  __shared__ __align__(16) float s_attr[2][kBatch * kStride];
  __shared__ float s_part[kWarps][kGrad][kBatch];
  __shared__ float s_blk[2][kGrad][kBatch];
  __shared__ int s_max[kWarps];
  __shared__ int s_bmax;
  coop::cluster_group cluster = coop::this_cluster();
  const int sub = (int)cluster.block_rank();
  const int t = order[blockIdx.x / num_sub];
  long long start = astart[t], stop = astop[t];
  if (start < 0 || stop < start || stop > pal) {
    if (sub == 0 && threadIdx.x == 0) *reinterpret_cast<volatile int*>(guard) = t + 1;
    start = stop = 0;
  }
  const int num = (int)(stop - start);
  const int pix = tile_w * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = (sub % gw) * (kAcross * 8) + (warp % kAcross) * 8 + (lane & 7);
  const int row = (sub / gw) * kSubH + (warp / kAcross) * (4 * kPPT) + (lane >> 3);
  const int tx = t % ntx;
  const int ty = t / ntx + row_offset;

  float px[kPPT], py[kPPT], T[kPPT], R[kPPT], dcr[kPPT], dcg[kPPT], dcb[kPPT];
  int kl[kPPT];
  int my_max = -1;
#pragma unroll
  for (int i = 0; i < kPPT; ++i) {
    const int y = row + 4 * i;
    px[i] = (float)(tx * tile_w + x);
    py[i] = (float)(ty * tile_h + y);
    if (x < tile_w && y < tile_h) {
      const long long q = (long long)t * pix + y * tile_w + x;
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
  const int wmax = __reduce_max_sync(kFull, my_max);
  if (lane == 0) s_max[warp] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = s_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, s_max[w]);
    s_bmax = m;
  }
  cluster.sync();
  int kmax = -1;
  for (int q = 0; q < num_sub; ++q)
    kmax = max(kmax, *cluster.map_shared_rank(&s_bmax, q));
  kmax = min(kmax, num - 1);

  // Entries past every pixel's last contributor have zero gradient; the
  // cluster's blocks share the stores.
  const int zstep = num_sub * kThreads, z0 = sub * kThreads + threadIdx.x;
  if (entry_major) {
    const int nz = max(num - (kmax + 1), 0) * kGrad;
    float* z = out + (start + kmax + 1) * kGrad;
    for (int idx = z0; idx < nz; idx += zstep) z[idx] = 0.0f;
  } else {
    for (int k = kmax + 1 + z0; k < num; k += zstep) {
#pragma unroll
      for (int r = 0; r < kGrad; ++r) out[r * pal + start + k] = 0.0f;
    }
  }

  if (kmax >= 0)
    stage<kThreads>(s_attr[0], attr, pal, start + max(kmax - kBatch + 1, 0),
                    min(kBatch, kmax + 1));
  int buf = 0;
  for (int hi = kmax; hi >= 0; hi -= kBatch, buf ^= 1) {
    const int lo = max(hi - kBatch + 1, 0);
    const int nb = hi - lo + 1;
    // s_attr[buf ^ 1] was last read in the walk before the previous
    // batch's barriers.
    if (hi - kBatch >= 0) {
      const int lo2 = max(hi - 2 * kBatch + 1, 0);
      stage<kThreads>(s_attr[buf ^ 1], attr, pal, start + lo2,
                      hi - kBatch - lo2 + 1);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    float* sa = s_attr[buf];
    mark_reach<kThreads, false>(sa, nb, nb);
    __syncthreads();
    for (int jt = nb - 1; jt >= 0; jt -= kQuad) {
      float v[kVals];
#pragma unroll
      for (int k = 0; k < kVals; ++k) v[k] = 0.0f;
      bool any = false;  // warp-uniform
#pragma unroll
      for (int qd = 0; qd < kQuad; ++qd) {
        const int j = jt - qd;
        const int e = lo + j;
        if (j < 0 || e > wmax) continue;  // warp-uniform
        const float* en = sa + j * kStride;
        const float4 v0 = *reinterpret_cast<const float4*>(en);
        const float4 v1 = *reinterpret_cast<const float4*>(en + 4);
        const float gx = v0.x, gy = v0.y;
        const float ca = v1.x, cbc = v1.y, cc = v1.z, reach = v1.w;
        float dx[kPPT], dy[kPPT], power[kPPT];
        bool reached[kPPT];  // per slot, the same in every lane
#pragma unroll
        for (int i = 0; i < kPPT; ++i) {
          dx[i] = __fsub_rn(px[i], gx);
          dy[i] = __fsub_rn(py[i], gy);
          power[i] = __fadd_rn(
              __fadd_rn(__fmul_rn(ca, __fmul_rn(dx[i], dx[i])),
                        __fmul_rn(cc, __fmul_rn(dy[i], dy[i]))),
              __fmul_rn(cbc, __fmul_rn(dx[i], dy[i])));
          reached[i] = __any_sync(kFull, e <= kl[i] && power[i] >= reach);
        }
        if (!reached[0] && !reached[1]) continue;  // exact skip: T, R kept
        any = true;
        const float4 v2 = *reinterpret_cast<const float4*>(en + 8);
        const float op = v2.x, cr = v2.y, cg = v2.z, cb = v2.w;
        const float ca2 = __fmul_rn(2.0f, ca), cc2 = __fmul_rn(2.0f, cc);
        float* g = v + qd * kGrad;
#pragma unroll
        for (int i = 0; i < kPPT; ++i) {
          if (!reached[i]) continue;  // no lane's pixel in this slot: exact
          const float gauss = expf(fminf(power[i], 0.0f));
          const float alpha_raw = __fmul_rn(op, gauss);
          const float alpha = fminf(alpha_raw, kAlphaClamp);
          const bool contrib =
              power[i] <= 0.0f && alpha >= kAlphaMin && e <= kl[i];
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
          g[0] = __fadd_rn(g[0], __fmul_rn(g_pow, __fadd_rn(__fmul_rn(ca2, dx[i]),
                                                          __fmul_rn(cbc, dy[i]))));
          g[1] = __fadd_rn(g[1], __fmul_rn(g_pow, __fadd_rn(__fmul_rn(cbc, dx[i]),
                                                          __fmul_rn(cc2, dy[i]))));
          g[2] = __fadd_rn(g[2], __fmul_rn(g_pow, __fmul_rn(dx[i], dx[i])));
          g[3] = __fadd_rn(g[3], __fmul_rn(g_pow, __fmul_rn(dx[i], dy[i])));
          g[4] = __fadd_rn(g[4], __fmul_rn(g_pow, __fmul_rn(dy[i], dy[i])));
          g[5] = __fadd_rn(g[5], g_op);
          g[6] = __fadd_rn(g[6], __fmul_rn(w, dcr[i]));
          g[7] = __fadd_rn(g[7], __fmul_rn(w, dcg[i]));
          g[8] = __fadd_rn(g[8], __fmul_rn(w, dcb[i]));
        }
      }
      if (!any) {  // no lane contributed to any of the four entries
        for (int idx = lane; idx < kVals; idx += 32) {
          const int j = jt - idx / kGrad;
          if (j >= 0) s_part[warp][idx % kGrad][j] = 0.0f;
        }
        continue;
      }
      // Transposing butterfly: after xor 16 a lane holds 18 values summed
      // over {l, l ^ 16}, after xor 8 nine summed over 4 lanes, the nine
      // terms of entry jt - (2 [l & 16] + [l & 8]); xor 4, 2, 1 finish them.
      const bool h16 = lane & 16, h8 = lane & 8;
#pragma unroll
      for (int k = 0; k < kVals / 2; ++k) {
        const float keep = h16 ? v[kVals / 2 + k] : v[k];
        const float send = h16 ? v[k] : v[kVals / 2 + k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 16));
      }
#pragma unroll
      for (int k = 0; k < kGrad; ++k) {
        const float keep = h8 ? v[kGrad + k] : v[k];
        const float send = h8 ? v[k] : v[kGrad + k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 8));
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k)
          v[k] = __fadd_rn(v[k], __shfl_xor_sync(kFull, v[k], off));
      }
      const int j = jt - (h16 ? 2 : 0) - (h8 ? 1 : 0);
      const int r = lane & 7;  // lane r of the group stores term r (and 8)
      float mine = v[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) mine = r == k ? v[k] : mine;
      if (j >= 0) {
        s_part[warp][r][j] = mine;
        if (r == 0) s_part[warp][8][j] = v[8];
      }
    }
    __syncthreads();
    float* blk = &s_blk[buf][0][0];
    for (int idx = threadIdx.x; idx < kGrad * nb; idx += kThreads) {
      const int r = idx / nb, j = idx - r * nb;
      float s = s_part[0][r][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, s_part[w][r][j]);
      blk[r * kBatch + j] = s;
    }
    cluster.sync();
    // This block's share of the batch: entries [j0, j0 + cnt).
    const int per = (nb + num_sub - 1) / num_sub;
    const int j0 = sub * per;
    const int cnt = max(min(per, nb - j0), 0);
    for (int idx = threadIdx.x; idx < kGrad * cnt; idx += kThreads) {
      int r, j;
      if (entry_major) {
        j = idx / kGrad;
        r = idx - j * kGrad;
      } else {
        r = idx / cnt;
        j = idx - r * cnt;
      }
      j += j0;
      float s = cluster.map_shared_rank(blk, 0)[r * kBatch + j];
      for (int q = 1; q < num_sub; ++q)
        s = __fadd_rn(s, cluster.map_shared_rank(blk, q)[r * kBatch + j]);
      const long long col = start + lo + j;
      out[entry_major ? col * kGrad + r : r * pal + col] = r < 2 ? -s : s;
    }
  }
  __pipeline_wait_prior(0);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// A launch configuration of clusters of g blocks.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  ClusterConfig(int blocks, int threads, int g, cudaStream_t stream) {
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.stream = stream;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)g;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
};

}  // namespace

extern "C" int tpugs_composite_bwd(int device, const void* attr,
                                   long long pal, const void* astart,
                                   const void* astop, const void* order,
                                   int num_tiles, int ntx, int tile_w,
                                   int tile_h, int row_offset,
                                   const void* d_color, const void* r0,
                                   const void* final_t, const void* k_last,
                                   void* out, int entry_major, void* guard,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int gw, gh, sw;
  // Tiles that 8 sub-tiles of 32x16 cover; the wrapper checks first.
  if (!subtile_geometry(tile_w, tile_h, &gw, &gh, &sw))
    return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const int g = gw * gh;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)attr;
  const int* s0 = (const int*)astart;
  const int* s1 = (const int*)astop;
  const int* o = (const int*)order;
  const float* dc = (const float*)d_color;
  const float* rr = (const float*)r0;
  const float* ft = (const float*)final_t;
  const int* kl = (const int*)k_last;
  float* ou = (float*)out;
  int* gd = (int*)guard;
  const int warps = sw == 16 ? 4 : 8;
  ClusterConfig c(num_tiles * g, warps * 32, g, s);
  err = warps == 4
            ? cudaLaunchKernelEx(&c.cfg, composite_bwd_kernel<4>, a, pal, s0,
                                 s1, o, ntx, tile_w, tile_h, gw, g, row_offset,
                                 dc, rr, ft, kl, ou, entry_major, gd)
            : cudaLaunchKernelEx(&c.cfg, composite_bwd_kernel<8>, a, pal, s0,
                                 s1, o, ntx, tile_w, tile_h, gw, g, row_offset,
                                 dc, rr, ft, kl, ou, entry_major, gd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The sub-tiles per tile (the cluster size) and how many such clusters the
// card can hold at once (cudaOccupancyMaxActiveClusters), for tile_w x
// tile_h tiles.
extern "C" int tpugs_composite_bwd_clusters(int device, int tile_w,
                                            int tile_h, int* sub_tiles,
                                            int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int gw, gh, sw;
  if (!subtile_geometry(tile_w, tile_h, &gw, &gh, &sw))
    return (int)cudaErrorInvalidValue;
  const int g = gw * gh;
  *sub_tiles = g;
  ClusterConfig c(g, sw == 16 ? 128 : 256, g, 0);
  return (int)(sw == 16 ? cudaOccupancyMaxActiveClusters(
                              clusters, composite_bwd_kernel<4>, &c.cfg)
                        : cudaOccupancyMaxActiveClusters(
                              clusters, composite_bwd_kernel<8>, &c.cfg));
}
