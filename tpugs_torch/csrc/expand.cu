// Pair expansion: each gaussian's touched tile rect becomes one slot per
// (gaussian, tile) in gaussian-major order, with the pixel-exact corner cull.
//
// Replaces: tpugs/ops/pallas/expand.py::_expand_kernel, in its 4-row mode
// (K1) and in its carry_attrs mode (K1b): given a second table of the nine
// compositor attributes per gaussian (x y ca cb cc op r g b), every slot
// also writes its gaussian's nine values, so the pair sort can carry them
// in place of the gather that packs them per sorted pair.
//
// Bound on the H100: bytes. The least the function needs is each
// gaussian's count (4 bytes), the other eight table words of each gaussian
// that owns a slot below p_out (32 bytes) and 12 bytes written per slot
// (tile, depth, gid); the arithmetic is a handful of integer and float
// operations per slot. Carry mode adds the nine attributes of each owning
// gaussian (36 bytes) and nine words written per slot (36 bytes).
//
// Design:
// - One block of 256 threads per chunk of consecutive gaussians, not a
//   warp per gaussian: most gaussians of a large scene own no slot. A chunk
//   holds 512 gaussians (256 in carry mode, whose staged attributes double
//   the shared memory): on the H100 that ran faster than chunks of 1024
//   (fewer blocks resident per SM) at 1M gaussians, and than chunks of 256
//   (four times the blocks that read a chunk behind the camera and exit)
//   at 2^24.
// - Coalesced loads, lane i on gaussian g0 + i of each row: the count row
//   first, the offset only where the count is > 0, the other seven words
//   (and the nine attributes) only where the gaussian owns a slot below
//   p_out. A chunk that owns none exits after those loads, so a chunk
//   behind the camera reads 4 bytes per gaussian.
// - The owning gaussians are compacted in order into shared memory (a
//   ballot per warp, a scan over the block's warp counts).
// - Offsets are an exclusive prefix sum, so the chunk's slots form one
//   span [offset of its first owner, min(end of its last owner, p_out)).
//   All threads stride over it, neighbouring threads on neighbouring slots
//   of every output row, and each slot finds its owner by a binary search
//   over the staged offsets (strictly increasing: every owner has a count
//   > 0), between the owner of the thread's previous slot and 256 owners
//   past it.
// - Each slot below p_out lies in exactly one chunk's span and is written
//   by exactly one thread; nothing past a span is written. Blocks run in no
//   order here, so the reference's overrun-then-overwrite scheme would be a
//   data race, and its one-hot ownership matmul and padded chunk spans have
//   no use.
// - The corner cull `dx*dx + dy*dy <= r2` decides a pair on a 1-ulp
//   difference, so it is written with round-to-nearest intrinsics that nvcc
//   never contracts into an FMA. It then rounds exactly as the reference's
//   separate f32 multiplies and add.
// - Culled slots hold the sentinel: tile = num_tiles, depth = +inf; they
//   carry their gaussian's gid and (carry mode) attributes, and sort past
//   every tile's segment.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAttr = 9;  // carry mode: x y ca cb cc op r g b

// Gaussians per block.
constexpr int kChunk = 512;
constexpr int kChunkCarry = 256;

// itab: int32 [5, n] rows = offset, count, tx0, ty0, w (w >= 1).
// ftab: f32   [4, n] rows = gx, gy, r2 (cull radius squared), depth key.
// atab: f32   [9, n] (carry mode only).
template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ itab, const float* __restrict__ ftab,
              int n, int p_out, int num_tiles, int ntx, int tile_w,
              int tile_h, int* __restrict__ out_tile,
              float* __restrict__ out_depth, int* __restrict__ out_gid,
              const float* __restrict__ atab, float* __restrict__ out_attr) {
  constexpr int C = kCarry ? kChunkCarry : kChunk;
  constexpr int kRounds = C / kThreads;  // gaussians per thread
  static_assert(kRounds * kWarps <= 32, "one warp scans the warp counts");
  // The owners of the chunk, compacted in gaussian order.
  __shared__ int s_off[C], s_gid[C], s_tx0[C], s_ty0[C], s_w[C];
  __shared__ float s_gx[C], s_gy[C], s_r2[C], s_depth[C];
  __shared__ float s_attr[kCarry ? kAttr * C : 1];
  __shared__ int s_base[kRounds * kWarps];  // owners before each warp's 32
  __shared__ int s_owners, s_hi;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long nn = n;
  const long long g0 = (long long)blockIdx.x * C;

  int cnt[kRounds], off[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long g = g0 + k * kThreads + tid;
    cnt[k] = g < nn ? itab[nn + g] : 0;
  }
  bool any = false;
  unsigned own[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long g = g0 + k * kThreads + tid;
    off[k] = cnt[k] > 0 ? itab[g] : p_out;
    const bool mine = off[k] < p_out;
    any |= mine;
    own[k] = __ballot_sync(0xffffffffu, mine);
  }
  // Uniform exit: no thread of the block has reached a barrier yet.
  if (!__syncthreads_or(any)) return;

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      s_base[k * kWarps + warp] = __popc(own[k]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warp counts, in gaussian order
    const int v = lane < kRounds * kWarps ? s_base[lane] : 0;
    int sum = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, sum, d);
      if (lane >= d) sum += t;
    }
    if (lane < kRounds * kWarps) s_base[lane] = sum - v;
    if (lane == 31) s_owners = sum;
  }
  __syncthreads();

  const int m = s_owners;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (!((own[k] >> lane) & 1u)) continue;
    const long long g = g0 + k * kThreads + tid;
    const int j = s_base[k * kWarps + warp] + __popc(own[k] & below);
    s_off[j] = off[k];
    s_gid[j] = (int)g;
    s_tx0[j] = itab[2 * nn + g];
    s_ty0[j] = itab[3 * nn + g];
    s_w[j] = itab[4 * nn + g];
    s_gx[j] = ftab[g];
    s_gy[j] = ftab[nn + g];
    s_r2[j] = ftab[2 * nn + g];
    s_depth[j] = ftab[3 * nn + g];
    if (kCarry) {
#pragma unroll
      for (int r = 0; r < kAttr; ++r) s_attr[r * C + j] = atab[r * nn + g];
    }
    if (j == m - 1) s_hi = (int)min((long long)off[k] + cnt[k], (long long)p_out);
  }
  __syncthreads();

  const int lo = s_off[0];
  const int hi = s_hi;
  const float span_x = (float)(tile_w - 1);
  const float span_y = (float)(tile_h - 1);
  int a = 0;  // owner of this thread's previous slot
  for (long long s = lo + tid; s < hi; s += kThreads) {
    const int slot = (int)s;
    // The owner is the last one whose offset is <= slot; slot s + kThreads
    // lies at most kThreads owners past the owner of s.
    int b = min(m - 1, a + kThreads);
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (s_off[mid] <= slot) a = mid;
      else b = mid - 1;
    }
    const int local = slot - s_off[a];
    const int w = s_w[a];
    const int q = local / w;
    const int tx = s_tx0[a] + (local - q * w);
    const int ty = s_ty0[a] + q;
    const float gx = s_gx[a];
    const float gy = s_gy[a];
    const float px0 = (float)(tx * tile_w);
    const float py0 = (float)(ty * tile_h);
    // clip(g, p0, p0 + span) - g, as jnp.clip: min(max(g, lo), hi).
    const float dx = __fsub_rn(fminf(fmaxf(gx, px0), __fadd_rn(px0, span_x)), gx);
    const float dy = __fsub_rn(fminf(fmaxf(gy, py0), __fadd_rn(py0, span_y)), gy);
    const bool hit = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= s_r2[a];
    out_tile[s] = hit ? ty * ntx + tx : num_tiles;
    out_depth[s] = hit ? s_depth[a] : INFINITY;
    out_gid[s] = s_gid[a];
    if (kCarry) {
#pragma unroll
      for (int r = 0; r < kAttr; ++r)
        out_attr[(long long)r * p_out + s] = s_attr[r * C + a];
    }
  }
}

template <bool kCarry>
void launch(const void* itab, const void* ftab, int n, int p_out,
            int num_tiles, int ntx, int tile_w, int tile_h, void* out_tile,
            void* out_depth, void* out_gid, const void* atab, void* out_attr,
            cudaStream_t stream) {
  constexpr int C = kCarry ? kChunkCarry : kChunk;
  const long long blocks = ((long long)n + C - 1) / C;
  expand_kernel<kCarry><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)itab, (const float*)ftab, n, p_out, num_tiles, ntx, tile_w,
      tile_h, (int*)out_tile, (float*)out_depth, (int*)out_gid,
      (const float*)atab, (float*)out_attr);
}

}  // namespace

extern "C" int tpugs_expand(int device, const void* itab, const void* ftab,
                            int n, int p_out, int num_tiles, int ntx,
                            int tile_w, int tile_h, void* out_tile,
                            void* out_depth, void* out_gid,
                            const void* atab, void* out_attr, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && p_out > 0) {
    if (atab != nullptr)
      launch<true>(itab, ftab, n, p_out, num_tiles, ntx, tile_w, tile_h,
                   out_tile, out_depth, out_gid, atab, out_attr,
                   (cudaStream_t)stream);
    else
      launch<false>(itab, ftab, n, p_out, num_tiles, ntx, tile_w, tile_h,
                    out_tile, out_depth, out_gid, atab, out_attr,
                    (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
