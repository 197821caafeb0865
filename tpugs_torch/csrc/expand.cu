// Pair expansion: each gaussian's touched tile rect becomes one slot per
// (gaussian, tile) in gaussian-major order, with the pixel-exact corner cull.
//
// Replaces: tpugs/ops/pallas/expand.py::_expand_kernel, in its 4-row mode
// (K1) and in its carry_attrs mode (K1b): given a second table of the nine
// compositor attributes per gaussian (x y ca cb cc op r g b), every slot
// also writes its gaussian's nine values, so the pair sort can carry them
// in place of the gather that packs them per sorted pair.
//
// Bound on the H100: bytes. Per gaussian it reads one 9-word table column
// and per slot it writes 12 bytes (tile, depth, gid); the arithmetic is a
// handful of integer and float operations per slot. Carry mode adds nine
// words read per gaussian and nine written per slot.
//
// Design:
// - One warp per gaussian. The lanes stride over the gaussian's rect slots,
//   so neighbouring lanes write neighbouring addresses and a large rect is
//   spread over 32 lanes instead of one thread.
// - Every thread writes only the slots of its own gaussian:
//   [offset, min(offset + count, p_out)). The caller sizes p_out as
//   min(total pairs, pair capacity), so every slot is written exactly once
//   and pairs past the capacity are dropped, as the clamped chunk offsets
//   of the reference drop them. There is no padded per-chunk layout and no
//   write past a span: blocks run in no order here, so the reference's
//   overrun-then-overwrite scheme would be a data race.
// - The corner cull `dx*dx + dy*dy <= r2` decides a pair on a 1-ulp
//   difference, so it is written with round-to-nearest intrinsics that nvcc
//   never contracts into an FMA. It then rounds exactly as the reference's
//   separate f32 multiplies and add.
// - Culled slots hold the sentinel: tile = num_tiles, depth = +inf.
// - Carry mode writes the attributes as nine rows [9, p_out], so the lanes
//   of a warp write neighbouring words of each row; a culled slot carries
//   its gaussian's values too (it sorts past every tile's segment).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAttr = 9;  // carry mode: x y ca cb cc op r g b

// itab: int32 [5, n] rows = offset, count, tx0, ty0, w (w >= 1).
// ftab: f32   [4, n] rows = gx, gy, r2 (cull radius squared), depth key.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ itab, const float* __restrict__ ftab,
              int n, int p_out, int num_tiles, int ntx, int tile_w,
              int tile_h, int* __restrict__ out_tile,
              float* __restrict__ out_depth, int* __restrict__ out_gid,
              const float* __restrict__ atab, float* __restrict__ out_attr) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // No barrier in this kernel, so leaving early cannot deadlock.
  if (g >= n) return;
  const int off = itab[g];
  const int cnt = itab[(long long)n + g];
  if (cnt <= 0 || off >= p_out) return;
  const int tx0 = itab[2LL * n + g];
  const int ty0 = itab[3LL * n + g];
  const int w = itab[4LL * n + g];
  const float gx = ftab[g];
  const float gy = ftab[(long long)n + g];
  const float r2 = ftab[2LL * n + g];
  const float depth = ftab[3LL * n + g];
  const int end = min(off + cnt, p_out);
  const float span_x = (float)(tile_w - 1);
  const float span_y = (float)(tile_h - 1);
  for (int s = off + lane; s < end; s += 32) {
    const int local = s - off;
    const int q = local / w;
    const int tx = tx0 + (local - q * w);
    const int ty = ty0 + q;
    const float px0 = (float)(tx * tile_w);
    const float py0 = (float)(ty * tile_h);
    // clip(g, p0, p0 + span) - g, as jnp.clip: min(max(g, lo), hi).
    const float dx = __fsub_rn(fminf(fmaxf(gx, px0), __fadd_rn(px0, span_x)), gx);
    const float dy = __fsub_rn(fminf(fmaxf(gy, py0), __fadd_rn(py0, span_y)), gy);
    const bool hit = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2;
    out_tile[s] = hit ? ty * ntx + tx : num_tiles;
    out_depth[s] = hit ? depth : INFINITY;
    out_gid[s] = (int)g;
    if (atab != nullptr) {
#pragma unroll
      for (int r = 0; r < kAttr; ++r)
        out_attr[(long long)r * p_out + s] = atab[(long long)r * n + g];
    }
  }
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
    const long long blocks = ((long long)n + kWarps - 1) / kWarps;
    expand_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)itab, (const float*)ftab, n, p_out, num_tiles, ntx,
        tile_w, tile_h, (int*)out_tile, (float*)out_depth, (int*)out_gid,
        (const float*)atab, (float*)out_attr);
  }
  return (int)cudaGetLastError();
}
