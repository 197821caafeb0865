// The forward and backward compositors' shared handling of a batch of
// entries: staging a tile's aligned attribute columns into shared memory,
// and each entry's reach, which lets a warp skip, exactly, the entries that
// cannot contribute to any of its pixels.
//
// A staged entry is 12 floats, three float4: [x y ex ey] [ca cb cc reach]
// [op r g b]. `reach` is the power below which opac exp(power) < 1/255:
// there alpha < 1/255 and the entry cannot contribute. (ex, ey) are the
// half-extents of the ellipse power >= reach, widened by 0.1% and one
// pixel: a warp whose patch lies outside that box holds no pixel the entry
// reaches. Both are computed once per entry and batch, not per pixel.
#pragma once

#include <cuda_pipeline.h>
#include <math.h>

namespace compositor {

constexpr int kAttr = 9;  // rows x y ca cb cc op r g b of the aligned table
constexpr int kStride = 12;  // floats per staged entry
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kLogAlphaMin = -5.5412636f;  // log(1/255)
// Covers the error of expf and __logf (a few ulp) with a wide margin.
constexpr float kReachMargin = 0.01f;
// Beyond this 4 ca cc / (4 ca cc - cb^2), cancellation in the power's sum
// could exceed the box's margin, so such an entry gets no box.
constexpr float kMaxSkew = 100.0f;
constexpr unsigned kFull = 0xffffffffu;

// The float of a staged entry that row r of the aligned table goes to.
__device__ __forceinline__ int slot_of(int r) {
  return r < 2 ? r : r < 5 ? r + 2 : r + 3;
}

// Columns [col0, col0 + nb) of the 9 attribute rows into buf as
// [entry][kStride] with cp.async (4-byte copies: a segment starts on a
// 128-column boundary, but P_al need not be a multiple of 4), then one
// commit. idx runs along a row, so neighbouring threads read neighbouring
// addresses.
template <int kThreads>
__device__ __forceinline__ void stage(float* buf, const float* attr,
                                      long long pal, long long col0, int nb) {
  for (int idx = threadIdx.x; idx < kAttr * nb; idx += kThreads) {
    const int r = idx / nb, k = idx - r * nb;
    __pipeline_memcpy_async(buf + k * kStride + slot_of(r),
                            attr + r * pal + col0 + k, sizeof(float));
  }
  __pipeline_commit();
}

// Writes reach (and with kBox, ex and ey) of the staged entries [0, nb),
// and an empty box (no warp reached) for [nb, pad). A NaN opacity gets
// reach -inf and a non-elliptic or too skewed conic an unbounded box:
// never skipped.
template <int kThreads, bool kBox>
__device__ __forceinline__ void mark_reach(float* buf, int nb, int pad) {
  for (int k = threadIdx.x; k < pad; k += kThreads) {
    float* e = buf + k * kStride;
    float reach = INFINITY, ex = -INFINITY, ey = -INFINITY;
    if (k < nb) {
      const float a = -e[4], b = -e[5], c = -e[6], op = e[8];
      reach = op == op ? kLogAlphaMin - __logf(op) - kReachMargin : -INFINITY;
      const float ac4 = 4.0f * a * c, d = ac4 - b * b;
      if (!(a > 0.0f && c > 0.0f && d > 0.0f && ac4 <= kMaxSkew * d)) {
        ex = ey = INFINITY;
      } else if (reach <= 0.0f) {  // else power <= 0 < reach: none reached
        const float q = -reach;  // the ellipse: -power <= q
        ex = sqrtf(4.0f * c * q / d) * 1.001f + 1.0f;
        ey = sqrtf(4.0f * a * q / d) * 1.001f + 1.0f;
      }
    }
    e[7] = reach;
    if (kBox) {
      e[2] = ex;
      e[3] = ey;
    }
  }
}

// Whether entry e's box meets the patch [x0, x1] x [y0, y1] (pixel
// coordinates). The same in every lane of a warp.
__device__ __forceinline__ bool box_meets(float4 e, float x0, float x1,
                                          float y0, float y1) {
  return e.x + e.z >= x0 && e.x - e.z <= x1 && e.y + e.w >= y0 &&
         e.y - e.w <= y1;
}

}  // namespace compositor
