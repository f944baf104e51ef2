// Device helpers shared by the window kernels K1 (window.cu), K5
// (window_v2.cu) and K6 (window_v3.cu): coordinate truncation, the two
// layouts of the LI stack they read, and the move of an exact flat index
// into a layout.
#pragma once

#include <cuda_runtime.h>

namespace fdcm {

constexpr unsigned kFull = 0xffffffffu;

// The stack a kernel reads: the row-major LI stack, or its tiled copy
// (S*D, ceil(H/4), ceil(W/8), 32): 8 x 4 tiles of four 4 x 2 sectors.
enum { kRows = 0, kTiles = 1 };

// trunc(p) after the +-2^24 clamp (NaN to -2^24), as the plain versions'
// to_int_trunc
__device__ __forceinline__ long long trunc64(float p) {
  return __float2ll_rz(fminf(fmaxf(p, -16777216.0f), 16777216.0f));
}

// trunc(p) for 0 <= p < 2^23: the sum rounds toward zero onto the integer
// grid of [2^23, 2^24).  Every other p, NaN included, gives 2^23 or more
// (as unsigned), so "trunc_u(p) < W" holds exactly when 0 <= p < W.
__device__ __forceinline__ unsigned trunc_u(float p) {
  return (unsigned)__float_as_int(__fadd_rz(p, 8388608.0f)) - 0x4B000000u;
}

// clamp(trunc64(p), lo, hi) for integers 0 <= lo <= hi < 2^23 given as
// f32: truncation is monotone and fixes integers, so clamping first in f32
// gives the same pixel, and fmaxf takes NaN to lo as trunc64's -2^24 is
// clamped to lo.  No conversion instruction.
__device__ __forceinline__ unsigned clamp_trunc(float p, float lo, float hi) {
  return trunc_u(fminf(fmaxf(p, lo), hi));
}

// offset of in-slice pixel (x, y) in its slice of the stack read
template <int kLayout>
__device__ __forceinline__ unsigned slice_offset(unsigned x, unsigned y,
                                                 unsigned w, unsigned tw) {
  if (kLayout == kTiles)
    return ((y >> 2) * tw + (x >> 3)) * 32u + (((y >> 1) & 1u) << 4) +
           (((x >> 2) & 1u) << 3) + ((y & 1u) << 2) + (x & 3u);
  return y * w + x;
}

// a row-major flat index f of the (n, h, w) stack, already clamped to it,
// moved to the layout read
template <int kLayout>
__device__ long long layout_index(long long f, int h, int w, unsigned tw,
                                  long long slice_len) {
  if (kLayout == kRows) return f;
  const long long hw = (long long)h * w;
  const long long q = f / hw;
  const int r = (int)(f - q * hw), y = r / w, x = r - y * w;
  return q * slice_len +
         slice_offset<kLayout>((unsigned)x, (unsigned)y, (unsigned)w, tw);
}

}  // namespace fdcm
