// Kernel K5: FDCM window scores, generation 2 (patch-clamped probes).
// Per candidate c and lane k (two-sided pattern, m = t0[c] + lane(k)):
//   trx = trm + m * vx,  try = trn + m * vy                 (rounded, then)
//   for each line in order[c] with wt != 0, for endpoints p1, p2:
//     x = trunc(e_maj + trx), y = trunc(e_min + try)
//     x = x0a + clip(x - x0a, 0, 255), y = y0a + clip(y - y0a, 0, 31)
//     v = x-major ? LI[sid, y, x] : LI[sid, x, y]
//   out = sum, in order, of |v(p2) - v(p1)| * wt
// Every product and sum is __fmul_rn/__fadd_rn (no FMA contraction, as on
// the TPU).  Coordinates are clamped to +-2^24 before the float->int
// conversion, as in K1 and the plain version.
//
// Replaces openfdcm_tpu/ops/window_kernel.py::window_scores_device (Pallas
// _kernel: a sorted (candidate, line) item stream, one slice or transposed
// slice DMA'd into VMEM per slice change, a 32 x 256 patch per endpoint
// and per-lane dynamic gathers).
//
// What bounds it on the H100: as K1, the L1 tag lookups of its gathers (one
// per distinct 128-byte line a warp's 32 probes touch; in the row-major
// stack a y-major candidate's 32 lanes step along the row index, one line
// each), and before this design a dependent load chain per (lane, line):
// order -> wt -> ep, org, sid, weight-0 lines included, with 64-bit
// clamps and index arithmetic per probe.  The design, K1's:
// * one warp per (candidate, 32 lanes).  The warp walks order 32 lines at a
//   time; each lane loads one line, and a ballot compacts the lines of
//   nonzero weight (NaN counts) into shared memory in order's order, with
//   their endpoints and patch origins (as f32);
// * per lane, trx and try are computed once; a probe is two f32 clamps into
//   its patch and one rounded-toward-zero truncation per axis
//   (clamp_trunc): no conversion instruction, 32-bit offsets inside the
//   slice, the 64-bit slice base once per line.  A line whose patch lies
//   inside the canvas (the origins _origins makes always do) and whose
//   slice id lies inside the stack is in its slice by construction; any
//   other line takes the exact 64-bit clamps, flat index and clip of the
//   plain version;
// * the probes of 4 lines are in flight before any is summed; the sum still
//   runs in order;
// * window_v2_kernel<kTiles> reads K1's tiled copy of the stack (8 x 4
//   tiles), where a y-major candidate's 32 probes touch about 8 cache lines
//   instead of 32; <kRows> reads the stack.
#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace fdcm;

constexpr int kWarps = 4;    // warps per block
constexpr int kPos = 64;     // lane k < 64 is m = +k, else -(k - 63)
constexpr int kPatchW = 256;
constexpr int kPatchH = 32;
constexpr int kGroup = 4;    // lines whose probes are in flight together

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the exact probe of the plain version: 64-bit patch clamp and flat index,
// clipped to the stack, then moved to the layout read
template <int kLayout>
__device__ long long exact_index(int sl, float px, float py, int ox, int oy,
                                 bool xm, int q, long long len, unsigned tw,
                                 long long slice_len) {
  const long long maj = ox + clampll(trunc64(px) - ox, 0, kPatchW - 1);
  const long long mnr = oy + clampll(trunc64(py) - oy, 0, kPatchH - 1);
  const long long f = (long long)sl * q * q + (xm ? mnr * q + maj : maj * q + mnr);
  return layout_index<kLayout>(clampll(f, 0, len - 1), q, q, tw, slice_len);
}

template <int kLayout>
__global__ void __launch_bounds__(kWarps * 32, 8)
window_v2_kernel(const float* __restrict__ src, long long li_len,
                 const float4* __restrict__ ep, const int4* __restrict__ org,
                 const int* __restrict__ sid, const float* __restrict__ wt,
                 const int* __restrict__ order,
                 const float4* __restrict__ geo, const float* __restrict__ t0,
                 const int* __restrict__ x_major, float* __restrict__ out,
                 long long m_count, int n_lines, int count, int q,
                 unsigned tw, long long slice_len) {
  __shared__ float4 s_ep[kWarps][32];
  __shared__ float4 s_of[kWarps][32];   // origins as f32 (fast lines)
  __shared__ int4 s_oi[kWarps][32];     // origins (exact lines)
  __shared__ float s_wt[kWarps][32];
  __shared__ int s_sid[kWarps][32];
  __shared__ bool s_fast[kWarps][32];   // in its slice by construction
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = count >> 5;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= m_count * chunks) return;  // whole warps; no block barrier below
  const long long c = u / chunks;
  const int k = (int)(u - c * chunks) * 32 + lane;
  const float step = k >= kPos ? (float)(-(k - (kPos - 1))) : (float)k;
  const float m = __fadd_rn(t0[c], step);
  const float4 g = geo[c];  // vx, vy, trm, trn
  const float trx = __fadd_rn(g.z, __fmul_rn(m, g.x));
  const float try_ = __fadd_rn(g.w, __fmul_rn(m, g.y));
  const bool xm = x_major[c] != 0;
  const int n_slices = (int)(li_len / ((long long)q * q));
  const float hi_x = (float)(kPatchW - 1), hi_y = (float)(kPatchH - 1);

  float acc = 0.0f;
  for (int l0 = 0; l0 < n_lines; l0 += 32) {
    // stage this chunk's lines of nonzero weight, in order's order
    const int j = l0 + lane;
    long long cl = 0;
    float wl = 0.0f;
    if (j < n_lines) {
      cl = c * n_lines + order[c * n_lines + j];
      wl = wt[cl];
    }
    const bool live = wl != 0.0f;  // NaN counts, as in the plain version
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) {
      const int pos = __popc(mask & ((1u << lane) - 1u));
      const int4 o = org[cl];  // x0a p1, y0a p1, x0a p2, y0a p2
      const int sl = sid[cl];
      const bool fast = (unsigned)sl < (unsigned)n_slices &&
                        (unsigned)o.x <= (unsigned)(q - kPatchW) &&
                        (unsigned)o.z <= (unsigned)(q - kPatchW) &&
                        (unsigned)o.y <= (unsigned)(q - kPatchH) &&
                        (unsigned)o.w <= (unsigned)(q - kPatchH);
      s_ep[warp][pos] = ep[cl];  // maj p1, min p1, maj p2, min p2
      s_of[warp][pos] = make_float4((float)o.x, (float)o.y, (float)o.z,
                                    (float)o.w);
      s_oi[warp][pos] = o;
      s_wt[warp][pos] = wl;
      s_sid[warp][pos] = sl;
      s_fast[warp][pos] = fast;
    }
    __syncwarp();
    const int n = __popc(mask);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const int gn = min(kGroup, n - g0);
      float a[kGroup], b[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i < gn) {
          const float4 e = s_ep[warp][g0 + i];
          const float px1 = __fadd_rn(e.x, trx), py1 = __fadd_rn(e.y, try_);
          const float px2 = __fadd_rn(e.z, trx), py2 = __fadd_rn(e.w, try_);
          const int sl = s_sid[warp][g0 + i];
          const float *p1, *p2;
          if (s_fast[warp][g0 + i]) {
            // common path: 32-bit offsets inside the line's slice
            const float4 o = s_of[warp][g0 + i];
            const unsigned maj1 = clamp_trunc(px1, o.x, __fadd_rn(o.x, hi_x));
            const unsigned mnr1 = clamp_trunc(py1, o.y, __fadd_rn(o.y, hi_y));
            const unsigned maj2 = clamp_trunc(px2, o.z, __fadd_rn(o.z, hi_x));
            const unsigned mnr2 = clamp_trunc(py2, o.w, __fadd_rn(o.w, hi_y));
            const float* base = src + (long long)sl * slice_len;
            p1 = base + (xm ? slice_offset<kLayout>(maj1, mnr1, q, tw)
                            : slice_offset<kLayout>(mnr1, maj1, q, tw));
            p2 = base + (xm ? slice_offset<kLayout>(maj2, mnr2, q, tw)
                            : slice_offset<kLayout>(mnr2, maj2, q, tw));
          } else {
            // a patch beyond the canvas or a slice id outside the stack
            const int4 o = s_oi[warp][g0 + i];
            p1 = src + exact_index<kLayout>(sl, px1, py1, o.x, o.y, xm, q,
                                            li_len, tw, slice_len);
            p2 = src + exact_index<kLayout>(sl, px2, py2, o.z, o.w, xm, q,
                                            li_len, tw, slice_len);
          }
          a[i] = __ldg(p1);
          b[i] = __ldg(p2);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (i < gn)
          acc = __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(b[i], a[i])),
                                         s_wt[warp][g0 + i]));
    }
    __syncwarp();
  }
  out[c * count + k] = acc;
}

}  // namespace

// tiles == nullptr: read the row-major stack li; else its tiled copy
// (window.cu's fdcm_window_tiles).
extern "C" int fdcm_window_v2(const float* li, long long li_len,
                              const float* tiles, const float* ep,
                              const int* org, const int* sid, const float* wt,
                              const int* order, const float* geo,
                              const float* t0, const int* x_major, float* out,
                              long long m_count, int n_lines, int count, int q,
                              cudaStream_t stream) {
  const long long qq = (long long)q * q;
  const unsigned tw = (unsigned)((q + 7) / 8);
  const long long tiled = (long long)((q + 3) / 4) * tw * 32;
  if (m_count <= 0 || n_lines < 0 || li_len <= 0 || q < kPatchW ||
      qq >= (1LL << 31) || tiled >= (1LL << 31) || li_len % qq ||
      li_len / qq > 0x7fffffffLL || (count != kPos && count != 2 * kPos))
    return (int)cudaErrorInvalidValue;
  const long long warps = m_count * (count / 32);
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const float4* ep4 = reinterpret_cast<const float4*>(ep);
  const int4* org4 = reinterpret_cast<const int4*>(org);
  const float4* geo4 = reinterpret_cast<const float4*>(geo);
  if (tiles)
    window_v2_kernel<kTiles><<<blocks, kWarps * 32, 0, stream>>>(
        tiles, li_len, ep4, org4, sid, wt, order, geo4, t0, x_major, out,
        m_count, n_lines, count, q, tw, tiled);
  else
    window_v2_kernel<kRows><<<blocks, kWarps * 32, 0, stream>>>(
        li, li_len, ep4, org4, sid, wt, order, geo4, t0, x_major, out,
        m_count, n_lines, count, q, tw, qq);
  return (int)cudaGetLastError();
}
