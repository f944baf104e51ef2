// Kernel K1: FDCM window scores.  Per candidate c and step lane k:
//   m   = t0[c] + lane(k)
//   tr  = scene_tr[c] + m * v[c]                       (rounded, then)
//   p   = e + tr, int-truncated                       (dt3cpu.cpp:151-165)
//   out = sum over lines in line order of wt * |LI[p1] - LI[p2]|
// Every product and sum is __fmul_rn/__fadd_rn: nvcc would otherwise
// contract mul+add into an FMA and move probe pixels by one ulp.  Probe
// indices sid*H*W + y*W + x are clamped to the stack like
// jnp.take(mode="clip"); coordinates are clamped to +-2^24 first, so the
// float->int conversion is defined.  Lines of weight 0 add nothing.
//
// Replaces openfdcm_tpu/ops/window_kernel.py::window_scores_device_v4
// (Pallas _kernel_v4, with its sorted item stream and VMEM slice patches).
//
// What bounds it on the H100: not HBM bytes (a main pass probes each
// distinct cell about ten times) and not issue, but the L1 tag lookups of
// its gathers: a warp probe costs one lookup per distinct 128-byte line its
// 32 probes touch.  A warp's lanes are 32 consecutive steps along the
// rasterized step vector (|v.x| = 1 or |v.y| = 1), so in the row-major LI
// stack an x-major ray at the mean slope touches about 15 lines, and a
// y-major ray 32, one per row.  Measured on the main pass: y-major
// candidates cost twice x-major ones.  The design:
// * tile_kernel copies the stack, once per search dispatch, into tiles of
//   8 columns x 4 rows (32 floats, one 128-byte line), each 32-byte sector
//   a 4 x 2 block: a 32-step ray in either major touches about 8 lines and
//   fewer sectors.  window_kernel<kTiles> reads the copy;
//   window_kernel<kRows> reads the row-major stack (callers without the
//   copy: K1's few calls under window generations 2 and 3);
// * one warp per (candidate, 32 lanes): the warp stages the candidate's
//   lines of nonzero weight in shared memory, compacted in line order, so
//   weight-0 lines cost nothing and line data is loaded once per warp;
// * 32-bit probes: trunc of a coordinate in [0, 2^23) by one rounded-
//   toward-zero add, the offset inside the line's slice in 32 bits, the
//   64-bit slice base once per line.  When any probe of a group leaves its
//   slice (or names no slice), the warp takes the exact 64-bit flat index
//   and clamp of the plain version, so x = -1 still wraps into the
//   previous row and a row past the end into the next slice;
// * the probes of 4 lines are issued before any is summed (8 gathers in
//   flight per thread, at most 64 registers: 8 blocks an SM); the sum
//   still runs in line order.
#include <cuda_runtime.h>

#include <cstdint>

#include "window_common.cuh"

namespace {

using namespace fdcm;

constexpr int kWarps = 4;         // warps per block
constexpr int kPos = 64;          // two-sided: lane k < 64 is m = +k, else -(k - 63)
constexpr int kGroup = 4;         // lines whose probes are in flight together

// the exact probe: the flat row-major index clamped to the stack, then
// moved to the layout read
template <int kLayout>
__device__ long long exact_index(int s, float px, float py, int h, int w,
                                 long long len, unsigned tw,
                                 long long slice_len) {
  long long f = (long long)s * h * w + trunc64(py) * w + trunc64(px);
  f = min(max(f, 0LL), len - 1);
  return layout_index<kLayout>(f, h, w, tw, slice_len);
}

template <int kLayout>
__global__ void __launch_bounds__(kWarps * 32, 8)
window_kernel(const float* __restrict__ src, long long li_len,
              const float4* __restrict__ ep,
              const int* __restrict__ sid, const float* __restrict__ wt,
              const float2* __restrict__ tr, const float2* __restrict__ v,
              const float* __restrict__ t0, float* __restrict__ out,
              long long m_count, int n_lines, int count, int two_sided, int h,
              int w, unsigned tw, long long slice_len) {
  __shared__ float4 s_ep[kWarps][32];
  __shared__ float s_wt[kWarps][32];
  __shared__ int s_sid[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (count + 31) >> 5;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= m_count * chunks) return;  // whole warps; no block barrier below
  const long long c = u / chunks;
  const int k_out = (int)(u - c * chunks) * 32 + lane;
  const int k = min(k_out, count - 1);  // idle lanes repeat the last lane
  const float step = (two_sided && k >= kPos) ? (float)(-(k - (kPos - 1)))
                                              : (float)k;
  const float m = __fadd_rn(t0[c], step);
  const float2 trc = tr[c], vc = v[c];
  const float trx = __fadd_rn(trc.x, __fmul_rn(m, vc.x));
  const float try_ = __fadd_rn(trc.y, __fmul_rn(m, vc.y));
  const int n_slices = (int)(li_len / ((long long)h * w));

  float acc = 0.0f;
  for (int l0 = 0; l0 < n_lines; l0 += 32) {
    // stage this chunk's lines of nonzero weight, in line order
    const int j = l0 + lane;
    const long long cl = c * n_lines + j;
    const float wl = j < n_lines ? wt[cl] : 0.0f;
    const bool live = wl != 0.0f;  // NaN counts, as in the plain version
    const unsigned mask = __ballot_sync(kFull, live);
    if (live) {
      const int pos = __popc(mask & ((1u << lane) - 1u));
      s_ep[warp][pos] = ep[cl];
      s_wt[warp][pos] = wl;
      s_sid[warp][pos] = sid[cl];
    }
    __syncwarp();
    const int n = __popc(mask);
    for (int g = 0; g < n; g += kGroup) {
      const int gn = min(kGroup, n - g);
      unsigned x1[kGroup], y1[kGroup], x2[kGroup], y2[kGroup];
      bool inside = true;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i < gn) {
          const float4 e = s_ep[warp][g + i];
          x1[i] = trunc_u(__fadd_rn(e.x, trx));
          y1[i] = trunc_u(__fadd_rn(e.y, try_));
          x2[i] = trunc_u(__fadd_rn(e.z, trx));
          y2[i] = trunc_u(__fadd_rn(e.w, try_));
          inside = inside && (unsigned)s_sid[warp][g + i] < (unsigned)n_slices &&
                   x1[i] < (unsigned)w && y1[i] < (unsigned)h &&
                   x2[i] < (unsigned)w && y2[i] < (unsigned)h;
        }
      }
      float a[kGroup], b[kGroup];
      if (__all_sync(kFull, inside)) {
        // common path: 32-bit offsets inside each line's slice
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < gn) {
            const float* base = src + (long long)s_sid[warp][g + i] * slice_len;
            a[i] = __ldg(base + slice_offset<kLayout>(x1[i], y1[i], w, tw));
            b[i] = __ldg(base + slice_offset<kLayout>(x2[i], y2[i], w, tw));
          }
        }
      } else {
        // a probe leaves its slice: the exact 64-bit flat index and clamp
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < gn) {
            const float4 e = s_ep[warp][g + i];
            const int s = s_sid[warp][g + i];
            a[i] = __ldg(src + exact_index<kLayout>(
                s, __fadd_rn(e.x, trx), __fadd_rn(e.y, try_), h, w, li_len,
                tw, slice_len));
            b[i] = __ldg(src + exact_index<kLayout>(
                s, __fadd_rn(e.z, trx), __fadd_rn(e.w, try_), h, w, li_len,
                tw, slice_len));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (i < gn)
          acc = __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(a[i], b[i])),
                                         s_wt[warp][g + i]));
    }
    __syncwarp();
  }
  if (k_out < count) out[c * count + k_out] = acc;
}

// One thread per 16 output bytes: the four cells of one tile row inside
// one sector.  A warp writes 512 contiguous bytes (four tiles) and reads
// four rows of 32 cells; float4 loads where the cells lie inside a row
// that is 16-byte aligned, else scalar loads.  Padding cells are written
// as 0 and never probed.
__global__ void __launch_bounds__(256)
tile_kernel(const float* __restrict__ li, float4* __restrict__ out,
            long long n_quads, int h, int w, int th, int tw, bool vec) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_quads) return;
  const long long t = o >> 3;  // tile
  const int j = (int)(o & 7);  // quad: sector (j >> 1), row in it (j & 1)
  const long long q = t / ((long long)th * tw);
  const int r = (int)(t - q * th * tw), ty = r / tw, tx = r - ty * tw;
  const int y = ty * 4 + ((j >> 2) << 1) + (j & 1);
  const int x = tx * 8 + (((j >> 1) & 1) << 2);
  const float* row = li + (q * h + y) * (long long)w;
  float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && y < h && x + 4 <= w) {
    val = *reinterpret_cast<const float4*>(row + x);
  } else if (y < h) {
    val.x = x < w ? row[x] : 0.0f;
    val.y = x + 1 < w ? row[x + 1] : 0.0f;
    val.z = x + 2 < w ? row[x + 2] : 0.0f;
    val.w = x + 3 < w ? row[x + 3] : 0.0f;
  }
  out[o] = val;
}

}  // namespace

// tiles: the stack (n_slices, h, w) copied into (n_slices, ceil(h/4),
// ceil(w/8), 32), the layout window_kernel<kTiles> reads.
extern "C" int fdcm_window_tiles(const float* li, float* tiles,
                                 long long n_slices, int h, int w,
                                 cudaStream_t stream) {
  if (n_slices <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int th = (h + 3) / 4, tw = (w + 7) / 8;
  const long long n_quads = n_slices * th * tw * 8;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(li) % 16 == 0;
  tile_kernel<<<(unsigned)((n_quads + 255) / 256), 256, 0, stream>>>(
      li, reinterpret_cast<float4*>(tiles), n_quads, h, w, th, tw, vec);
  return (int)cudaGetLastError();
}

// tiles == nullptr: read the row-major stack li; else read its tiled copy.
extern "C" int fdcm_window(const float* li, long long li_len,
                           const float* tiles, const float* ep, const int* sid,
                           const float* wt, const float* tr, const float* v,
                           const float* t0, float* out, long long m_count,
                           int n_lines, int count, int two_sided, int h, int w,
                           cudaStream_t stream) {
  const long long hw = (long long)h * w;
  const unsigned tw = (unsigned)((w + 7) / 8);
  const long long tiled = (long long)((h + 3) / 4) * tw * 32;
  if (m_count <= 0 || count <= 0 || n_lines < 0 || h <= 0 || w <= 0 ||
      li_len <= 0 || li_len % hw || li_len / hw > 0x7fffffffLL ||
      tiled >= (1LL << 31) || h >= (1 << 23) || w >= (1 << 23) ||
      (two_sided && count != 2 * kPos))
    return (int)cudaErrorInvalidValue;
  const long long warps = m_count * ((count + 31) / 32);
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const float2* tr2 = reinterpret_cast<const float2*>(tr);
  const float2* v2 = reinterpret_cast<const float2*>(v);
  const float4* ep4 = reinterpret_cast<const float4*>(ep);
  if (tiles)
    window_kernel<kTiles><<<blocks, kWarps * 32, 0, stream>>>(
        tiles, li_len, ep4, sid, wt, tr2, v2, t0, out, m_count, n_lines, count,
        two_sided, h, w, tw, tiled);
  else
    window_kernel<kRows><<<blocks, kWarps * 32, 0, stream>>>(
        li, li_len, ep4, sid, wt, tr2, v2, t0, out, m_count, n_lines, count,
        two_sided, h, w, tw, hw);
  return (int)cudaGetLastError();
}
