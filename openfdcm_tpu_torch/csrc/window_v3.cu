// Kernel K6: FDCM window scores, generation 3 (identity-mapped columns).
// Per candidate c and lane k (two-sided pattern m_pat(k)), for each line in
// order[c] with wt != 0, per endpoint (e_maj, e_min), as _kernel_v3's
// endpoint() (window_kernel.py:371-407):
//   c0 = trunc(e_maj + trm); covered steps [m_lo, m_hi] from t0 and tc
//   x window [c0 + s*m_lo, c0 + s*m_hi] clipped to the canvas picks ONE
//   128-column chunk: plain at ls, or 64-rolled when the window crosses a
//   multiple of 128; x0a is the chunk's first canvas column
//   y0a = 8-aligned row band start from the window's end rows
//   li = clip(-(x0a - c0) + s*(m_pat + t0), 0, 127)   (lane -> chunk column)
//   m_col = s*(x0a - c0 + li)                         (step at that column)
//   row = y0a + clip(trunc(e_min + (trn + m_col*vy)) - y0a, 0, 31)
//   v = LI at (row, (x0a + li) mod Q), transposed for y-major candidates
//   out = sum, in order, of |v(p2) - v(p1)| * wt
// Floor division where the operand can be negative, as JAX's // does;
// __fmul_rn/__fadd_rn everywhere (no FMA contraction, as on the TPU).
//
// Replaces openfdcm_tpu/ops/window_kernel.py::window_scores_device_v3
// (Pallas _kernel_v3: a sorted item stream, the plain and 64-rolled slice
// (or their transposes) DMA'd into VMEM, one sublane gather per 8-row chunk
// and one lane gather per endpoint).  The four stack copies of
// prep_dt3_banks are index arithmetic here: (x0a + li) mod Q is the rolled
// column, swapped row/column the transpose.
//
// What bounds it on the H100: as K1, the L1 tag lookups of its gathers (one
// per distinct 128-byte line a warp's 32 probes touch) and, before this
// design, instruction issue: one thread per (candidate, lane) redid the
// chunk and band choice per (lane, line, endpoint) in 64-bit integers, with
// a 64-bit modulo by Q, and walked order -> wt -> ep, sid as a dependent
// load chain for every line, weight-0 lines included.  The design, K1's:
// * one warp per (candidate, 32 lanes).  The warp walks order 32 lines at a
//   time; each lane loads one line, and a ballot compacts the lines of
//   nonzero weight (NaN counts) into shared memory in order's order;
// * while it stages, each lane computes its line's lane-independent part
//   once, per endpoint: x0a, off = x0a - c0, y0a and e_min.  Per lane only
//   the chunk column li, m_col, the row and the column are left, in 32-bit
//   integers: col = x0a + li < 2Q, so one conditional subtract replaces
//   the modulo, and the row is clamped in f32 before one rounded-toward-
//   zero truncation (clamp_trunc), which gives the same pixel;
// * 32-bit probes: row and column lie in the slice by construction, so the
//   offset inside the line's slice is 32-bit and the 64-bit slice base is
//   added once per line.  A slice id outside the stack takes the exact
//   64-bit flat index and clamp of the plain version (jnp.take's clip);
// * the probes of 4 lines are in flight before any is summed; the sum still
//   runs in order;
// * window_v3_kernel<kTiles> reads K1's tiled copy of the stack (8 x 4
//   tiles), where a warp's 32 probes along a y-major candidate's column
//   touch about 8 cache lines instead of 32; <kRows> reads the stack.
#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace fdcm;

constexpr int kWarps = 4;     // warps per block
constexpr int kPos = 64;      // lane k < 64 is m_pat = +k, else -(k - 63)
constexpr int kChunk = 128;
constexpr int kBand = 32;
constexpr int kGroup = 4;     // lines whose probes are in flight together

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(a / b) for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// One endpoint's lane-independent part, staged once per line: {x0a, off =
// x0a - c0, y0a as f32 bits, e_min as f32 bits}.
__device__ __forceinline__ int4 stage_end(float em, float en, float trm,
                                          float trn, float vy, int s,
                                          long long m_lo, long long m_hi,
                                          int q) {
  const long long c0 = trunc64(__fadd_rn(em, trm));
  const long long xa = c0 + s * m_lo, xb = c0 + s * m_hi;
  const long long x_lo = clampll(min(xa, xb), 0, q - 1);
  const long long x_hi = clampll(max(xa, xb), 0, q - 1);
  const bool crossing = (x_lo / kChunk) != (x_hi / kChunk);
  long long ls = crossing ? floordiv(x_lo - 64, kChunk) * kChunk
                          : (x_lo / kChunk) * kChunk;
  ls = clampll(ls, 0, q - kChunk);
  const long long x0a = ls + (crossing ? 64 : 0);
  const long long ya = trunc64(
      __fadd_rn(en, __fadd_rn(trn, __fmul_rn((float)m_lo, vy))));
  const long long yb = trunc64(
      __fadd_rn(en, __fadd_rn(trn, __fmul_rn((float)m_hi, vy))));
  const long long y_lo = clampll(min(ya, yb), 0, q - 1);
  const long long y0a = clampll((y_lo / 8) * 8, 0, q - kBand);
  return make_int4((int)x0a, (int)(x0a - c0), __float_as_int((float)y0a),
                   __float_as_int(en));
}

// The lane's pixel (x, y) of a staged endpoint in its slice: p_lane =
// s*(m_pat + t0).  x-major candidates read (row, col), y-major (col, row).
__device__ __forceinline__ void probe_xy(int4 e, int p_lane, int s, float trn,
                                         float vy, bool xm, unsigned q,
                                         unsigned& x, unsigned& y) {
  const int li = min(max(p_lane - e.y, 0), kChunk - 1);
  const int m_col = s * (e.y + li);
  const float y0a = __int_as_float(e.z);
  const unsigned row = clamp_trunc(
      __fadd_rn(__int_as_float(e.w), __fadd_rn(trn, __fmul_rn((float)m_col, vy))),
      y0a, __fadd_rn(y0a, (float)(kBand - 1)));
  unsigned col = (unsigned)(e.x + li);
  col = col >= q ? col - q : col;
  x = xm ? col : row;
  y = xm ? row : col;
}

template <int kLayout>
__global__ void __launch_bounds__(kWarps * 32, 8)
window_v3_kernel(const float* __restrict__ src, long long li_len,
                 const float4* __restrict__ ep, const int* __restrict__ sid,
                 const float* __restrict__ wt, const int* __restrict__ order,
                 const float4* __restrict__ geo, const float* __restrict__ t0,
                 const int* __restrict__ tc, const int* __restrict__ x_major,
                 float* __restrict__ out, long long m_count, int n_lines,
                 int two_sided, int q, unsigned tw, long long slice_len) {
  __shared__ int4 s_e1[kWarps][32], s_e2[kWarps][32];
  __shared__ float s_wt[kWarps][32];
  __shared__ int s_sid[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int count = two_sided ? 2 * kPos : kPos;
  const int chunks = count >> 5;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= m_count * chunks) return;  // whole warps; no block barrier below
  const long long c = u / chunks;
  const int k = (int)(u - c * chunks) * 32 + lane;
  const float4 g = geo[c];  // vx, vy, trm, trn
  const int s = g.x < 0.0f ? -1 : 1;
  const long long t0c = trunc64(t0[c]);
  const long long m_lo = t0c - (two_sided ? tc[c] : 0), m_hi = t0c + tc[c];
  const int m_pat = k >= kPos ? -(k - (kPos - 1)) : k;
  const int p_lane = s * (m_pat + (int)t0c);
  const bool xm = x_major[c] != 0;
  const long long qq = (long long)q * q;
  const int n_slices = (int)(li_len / qq);

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
      const float4 e = ep[cl];  // maj p1, min p1, maj p2, min p2
      s_e1[warp][pos] = stage_end(e.x, e.y, g.z, g.w, g.y, s, m_lo, m_hi, q);
      s_e2[warp][pos] = stage_end(e.z, e.w, g.z, g.w, g.y, s, m_lo, m_hi, q);
      s_wt[warp][pos] = wl;
      s_sid[warp][pos] = sid[cl];
    }
    __syncwarp();
    const int n = __popc(mask);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const int gn = min(kGroup, n - g0);
      float a[kGroup], b[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i < gn) {
          unsigned x1, y1, x2, y2;
          probe_xy(s_e1[warp][g0 + i], p_lane, s, g.w, g.y, xm, (unsigned)q,
                   x1, y1);
          probe_xy(s_e2[warp][g0 + i], p_lane, s, g.w, g.y, xm, (unsigned)q,
                   x2, y2);
          const int sl = s_sid[warp][g0 + i];
          const float *p1, *p2;
          if ((unsigned)sl < (unsigned)n_slices) {
            // common path: 32-bit offsets inside the line's slice
            const float* base = src + (long long)sl * slice_len;
            p1 = base + slice_offset<kLayout>(x1, y1, q, tw);
            p2 = base + slice_offset<kLayout>(x2, y2, q, tw);
          } else {
            // a slice id outside the stack: the exact flat index, clamped
            const long long f1 = (long long)sl * qq + (long long)y1 * q + x1;
            const long long f2 = (long long)sl * qq + (long long)y2 * q + x2;
            p1 = src + layout_index<kLayout>(clampll(f1, 0, li_len - 1), q, q,
                                             tw, slice_len);
            p2 = src + layout_index<kLayout>(clampll(f2, 0, li_len - 1), q, q,
                                             tw, slice_len);
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
extern "C" int fdcm_window_v3(const float* li, long long li_len,
                              const float* tiles, const float* ep,
                              const int* sid, const float* wt,
                              const int* order, const float* geo,
                              const float* t0, const int* tc,
                              const int* x_major, float* out,
                              long long m_count, int n_lines, int two_sided,
                              int q, cudaStream_t stream) {
  const long long qq = (long long)q * q;
  const unsigned tw = (unsigned)(q / 8);
  if (m_count <= 0 || n_lines < 0 || li_len <= 0 || q < kChunk ||
      q % kChunk || qq >= (1LL << 31) || li_len % qq ||
      li_len / qq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long warps = m_count * ((two_sided ? 2 * kPos : kPos) / 32);
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const float4* ep4 = reinterpret_cast<const float4*>(ep);
  const float4* geo4 = reinterpret_cast<const float4*>(geo);
  // q is a multiple of 128: the tiled slice has no padding, qq floats
  if (tiles)
    window_v3_kernel<kTiles><<<blocks, kWarps * 32, 0, stream>>>(
        tiles, li_len, ep4, sid, wt, order, geo4, t0, tc, x_major, out,
        m_count, n_lines, two_sided, q, tw, qq);
  else
    window_v3_kernel<kRows><<<blocks, kWarps * 32, 0, stream>>>(
        li, li_len, ep4, sid, wt, order, geo4, t0, tc, x_major, out, m_count,
        n_lines, two_sided, q, tw, qq);
  return (int)cudaGetLastError();
}
