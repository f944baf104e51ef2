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
// What bounds it on the H100: as K1 and K5, the dependent probe gathers
// from an L2-sized stack; the per-endpoint chunk and band choice is a few
// dozen integer ops per (lane, line), recomputed by each lane instead of
// being staged (the lanes of a warp share the candidate, so every load of
// line data is a broadcast).  One thread per (candidate, lane).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPos = 64;
constexpr int kChunk = 128;
constexpr int kBand = 32;

__device__ __forceinline__ long long trunc_coord(float p) {
  return __float2ll_rz(fminf(fmaxf(p, -16777216.0f), 16777216.0f));
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(a / b) for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct Cand {
  float vy, trm, trn;
  long long s, t0, m_lo, m_hi, m_pat;
  int q;
};

__device__ __forceinline__ long long endpoint_index(const Cand& cd, float em,
                                                    float en, bool xm) {
  const int q = cd.q;
  const long long c0 = trunc_coord(__fadd_rn(em, cd.trm));
  const long long xa = c0 + cd.s * cd.m_lo, xb = c0 + cd.s * cd.m_hi;
  const long long x_lo = clampll(min(xa, xb), 0, q - 1);
  const long long x_hi = clampll(max(xa, xb), 0, q - 1);
  const bool crossing = (x_lo / kChunk) != (x_hi / kChunk);
  long long ls = crossing ? floordiv(x_lo - 64, kChunk) * kChunk
                          : (x_lo / kChunk) * kChunk;
  ls = clampll(ls, 0, q - kChunk);
  const long long x0a = ls + (crossing ? 64 : 0);
  const long long ya = trunc_coord(
      __fadd_rn(en, __fadd_rn(cd.trn, __fmul_rn((float)cd.m_lo, cd.vy))));
  const long long yb = trunc_coord(
      __fadd_rn(en, __fadd_rn(cd.trn, __fmul_rn((float)cd.m_hi, cd.vy))));
  const long long y_lo = clampll(min(ya, yb), 0, q - 1);
  const long long y0a = clampll((y_lo / 8) * 8, 0, q - kBand);
  const long long off = x0a - c0;
  const long long lidx = clampll(-off + cd.s * (cd.m_pat + cd.t0), 0, kChunk - 1);
  const long long m_col = cd.s * (off + lidx);
  const long long ycol = trunc_coord(
      __fadd_rn(en, __fadd_rn(cd.trn, __fmul_rn((float)m_col, cd.vy))));
  const long long row = y0a + clampll(ycol - y0a, 0, kBand - 1);
  const long long col = (x0a + lidx) % q;
  return xm ? row * q + col : col * q + row;
}

__global__ void window_v3_kernel(const float* __restrict__ li,
                                 long long li_len,
                                 const float4* __restrict__ ep,
                                 const int* __restrict__ sid,
                                 const float* __restrict__ wt,
                                 const int* __restrict__ order,
                                 const float4* __restrict__ geo,
                                 const float* __restrict__ t0,
                                 const int* __restrict__ tc,
                                 const int* __restrict__ x_major,
                                 float* __restrict__ out, long long m_count,
                                 int n_lines, int two_sided, int q) {
  const int count = two_sided ? 2 * kPos : kPos;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_count * count) return;
  const long long c = t / count;
  const int k = (int)(t - c * count);
  const float4 g = geo[c];  // vx, vy, trm, trn
  Cand cd;
  cd.vy = g.y;
  cd.trm = g.z;
  cd.trn = g.w;
  cd.s = g.x < 0.0f ? -1 : 1;
  cd.t0 = trunc_coord(t0[c]);
  cd.m_lo = cd.t0 - (two_sided ? tc[c] : 0);
  cd.m_hi = cd.t0 + tc[c];
  cd.m_pat = k >= kPos ? -(k - (kPos - 1)) : k;
  cd.q = q;
  const bool xm = x_major[c] != 0;
  const long long qq = (long long)q * q;
  float acc = 0.0f;
  for (int j = 0; j < n_lines; ++j) {
    const long long cl = c * n_lines + order[c * n_lines + j];
    const float wl = wt[cl];
    if (wl == 0.0f) continue;
    const float4 e = ep[cl];   // maj p1, min p1, maj p2, min p2
    const long long base = (long long)sid[cl] * qq;
    const long long i0 = clampll(base + endpoint_index(cd, e.x, e.y, xm), 0,
                                 li_len - 1);
    const long long i1 = clampll(base + endpoint_index(cd, e.z, e.w, xm), 0,
                                 li_len - 1);
    const float d = fabsf(__fsub_rn(__ldg(li + i1), __ldg(li + i0)));
    acc = __fadd_rn(acc, __fmul_rn(d, wl));
  }
  out[t] = acc;
}

}  // namespace

extern "C" int fdcm_window_v3(const float* li, long long li_len,
                              const float* ep, const int* sid, const float* wt,
                              const int* order, const float* geo,
                              const float* t0, const int* tc,
                              const int* x_major, float* out,
                              long long m_count, int n_lines, int two_sided,
                              int q, cudaStream_t stream) {
  if (m_count <= 0 || n_lines < 0 || li_len <= 0 || q < kChunk || q % kChunk)
    return (int)cudaErrorInvalidValue;
  const long long threads = m_count * (two_sided ? 2 * kPos : kPos);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  window_v3_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      li, li_len, reinterpret_cast<const float4*>(ep), sid, wt, order,
      reinterpret_cast<const float4*>(geo), t0, tc, x_major, out, m_count,
      n_lines, two_sided, q);
  return (int)cudaGetLastError();
}
