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
// What bounds it on the H100: two dependent probe gathers per (lane, line)
// from an LI stack about the size of L2 (49 MB per 30 x 640^2 scene):
// gather latency and L2 bandwidth, not FLOPs.  The design is K1's: one
// thread per (candidate, lane), a warp on consecutive lanes of one
// candidate, so the line data (order, endpoints, origins) loads are
// broadcasts and neighbouring lanes probe neighbouring pixels of the same
// patch rows.  The patch clamp is two integer clamps; no staging in shared
// memory (the patches of one candidate's lines are scattered over slices).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPos = 64;     // lane k < 64 is m = +k, else -(k - 63)
constexpr int kPatchW = 256;
constexpr int kPatchH = 32;

__device__ __forceinline__ long long trunc_coord(float p) {
  return __float2ll_rz(fminf(fmaxf(p, -16777216.0f), 16777216.0f));
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void window_v2_kernel(const float* __restrict__ li,
                                 long long li_len,
                                 const float4* __restrict__ ep,
                                 const int4* __restrict__ org,
                                 const int* __restrict__ sid,
                                 const float* __restrict__ wt,
                                 const int* __restrict__ order,
                                 const float4* __restrict__ geo,
                                 const float* __restrict__ t0,
                                 const int* __restrict__ x_major,
                                 float* __restrict__ out, long long m_count,
                                 int n_lines, int count, int q) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_count * count) return;
  const long long c = t / count;
  const int k = (int)(t - c * count);
  const float lane = k >= kPos ? (float)(-(k - (kPos - 1))) : (float)k;
  const float m = __fadd_rn(t0[c], lane);
  const float4 g = geo[c];  // vx, vy, trm, trn
  const float trx = __fadd_rn(g.z, __fmul_rn(m, g.x));
  const float try_ = __fadd_rn(g.w, __fmul_rn(m, g.y));
  const bool xm = x_major[c] != 0;
  const long long qq = (long long)q * q;
  float acc = 0.0f;
  for (int j = 0; j < n_lines; ++j) {
    const long long cl = c * n_lines + order[c * n_lines + j];
    const float wl = wt[cl];
    if (wl == 0.0f) continue;
    const float4 e = ep[cl];   // maj p1, min p1, maj p2, min p2
    const int4 o = org[cl];    // x0a p1, y0a p1, x0a p2, y0a p2
    const long long base = (long long)sid[cl] * qq;
    const long long maj0 =
        o.x + clampll(trunc_coord(__fadd_rn(e.x, trx)) - o.x, 0, kPatchW - 1);
    const long long mnr0 =
        o.y + clampll(trunc_coord(__fadd_rn(e.y, try_)) - o.y, 0, kPatchH - 1);
    const long long maj1 =
        o.z + clampll(trunc_coord(__fadd_rn(e.z, trx)) - o.z, 0, kPatchW - 1);
    const long long mnr1 =
        o.w + clampll(trunc_coord(__fadd_rn(e.w, try_)) - o.w, 0, kPatchH - 1);
    long long i0 = base + (xm ? mnr0 * q + maj0 : maj0 * q + mnr0);
    long long i1 = base + (xm ? mnr1 * q + maj1 : maj1 * q + mnr1);
    i0 = clampll(i0, 0, li_len - 1);
    i1 = clampll(i1, 0, li_len - 1);
    const float d = fabsf(__fsub_rn(__ldg(li + i1), __ldg(li + i0)));
    acc = __fadd_rn(acc, __fmul_rn(d, wl));
  }
  out[t] = acc;
}

}  // namespace

extern "C" int fdcm_window_v2(const float* li, long long li_len,
                              const float* ep, const int* org, const int* sid,
                              const float* wt, const int* order,
                              const float* geo, const float* t0,
                              const int* x_major, float* out,
                              long long m_count, int n_lines, int count, int q,
                              cudaStream_t stream) {
  if (m_count <= 0 || n_lines < 0 || li_len <= 0 || q < kPatchW ||
      (count != kPos && count != 2 * kPos))
    return (int)cudaErrorInvalidValue;
  const long long threads = m_count * count;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  window_v2_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      li, li_len, reinterpret_cast<const float4*>(ep),
      reinterpret_cast<const int4*>(org), sid, wt, order,
      reinterpret_cast<const float4*>(geo), t0, x_major, out, m_count,
      n_lines, count, q);
  return (int)cudaGetLastError();
}
