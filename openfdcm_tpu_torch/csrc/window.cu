// Kernel K1: FDCM window scores.  Per candidate c and step lane k:
//   m   = t0[c] + lane(k)
//   tr  = scene_tr[c] + m * v[c]                       (rounded, then)
//   p   = e + tr, int-truncated                       (dt3cpu.cpp:151-165)
//   out = sum over lines in line order of wt * |LI[p1] - LI[p2]|
// Every product and sum is __fmul_rn/__fadd_rn: nvcc would otherwise
// contract mul+add into an FMA and move probe pixels by one ulp.  Probe
// indices sid*H*W + y*W + x are clamped to the stack like
// jnp.take(mode="clip"); coordinates are clamped to +-2^24 first, so the
// float->int conversion is defined.
//
// Replaces openfdcm_tpu/ops/window_kernel.py::window_scores_device_v4
// (Pallas _kernel_v4, with its sorted item stream and VMEM slice patches).
//
// What bounds it on the H100: the two dependent probe gathers per (lane,
// line) from the LI stack (49 MB per 30 x 640^2 scene, about the size of
// L2), i.e. gather latency and L2 bandwidth, not FLOPs.  This simple design
// gives each (candidate, lane) one thread that walks the candidate's lines
// in line order; a warp covers consecutive lanes of one candidate, so the
// line data loads are broadcasts and a line's probes along the step ray
// touch neighbouring pixels.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPos = 64;  // two-sided: lane k < 64 is m = +k, else -(k - 63)

__device__ __forceinline__ long long trunc_index(float p) {
  return __float2ll_rz(fminf(fmaxf(p, -16777216.0f), 16777216.0f));
}

__global__ void window_kernel(const float* __restrict__ li, long long li_len,
                              const float4* __restrict__ ep,
                              const int* __restrict__ sid,
                              const float* __restrict__ wt,
                              const float2* __restrict__ tr,
                              const float2* __restrict__ v,
                              const float* __restrict__ t0,
                              float* __restrict__ out, long long m_count,
                              int n_lines, int count, int two_sided, int h,
                              int w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_count * count) return;
  const long long c = t / count;
  const int k = (int)(t - c * count);
  const float lane = (two_sided && k >= kPos) ? (float)(-(k - (kPos - 1)))
                                              : (float)k;
  const float m = __fadd_rn(t0[c], lane);
  const float2 trc = tr[c];
  const float2 vc = v[c];
  const float trx = __fadd_rn(trc.x, __fmul_rn(m, vc.x));
  const float try_ = __fadd_rn(trc.y, __fmul_rn(m, vc.y));
  const long long hw = (long long)h * w;
  float acc = 0.0f;
  for (int l = 0; l < n_lines; ++l) {
    const long long cl = c * n_lines + l;
    const float wl = wt[cl];
    if (wl == 0.0f) continue;
    const float4 e = ep[cl];
    const long long base = (long long)sid[cl] * hw;
    long long i1 = base + trunc_index(__fadd_rn(e.y, try_)) * w +
                   trunc_index(__fadd_rn(e.x, trx));
    long long i2 = base + trunc_index(__fadd_rn(e.w, try_)) * w +
                   trunc_index(__fadd_rn(e.z, trx));
    i1 = min(max(i1, 0LL), li_len - 1);
    i2 = min(max(i2, 0LL), li_len - 1);
    const float d = fabsf(__fsub_rn(__ldg(li + i1), __ldg(li + i2)));
    acc = __fadd_rn(acc, __fmul_rn(d, wl));
  }
  out[t] = acc;
}

}  // namespace

extern "C" int fdcm_window(const float* li, long long li_len, const float* ep,
                           const int* sid, const float* wt, const float* tr,
                           const float* v, const float* t0, float* out,
                           long long m_count, int n_lines, int count,
                           int two_sided, int h, int w, cudaStream_t stream) {
  if (m_count <= 0 || count <= 0 || n_lines < 0 || li_len <= 0 ||
      (two_sided && count != 2 * kPos))
    return (int)cudaErrorInvalidValue;
  const long long threads = m_count * count;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  window_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      li, li_len, reinterpret_cast<const float4*>(ep), sid, wt,
      reinterpret_cast<const float2*>(tr), reinterpret_cast<const float2*>(v),
      t0, out, m_count, n_lines, count, two_sided, h, w);
  return (int)cudaGetLastError();
}
