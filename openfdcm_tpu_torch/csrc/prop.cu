// Kernel K3: DT3 orientation propagation.  Per pixel, the reference's
// sequential schedule dt3[c2] = min(dt3[c2], dt3[c1] + w) over the static
// step list (dt3cpu.cpp:77-107), one rounded add and one min per step, in
// order -- bit-identical to the unrolled chain.
//
// Replaces openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu
// (Pallas _prop_kernel, which holds (D, 16, W) tiles in VMEM).
//
// What bounds it on the H100: device memory -- one read and one write of
// the (S, D, H, W) stack (2 x 49 MB per 30 x 640^2 scene), against 3*D
// add/min pairs per pixel.  One thread per (scene, pixel) keeps its depth
// vector in shared memory (laid out [d][thread], conflict-free), so the
// stack crosses device memory once each way, with loads and stores
// coalesced along the pixel axis.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // depth <= 96: 48 KB of shared memory

__device__ __forceinline__ float min_prop(float a, float b) {
  return (b < a || b != b) ? b : a;
}

__global__ void prop_kernel(const float* __restrict__ in,
                            float* __restrict__ out,
                            const int* __restrict__ c1,
                            const int* __restrict__ c2,
                            const float* __restrict__ wt, int nsteps,
                            int depth, long long hw, long long total) {
  extern __shared__ float vec[];  // [depth][blockDim.x]
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;  // no block-wide barrier below
  const long long stack = p / hw;
  const long long pix = p - stack * hw;
  const long long base = stack * depth * hw + pix;
  float* v = vec + threadIdx.x;
  const int stride = blockDim.x;
  for (int d = 0; d < depth; ++d) v[d * stride] = in[base + d * hw];
  for (int k = 0; k < nsteps; ++k) {
    const int a = __ldg(c1 + k), b = __ldg(c2 + k);
    v[b * stride] = min_prop(v[b * stride],
                             __fadd_rn(v[a * stride], __ldg(wt + k)));
  }
  for (int d = 0; d < depth; ++d) out[base + d * hw] = v[d * stride];
}

}  // namespace

extern "C" int fdcm_prop(const float* in, float* out, const int* c1,
                         const int* c2, const float* wt, int nsteps, int depth,
                         long long hw, long long n_stacks,
                         cudaStream_t stream) {
  if (depth <= 0 || depth > 96 || hw <= 0 || n_stacks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = n_stacks * hw;
  const long long blocks = (total + kThreads - 1) / kThreads;
  prop_kernel<<<(unsigned)blocks, kThreads, depth * kThreads * sizeof(float),
                stream>>>(in, out, c1, c2, wt, nsteps, depth, hw, total);
  return (int)cudaGetLastError();
}
