// Kernel K3: DT3 orientation propagation, in place.  Per pixel, the
// reference's sequential schedule dt3[c2] = min(dt3[c2], dt3[c1] + w) over
// the step list (dt3cpu.cpp:77-107), one rounded add and one min per step,
// in order -- bit-identical to the unrolled chain.
//
// Replaces openfdcm_tpu/ops/prop_kernel.py::propagate_orientation_tpu
// (Pallas _prop_kernel, which holds (D, 16, W) tiles in VMEM).
//
// What bounds it on the H100: device memory -- one read and one write of
// the (S, D, H, W) stack (2 x 49 MB per 30 x 640^2 scene) against 3-4 D
// add/min pairs per pixel.  Reaching the memory rate needs many bytes in
// flight per SM: a thread that loads its depth vector one value after
// another keeps about one load in flight.  So each thread issues all the
// loads of its pixels' depth vectors at once and keeps them in registers:
// * prop_fixed<D, V>, for the depths the repo uses (12, 30, 60) and the
//   reference's step pattern (forward c-1 -> c for c < ceil(1.5 D), then
//   backward c+1 -> c for c from D down to -floor(1.5 D) + 1, indices mod
//   D): every step index is a compile-time constant, so the vectors live
//   in registers and the weights are kernel parameters (constant bank).
//   V = 2 neighbouring pixels a thread (8-byte loads and stores) where
//   H*W is even and D <= 30; V = 1 otherwise (D = 60 would spill);
// * prop_any, for any other depth <= 96 or step list: the vector in shared
//   memory ([d][thread], conflict-free), loads and stores unrolled by 8 so
//   eight are in flight, step indices and weights kernel parameters.
// Deeper stacks or longer step lists (fdcm_prop_table) read the steps from
// a device table (int32 c1, c2 and the f32 weights' bits, one row each):
// * prop_shared, while 32 threads' vectors fit the block's opt-in shared
//   memory (1816 orientations in the H100's 227 KB): prop_any's layout and
//   loads, the block as wide as the shared memory allows (a multiple of
//   32, at most 128 threads);
// * prop_global, beyond that: each thread applies the steps in place to
//   its pixel's vector in device memory (a simple kernel, no reuse but
//   the caches').
// The update is in place: each thread reads its pixels' D values before it
// writes any, and no two threads share a pixel.  Loads and stores are
// coalesced along the pixel axis.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 96;
constexpr int kMaxSteps = 4 * kMaxDepth;

struct Steps {  // passed by value: read from the constant bank
  float w[kMaxSteps];
  unsigned char c1[kMaxSteps], c2[kMaxSteps];
};

__device__ __forceinline__ float min_prop(float a, float b) {
  return (b < a || b != b) ? b : a;  // torch.minimum: NaN propagates
}

__host__ __device__ constexpr int mod(int a, int d) { return ((a % d) + d) % d; }
__host__ __device__ constexpr int forward_steps(int d) { return (3 * d + 1) / 2; }
__host__ __device__ constexpr int backward_steps(int d) { return d + 3 * d / 2; }

template <int D, int V>
__global__ void __launch_bounds__(kThreads)
prop_fixed(float* __restrict__ stack, const Steps s, long long hw,
           long long total) {
  using vec = typename std::conditional<V == 2, float2, float>::type;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;  // total: stacks x hw / V pixel groups
  const long long hv = hw / V, st = p / hv;
  vec* px = reinterpret_cast<vec*>(stack + st * D * hw) + (p - st * hv);
  float v[V][D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const vec x = px[d * hv];
    if constexpr (V == 2) {
      v[0][d] = x.x;
      v[1][d] = x.y;
    } else {
      v[0][d] = x;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int c = 0; c < forward_steps(D); ++c) {
      const int a = mod(c - 1, D), b = mod(c, D);
      v[j][b] = min_prop(v[j][b], __fadd_rn(v[j][a], s.w[c]));
    }
#pragma unroll
    for (int i = 0; i < backward_steps(D); ++i) {
      const int a = mod(D - i + 1, D), b = mod(D - i, D);
      v[j][b] = min_prop(v[j][b], __fadd_rn(v[j][a], s.w[forward_steps(D) + i]));
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if constexpr (V == 2)
      px[d * hv] = make_float2(v[0][d], v[1][d]);
    else
      px[d * hv] = v[0][d];
  }
}

__global__ void __launch_bounds__(kThreads)
prop_any(float* __restrict__ stack, const Steps s, int nsteps, int depth,
         long long hw, long long total) {
  extern __shared__ float vec[];  // [depth][blockDim.x]
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;  // no block-wide barrier below
  const long long st = p / hw;
  float* px = stack + st * depth * hw + (p - st * hw);
  float* v = vec + threadIdx.x;
  int d = 0;
  for (; d + 8 <= depth; d += 8) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = px[(d + j) * hw];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[(d + j) * kThreads] = r[j];
  }
  for (; d < depth; ++d) v[d * kThreads] = px[d * hw];
  for (int k = 0; k < nsteps; ++k) {
    const int a = s.c1[k], b = s.c2[k];
    v[b * kThreads] = min_prop(v[b * kThreads], __fadd_rn(v[a * kThreads], s.w[k]));
  }
  for (d = 0; d < depth; ++d) px[d * hw] = v[d * kThreads];
}

// The step table's row k of an (3, nsteps) int32 table: c1, c2, w's bits.
struct StepTable {
  const int* t;
  int n;
  __device__ __forceinline__ int c1(int k) const { return __ldg(t + k); }
  __device__ __forceinline__ int c2(int k) const { return __ldg(t + n + k); }
  __device__ __forceinline__ float w(int k) const {
    return __int_as_float(__ldg(t + 2 * n + k));
  }
};

__global__ void __launch_bounds__(kThreads)
prop_shared(float* __restrict__ stack, const StepTable s, int depth,
            long long hw, long long total) {
  extern __shared__ float vec[];  // [depth][blockDim.x]
  const int nt = blockDim.x;
  const long long p = (long long)blockIdx.x * nt + threadIdx.x;
  if (p >= total) return;  // no block-wide barrier below
  const long long st = p / hw;
  float* px = stack + st * depth * hw + (p - st * hw);
  float* v = vec + threadIdx.x;
  int d = 0;
  for (; d + 8 <= depth; d += 8) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = px[(d + j) * hw];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[(d + j) * nt] = r[j];
  }
  for (; d < depth; ++d) v[d * nt] = px[d * hw];
  for (int k = 0; k < s.n; ++k) {
    const int a = s.c1(k), b = s.c2(k);
    v[b * nt] = min_prop(v[b * nt], __fadd_rn(v[a * nt], s.w(k)));
  }
  for (d = 0; d < depth; ++d) px[d * hw] = v[d * nt];
}

__global__ void __launch_bounds__(kThreads)
prop_global(float* __restrict__ stack, const StepTable s, int depth,
            long long hw, long long total) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const long long st = p / hw;
  float* px = stack + st * depth * hw + (p - st * hw);
  for (int k = 0; k < s.n; ++k) {
    float* dst = px + s.c2(k) * hw;
    *dst = min_prop(*dst, __fadd_rn(px[s.c1(k) * hw], s.w(k)));
  }
}

// true when (c1, c2) is the reference's pattern for depth d
bool reference_pattern(const int* c1, const int* c2, int nsteps, int d) {
  if (nsteps != forward_steps(d) + backward_steps(d)) return false;
  for (int c = 0; c < forward_steps(d); ++c)
    if (c1[c] != mod(c - 1, d) || c2[c] != mod(c, d)) return false;
  for (int i = 0; i < backward_steps(d); ++i) {
    const int k = forward_steps(d) + i;
    if (c1[k] != mod(d - i + 1, d) || c2[k] != mod(d - i, d)) return false;
  }
  return true;
}

}  // namespace

// In place on stack (n_stacks, depth, hw).  Host arrays c1, c2, wt of
// nsteps entries.  Returns a cudaError_t; 1 (cudaErrorInvalidValue) on a
// shape or step list the kernels do not take.
extern "C" int fdcm_prop(float* stack, const int* c1, const int* c2,
                         const float* wt, int nsteps, int depth, long long hw,
                         long long n_stacks, cudaStream_t stream) {
  if (depth <= 0 || depth > kMaxDepth || hw <= 0 || n_stacks <= 0 ||
      nsteps < 0 || nsteps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  Steps s = {};
  for (int k = 0; k < nsteps; ++k) {
    if (c1[k] < 0 || c1[k] >= depth || c2[k] < 0 || c2[k] >= depth)
      return (int)cudaErrorInvalidValue;
    s.w[k] = wt[k];
    s.c1[k] = (unsigned char)c1[k];
    s.c2[k] = (unsigned char)c2[k];
  }
  const long long total = n_stacks * hw;
  const bool fixed = reference_pattern(c1, c2, nsteps, depth);
  const bool pairs = hw % 2 == 0 && reinterpret_cast<uintptr_t>(stack) % 8 == 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const unsigned blocks2 = (unsigned)((total / 2 + kThreads - 1) / kThreads);
  if (fixed && depth == 12 && pairs)
    prop_fixed<12, 2><<<blocks2, kThreads, 0, stream>>>(stack, s, hw, total / 2);
  else if (fixed && depth == 12)
    prop_fixed<12, 1><<<blocks, kThreads, 0, stream>>>(stack, s, hw, total);
  else if (fixed && depth == 30 && pairs)
    prop_fixed<30, 2><<<blocks2, kThreads, 0, stream>>>(stack, s, hw, total / 2);
  else if (fixed && depth == 30)
    prop_fixed<30, 1><<<blocks, kThreads, 0, stream>>>(stack, s, hw, total);
  else if (fixed && depth == 60)
    prop_fixed<60, 1><<<blocks, kThreads, 0, stream>>>(stack, s, hw, total);
  else
    prop_any<<<blocks, kThreads, depth * kThreads * sizeof(float), stream>>>(
        stack, s, nsteps, depth, hw, total);
  return (int)cudaGetLastError();
}


// In place on stack (n_stacks, depth, hw), any depth and step list.  table:
// a device (3, nsteps) int32 table (c1, c2, the weights' f32 bits), indices
// in [0, depth).  shared: 1 for prop_shared, 0 for prop_global.  Returns a
// cudaError_t; 1 (cudaErrorInvalidValue) on a shape prop_shared cannot
// hold in this card's shared memory at 32 threads.
extern "C" int fdcm_prop_table(float* stack, const int* table, int nsteps,
                               int depth, long long hw, long long n_stacks,
                               int shared, cudaStream_t stream) {
  if (depth <= 0 || hw <= 0 || n_stacks <= 0 || nsteps < 0 || !table)
    return (int)cudaErrorInvalidValue;
  const StepTable s = {table, nsteps};
  const long long total = n_stacks * hw;
  if (!shared) {
    prop_global<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(stack, s, depth, hw, total);
    return (int)cudaGetLastError();
  }
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long column = (long long)depth * sizeof(float);
  long long threads = optin / column / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  if (threads < 32) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(threads * column);
  rc = cudaFuncSetAttribute(prop_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  prop_shared<<<(unsigned)((total + threads - 1) / threads), (unsigned)threads,
                bytes, stream>>>(stack, s, depth, hw, total);
  return (int)cudaGetLastError();
}
