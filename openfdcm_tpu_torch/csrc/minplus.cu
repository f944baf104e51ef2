// Kernel K2: exact L2^2 row pass of the distance transform,
//   out[r, x] = min_s (g2[r, s] + (x - s)^2),  s in [x - R, x + R],
//   R = min(l1[r, x], W).
//
// Replaces openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded (Pallas
// _kernel), which scans 128-column source chunks inside each tile's L1
// radius.  The winning source lies within d_L2 <= d_L1 of its pixel, so the
// per-pixel L1 radius is an exact bound; every value is an integer below
// 2^24 (or inf), so the min is exact in any order.
//
// What bounds it on the H100: the scan, (2R+1) shared-memory reads and
// add/min pairs per pixel -- compute, not device memory (each row is read
// once into shared memory and written once).  Dense seed slices have small
// R; sparse ones scan up to the whole row.  This simple design keeps one
// block per row with the row in shared memory; a linear-time lower envelope
// (Felzenszwalb-Huttenlocher) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// NaN-propagating min, like torch.minimum.
__device__ __forceinline__ float min_prop(float a, float b) {
  return (b < a || b != b) ? b : a;
}

__global__ void minplus_rows_kernel(const float* __restrict__ g2,
                                    const float* __restrict__ l1,
                                    float* __restrict__ out, int w) {
  extern __shared__ float row[];
  const long long base = (long long)blockIdx.x * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) row[x] = g2[base + x];
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int r = (int)fminf(fmaxf(l1[base + x], 0.0f), (float)w);
    const int lo = max(0, x - r);
    const int hi = min(w - 1, x + r);
    float best = __int_as_float(0x7f800000);  // +inf
    for (int s = lo; s <= hi; ++s) {
      const float d = (float)(x - s);
      best = min_prop(best, __fadd_rn(row[s], __fmul_rn(d, d)));
    }
    out[base + x] = best;
  }
}

}  // namespace

extern "C" int fdcm_minplus_rows(const float* g2, const float* l1, float* out,
                                 long long n, int w, cudaStream_t stream) {
  if (n <= 0 || w <= 0 || w > 12288) return (int)cudaErrorInvalidValue;
  minplus_rows_kernel<<<(unsigned)n, kThreads, w * sizeof(float), stream>>>(
      g2, l1, out, w);
  return (int)cudaGetLastError();
}
