// Kernel K4: directional line integral, the sweep scan of one slice.
// Along the major axis, in sweep order (reversed when flip):
//   carry = col + shift(carry, delta),  delta in {-1, 0, +1}, zero fill
// (reference imgproc.h:38-84).  Each output element is one add of the same
// two operands as openfdcm_tpu/core/integral.py::_sweep_scan, so the result
// is bit-exact.
//
// Replaces openfdcm_tpu/ops/integral_kernel.py::sweep_scan_tpu (Pallas
// _kernel, carry VMEM-resident across sweep blocks).
//
// What bounds it on the H100: the sweep is sequential along the major axis
// (640 dependent steps at the pose canvas), so latency and the per-step
// barrier bound it, not bytes (one read and one write of each slice).  One
// block per slice keeps the carry column in shared memory, double-buffered
// so one __syncthreads per step suffices.  Rows ride the threads; on x-major
// slices a step reads a strided column, whose sectors the next steps reuse
// from L1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sweep_kernel(const float* __restrict__ img,
                             float* __restrict__ out,
                             const int* __restrict__ deltas, int rows, int n,
                             long long slice_stride, long long row_stride,
                             long long col_stride, int flip) {
  extern __shared__ float buf[];  // two carry columns of `rows` floats
  float* cur = buf;
  float* nxt = buf + rows;
  const long long off = (long long)blockIdx.x * slice_stride;
  const float* im = img + off;
  float* o = out + off;
  const int* dl = deltas + (long long)blockIdx.x * n;
  for (int y = threadIdx.x; y < rows; y += blockDim.x) cur[y] = 0.0f;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int c = flip ? n - 1 - k : k;
    const int d = dl[c];
    for (int y = threadIdx.x; y < rows; y += blockDim.x) {
      float sh;
      if (d == 1) {
        sh = y > 0 ? cur[y - 1] : 0.0f;
      } else if (d == -1) {
        sh = y < rows - 1 ? cur[y + 1] : 0.0f;
      } else {
        sh = cur[y];
      }
      const long long e = y * row_stride + c * col_stride;
      const float v = __fadd_rn(im[e], sh);
      nxt[y] = v;
      o[e] = v;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

extern "C" int fdcm_sweep(const float* img, float* out, const int* deltas,
                          int g, int rows, int n, long long slice_stride,
                          long long row_stride, long long col_stride, int flip,
                          cudaStream_t stream) {
  if (g <= 0 || rows <= 0 || n <= 0 || rows > 6144)
    return (int)cudaErrorInvalidValue;
  sweep_kernel<<<g, kThreads, 2 * rows * sizeof(float), stream>>>(
      img, out, deltas, rows, n, slice_stride, row_stride, col_stride, flip);
  return (int)cudaGetLastError();
}
