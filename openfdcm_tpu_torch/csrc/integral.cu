// Kernel K4: the directional line integrals of a whole (S, D, PH, PW) stack,
// in place, one launch.  Each slice is prefix-summed along its own angle:
// along the major axis, in sweep order (reversed when flip),
//   carry = col + shift(carry, delta),  delta in {-1, 0, +1}, zero fill
// (reference imgproc.h:38-84); a delta outside {-1, +1} acts as 0, as in
// the plain version.
//
// Replaces openfdcm_tpu/ops/integral_kernel.py::sweep_scan_tpu (Pallas
// _kernel, carry VMEM-resident across sweep blocks).
//
// What bounds it on the H100: device memory -- one read and one write of
// the stack (98 MB for a 30 x 640^2 scene).  The sweep is sequential along
// the major axis, so the design removes every barrier from it:
//
// * A slice's shift is the same for all its rows, so a carry follows a path
//   of constant u = y - D_k, D_k the cumulative shift up to sweep position k
//   (inclusive).  Every cell of the slice lies on exactly one path, and a
//   path outside the canvas carries 0 (the zero fill).  One thread owns one
//   path and keeps its carry in a register: at each position it adds the
//   cell to the carry (or to 0 where the path just entered), one __fadd_rn
//   of the same two operands as openfdcm_tpu/core/integral.py::_sweep_scan,
//   so the result is bit-exact.
// * A warp owns 32 neighbouring paths and walks 32 positions at a time: the
//   deltas of the chunk are read once (lane k, coalesced) and prefix-summed
//   with shuffles.  y-major slices (sweep along H) are contiguous along the
//   paths: each lane loads its 32 cells first, then adds.  x-major slices
//   put neighbouring paths a row apart, so the warp stages the chunk's
//   rows (at most 63: 32 paths spread by at most 31) through a shared tile,
//   loading and storing whole 128-byte lines; it stores only the cells of
//   its own paths, so warps never write each other's cells and the update
//   can be in place.
// * One launch covers the stack: block (slice, path block), with a per-slice
//   table (x_major, flip, delta row) -- flipped sweeps take a delta row per
//   scene, since their deltas start at each scene's logical edge.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;               // warps per block, independent
constexpr int kTileRows = 2 * kWarp;    // rows a chunk of 32 paths touches
constexpr int kPitch = kWarp + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int step_of(int d) { return (d == 1) - (d == -1); }

__device__ __forceinline__ int warp_scan(int v, int lane) {  // inclusive
  for (int o = 1; o < kWarp; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = kWarp / 2; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = kWarp / 2; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * kWarp)
sweep_paths_kernel(float* __restrict__ stack, const int* __restrict__ deltas,
                   const int* __restrict__ table, int ph, int pw,
                   int delta_stride) {
  __shared__ float tiles[kWarps][kTileRows * kPitch];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long slice = blockIdx.x;
  const int x_major = table[3 * slice], flip = table[3 * slice + 1];
  const int* dl = deltas + (long long)table[3 * slice + 2] * delta_stride;
  const int rows = x_major ? ph : pw;     // cells across the sweep
  const int n = x_major ? pw : ph;        // sweep positions
  float* img = stack + slice * ph * pw;
  // element (row y, position c): y * pw + c when x_major, else c * pw + y

  // the slice's range of D: paths are u in [-dmax, rows - 1 - dmin]
  int base = 0, dmin = 0x7fffffff, dmax = -0x7fffffff;
  for (int k0 = 0; k0 < n; k0 += kWarp) {
    const int k = k0 + lane;
    const int d = k < n ? step_of(dl[flip ? n - 1 - k : k]) : 0;
    const int dk = base + warp_scan(d, lane);
    if (k < n) {
      dmin = min(dmin, dk);
      dmax = max(dmax, dk);
    }
    base = __shfl_sync(kFull, dk, kWarp - 1);
  }
  dmin = warp_min(dmin);
  dmax = warp_max(dmax);
  const int u0 = -dmax + (blockIdx.y * kWarps + warp) * kWarp;
  if (u0 > rows - 1 - dmin) return;       // warp-uniform: past the last path
  const int u = u0 + lane;
  float* tile = tiles[warp];

  float carry = 0.0f;
  bool prev_in = false;
  base = 0;
  for (int k0 = 0; k0 < n; k0 += kWarp) {
    const int cnt = min(kWarp, n - k0);
    const int k = k0 + lane;
    const int d = k < n ? step_of(dl[flip ? n - 1 - k : k]) : 0;
    const int dk = base + warp_scan(d, lane);     // D at position k0 + lane
    base = __shfl_sync(kFull, dk, kWarp - 1);
    if (!x_major) {
      float v[kWarp];
      unsigned in_mask = 0;
#pragma unroll
      for (int j = 0; j < kWarp; ++j) {
        const int y = u + __shfl_sync(kFull, dk, j);
        const int c = flip ? n - 1 - (k0 + j) : k0 + j;
        const bool in = j < cnt && y >= 0 && y < rows;
        in_mask |= (unsigned)in << j;
        v[j] = in ? img[(long long)c * pw + y] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kWarp; ++j) {
        const bool in = (in_mask >> j) & 1u;
        const int y = u + __shfl_sync(kFull, dk, j);   // every lane shuffles
        if (in) {
          const int c = flip ? n - 1 - (k0 + j) : k0 + j;
          carry = __fadd_rn(v[j], prev_in ? carry : 0.0f);
          img[(long long)c * pw + y] = carry;
        }
        if (j < cnt) prev_in = in;
      }
    } else {
      // the chunk's rows [ylo, yhi] and physical columns [cc0, cc0 + cnt)
      const int dlo = warp_min(k < n ? dk : 0x7fffffff);
      const int dhi = warp_max(k < n ? dk : -0x7fffffff);
      const int ylo = max(0, u0 + dlo);
      const int yhi = min(rows - 1, u0 + kWarp - 1 + dhi);
      const int cc0 = flip ? n - k0 - cnt : k0;
      // D of the position that physical column cc0 + lane holds
      const int dcol = __shfl_sync(kFull, dk, flip ? cnt - 1 - lane : lane);
      __syncwarp();
      if (lane < cnt)
        for (int y = ylo; y <= yhi; ++y)
          tile[(y - ylo) * kPitch + lane] = img[(long long)y * pw + cc0 + lane];
      __syncwarp();
      for (int j = 0; j < cnt; ++j) {
        const int y = u + __shfl_sync(kFull, dk, j);
        const bool in = y >= 0 && y < rows;
        if (in) {
          float* cell = tile + (y - ylo) * kPitch +
                        (flip ? cnt - 1 - j : j);
          carry = __fadd_rn(*cell, prev_in ? carry : 0.0f);
          *cell = carry;
        }
        prev_in = in;
      }
      __syncwarp();
      if (lane < cnt)
        for (int y = ylo; y <= yhi; ++y) {
          const int path = y - dcol;
          if (path >= u0 && path < u0 + kWarp)
            img[(long long)y * pw + cc0 + lane] = tile[(y - ylo) * kPitch + lane];
        }
    }
  }
}

}  // namespace

// stack: (n_slices, ph, pw) float32, updated in place.  deltas: rows of
// delta_stride >= max(ph, pw) int32, indexed by physical position.  table:
// (n_slices, 3) int32 (x_major, flip, delta row).
extern "C" int fdcm_sweep_paths(float* stack, const int* deltas,
                                const int* table, long long n_slices, int ph,
                                int pw, int delta_stride, cudaStream_t stream) {
  if (n_slices <= 0 || n_slices > 0x7fffffffLL || ph <= 0 || pw <= 0 ||
      delta_stride < (ph > pw ? ph : pw))
    return (int)cudaErrorInvalidValue;
  const int per_block = kWarps * kWarp;
  const dim3 grid((unsigned)n_slices, (unsigned)((ph + pw + per_block - 1) / per_block));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  // all of L1 as shared memory: six 34 KB blocks an SM
  const cudaError_t e = cudaFuncSetAttribute(
      sweep_paths_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  sweep_paths_kernel<<<grid, per_block, 0, stream>>>(stack, deltas, table, ph,
                                                     pw, delta_stride);
  return (int)cudaGetLastError();
}
