// The column pass of the distance transform: along H of a (..., H, W) float
// stack, per column,
//   fwd[y] = fl(y + min_{y' <= y} fl(f[y'] - y'))
//   bwd[y] = fl(-y + min_{y' >= y} fl(f[y'] + y'))
//   out[y] = minimum(fwd[y], bwd[y])
// with torch's NaN rules: a NaN stays in a running minimum (torch.cummin)
// and wins torch.minimum.  It computes what the plain version
// openfdcm_tpu_torch/core/dt.py::_nearest_1d_l1(f, dim=-2) computes, bit for
// bit, for every float32 input: each sum is __fadd_rn/__fsub_rn of the same
// operands, and min is exact.  (The zeros' signs cannot differ either:
// f - y' is -0 only at y' = 0, where fl(0 + m) is +0 as in the plain
// version, and f + y' is never -0.)  On the build's indicators (0 at a
// seed, F32_MAX elsewhere) out is the exact distance to the column's
// nearest seed, or F32_MAX.
//
// Replaces no Pallas kernel: the JAX package runs lax.cummin here, inside
// its XLA program.  In eager PyTorch the plain version is two cummins (each
// writing f32 values and int64 indices), two flips and five elementwise
// passes: about 23 stack-sized passes through device memory, and six
// stack-sized tensors live at once.
//
// What bounds it on the H100: device memory.  The least traffic is one read
// and one write, 8 bytes a pixel (885 MB for a 30 x 1920^2 frame's stack,
// 0.26 ms at 3.35 TB/s).  This kernel reads the stack twice: 12 bytes a
// pixel, and a scratch of 1/kChunk of the stack.
//
// Design.  The backward minimum runs against the order in which the forward
// one, and the output, are made, and a column does not fit on chip, so each
// column is swept twice:
//   1. bottom-up, chunk by chunk of kChunk rows: the running minimum of
//      fl(f + y), stored at each chunk's top into the scratch (one entry a
//      chunk and column, [chunk][column]); the top chunk needs none;
//   2. top-down: a chunk's backward minima, from its bottom row up starting
//      at the next chunk's stored entry, into registers; then the forward
//      minimum carried down through it, and each row's result written over
//      the chunk, over the input when the pass runs in place.
// A block owns a strip of kStrip adjacent columns of one plane, a thread a
// column.  Chunks enter and leave through shared memory in whole rows of the
// strip (256 bytes; 16-byte loads and stores where the width allows), and
// the next chunk is copied in asynchronously (cp.async) while the block
// works on the current one, so each block keeps a chunk in flight.  A
// thread's column of the tile is its own: the threads of a warp read 32
// adjacent words, with no bank conflict.  Strips measured on the card: 64
// columns beat 128 and 256 (more blocks for one frame's 30 planes); chunks
// of 32 beat 16 and 64; the copy in flight beat a synchronous load by 22 %.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // rows of a chunk (ops/columns.py CHUNK)
constexpr int kStrip = 64;   // columns of a block, a thread each

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// one step of torch.cummin: a NaN stays, else the smaller value
__device__ __forceinline__ float scan_min(float m, float x) {
  return !is_nan(m) && (is_nan(x) || x < m) ? x : m;
}

// torch.minimum: NaN if either is
__device__ __forceinline__ float min_nan(float a, float b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return b < a ? b : a;
}

using Tile = float[kChunk][kStrip];

// Start copying rows x nc of src (row stride w) into tile.  vec: 16-byte
// copies of whole strips.
__device__ __forceinline__ void fetch(Tile& tile, const float* src, int rows,
                                      int nc, int w, bool vec) {
  const int t = threadIdx.x;
  if (vec && nc == kStrip) {
    constexpr int q = kStrip / 4;   // 16-byte pieces a row
#pragma unroll
    for (int kk = 0; kk < kChunk * q / kStrip; ++kk) {
      const int k = kk * kStrip + t, r = k / q, j = k % q;
      if (r < rows)
        __pipeline_memcpy_async(&tile[r][4 * j], src + (long long)r * w + 4 * j, 16);
    }
  } else {
    for (int k = t; k < rows * nc; k += kStrip) {
      const int r = k / nc, j = k - r * nc;
      __pipeline_memcpy_async(&tile[r][j], src + (long long)r * w + j, 4);
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ void put(const Tile& tile, float* dst, int rows,
                                    int nc, int w, bool vec) {
  const int t = threadIdx.x;
  if (vec && nc == kStrip) {
    constexpr int q = kStrip / 4;
#pragma unroll
    for (int kk = 0; kk < kChunk * q / kStrip; ++kk) {
      const int k = kk * kStrip + t, r = k / q, j = k % q;
      if (r < rows)
        *reinterpret_cast<float4*>(dst + (long long)r * w + 4 * j) =
            *reinterpret_cast<const float4*>(&tile[r][4 * j]);
    }
  } else {
    for (int k = t; k < rows * nc; k += kStrip) {
      const int r = k / nc, j = k - r * nc;
      dst[(long long)r * w + j] = tile[r][j];
    }
  }
}

// in and out may be one tensor.  suffix: (chunks - 1) x cols entries.
__global__ void __launch_bounds__(kStrip)
column_pass_kernel(const float* in, float* out, float* __restrict__ suffix,
                   long long cols, int h, int w, int strips, bool vec) {
  __shared__ __align__(16) Tile tile[2];
  const int t = threadIdx.x;
  const long long plane = blockIdx.x / strips;
  const int x0 = (int)(blockIdx.x % strips) * kStrip;
  const int nc = min(kStrip, w - x0);
  const long long base = plane * h * w + x0;
  const long long col = plane * w + x0 + t;
  const bool live = t < nc;
  const float inf = __int_as_float(0x7f800000);
  const int chunks = (h + kChunk - 1) / kChunk;
  const auto rows_of = [&](int c) { return min(kChunk, h - c * kChunk); };
  const auto at = [&](int c) { return base + (long long)c * kChunk * w; };

  // 1. bottom-up over chunks chunks-1 .. 1
  float m = inf;
  if (chunks > 1) fetch(tile[0], in + at(chunks - 1), rows_of(chunks - 1), nc, w, vec);
  for (int k = 0; k < chunks - 1; ++k) {
    const int c = chunks - 1 - k;
    if (c > 1) {
      fetch(tile[(k + 1) & 1], in + at(c - 1), rows_of(c - 1), nc, w, vec);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (live) {
      const Tile& v = tile[k & 1];
      const int rows = rows_of(c), y0 = c * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (i < rows) m = scan_min(m, __fadd_rn(v[i][t], (float)(y0 + i)));
      suffix[(long long)(c - 1) * cols + col] = m;
    }
    __syncthreads();   // the tile is free for the fetch after next
  }

  // 2. top-down over every chunk
  float fwd = inf;
  fetch(tile[0], in + at(0), rows_of(0), nc, w, vec);
  for (int c = 0; c < chunks; ++c) {
    float bwd = live && c + 1 < chunks ? suffix[(long long)c * cols + col] : inf;
    if (c + 1 < chunks) {
      fetch(tile[(c + 1) & 1], in + at(c + 1), rows_of(c + 1), nc, w, vec);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    Tile& v = tile[c & 1];
    const int rows = rows_of(c), y0 = c * kChunk;
    if (live) {
      float b[kChunk];
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        if (i < rows) bwd = scan_min(bwd, __fadd_rn(v[i][t], (float)(y0 + i)));
        b[i] = bwd;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < rows) {
          const float y = (float)(y0 + i);
          fwd = scan_min(fwd, __fsub_rn(v[i][t], y));
          v[i][t] = min_nan(__fadd_rn(y, fwd), __fadd_rn(-y, b[i]));
        }
      }
    }
    __syncthreads();
    put(v, out + at(c), rows, nc, w, vec);
    __syncthreads();   // the tile is free for the fetch after next
  }
}

}  // namespace

// The column pass of planes x (h, w); out may be in (in place).  suffix:
// (ceil(h / 32) - 1) * planes * w floats of scratch.
extern "C" int fdcm_column_pass(const float* in, float* out, float* suffix,
                                long long planes, int h, int w,
                                cudaStream_t stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int strips = (w + kStrip - 1) / kStrip;
  const long long blocks = planes * strips;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = w % 4 == 0 && (size_t)in % 16 == 0 && (size_t)out % 16 == 0;
  column_pass_kernel<<<(unsigned)blocks, kStrip, 0, stream>>>(
      in, out, suffix, planes * w, h, w, strips, vec);
  return (int)cudaGetLastError();
}
