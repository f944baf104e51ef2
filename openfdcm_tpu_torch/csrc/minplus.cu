// Kernel K2: the exact L2^2 / L2 row pass of the distance transform,
//   out[r, x] = min_s (g[r, s]^2 + (x - s)^2)  over columns s with g < F32_MAX,
// F32_MAX for a row without such a column, and for L2 the IEEE square root
// of every finite value.  g holds column-pass distances: integers in [0, H).
//
// Replaces openfdcm_tpu/ops/minplus_kernel.py::minplus_rows_banded (Pallas
// _kernel) together with the row-direction L1 transform that fed its band.
//
// What bounds it on the H100: device memory -- one read of g and one write
// of out, 8 bytes a pixel (98 MB for a 30 x 640^2 scene).  The arithmetic is
// O(W) per row but sequential along it, so the design is about latency:
//
// * One thread per row, one warp per block.  Forward over the row: the
//   Felzenszwalb-Huttenlocher lower envelope of the finite sources (seedless
//   columns are skipped).  Every test is exact integer arithmetic: the top
//   parabola s_q leaves the stack when its intersection with u lies at or
//   left of its intersection with s_{q-1}, i.e. Meijster's
//   Sep(s_q, u) <= Sep(s_{q-1}, s_q) with the two divisions cross-multiplied
//   away,
//     N(s_q, u) * (s_q - s_{q-1}) <= N(s_{q-1}, s_q) * (u - s_q),
//     N(i, u) = u^2 + g_u^2 - i^2 - g_i^2   (|N| < 2^29, products in int64),
//   so no divide sits on the dependent chain and no rounding can hand a
//   pixel to the wrong parabola.  Backward, x from W-1 down, the pointer
//   moves down while f(x, s_{q-1}) <= f(x, s_q), f(x, s) = (x-s)^2 + g_s^2.
// * Rows in flight set the speed, since each row is one long dependent
//   chain.  A row's stack can hold W entries, so in shared memory (4 W bytes
//   a row) it would leave 2 warps an SM at W = 640, and the chains could not
//   hide each other's latency.
//   The stacks live in a device scratch buffer instead, one region per
//   resident block, laid out [entry][lane] so a warp's pushes at equal depth
//   share a line; the hot top entries stay in L1/L2, the top two ride in
//   registers, and 32 warps an SM fit.  (s, g_s) are the halves of one
//   32-bit word.
// * Rows enter and leave through a 32 x 33 shared tile per warp: every
//   global load and store of g and out is a whole 128-byte line although
//   each thread owns a row.
//
// Exactness against the band scan it replaces: the value written is the
// winner's fl(fl(g^2) + fl(d^2)), as the scan computes each candidate.  When
// the winner's exact value is below 2^24 every candidate at or below it is
// an exact integer, so the scan's minimum is that value, bit for bit.
// Otherwise (a pixel 4096 px or more from its nearest source, on canvases
// beyond 4096 px) rounding can reorder candidates, and the value is the
// scan's minimum over the sources within sqrt(value) + 2 of x, which holds
// every candidate that can round to or below the winner.
//
// The far pixels' scan is a pass of its own (edt_far_kernel).  Inline, each
// far pixel's band (thousands of sources on an 8K or wider canvas) sat on
// its row's single-thread chain: 34 warps on 132 SMs for a 16,400 x 1,080
// canvas.  Now the envelope writes a far pixel's band radius into out as a
// mark (the sign bit over the radius: a real value never has the sign bit)
// and lists the row once (a warp-aggregated atomic); the far pass takes one
// listed row a block, stages its fl(g^2) in shared memory (rows up to
// kFarStaged px; wider ones read g through the cache), and spreads each
// marked pixel's band over a warp, lanes striding the sources, a shuffle
// reduction with the same NaN-propagating min at the end.  The candidates
// and each one's value are the inline scan's; no NaN can arise (g^2 is
// finite or inf, d^2 finite), so their minimum does not depend on order and
// the result is bit-equal.  What bounds the far pass is its arithmetic:
// about 5 operations a band candidate.  With no far pixel (every canvas up
// to 4096 px) it reads the row count and returns.
//
// Canvases with a side above 16384 (the column-pass distance g enters the
// envelope squared, so a tall canvas counts too) run the same kernel on
// Wide arithmetic (fdcm_minplus_rows_wide): 64-bit keys and costs, 128-bit
// cross products, 64-bit scratch entries (s and g_s as two 32-bit halves),
// and a scan radius sqrt(value) + 2 widened by sqrt(value) / 2^22, which
// covers the candidates' rounding at any value; d^2 rounds through double
// as the band scan's Python scalar does (the same f32 wherever d^2 < 2^53).
// The far pass rounds d^2 in f32 on rows up to 2^24 px: there |d| < 2^24,
// so (float)d is exact and __fmul_rn rounds the exact d^2 once, as the
// exact int64 d^2, converted to double without rounding (d^2 < 2^53), then
// to float, does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPitch = kWarp + 1;  // tile row pitch: conflict-free columns
constexpr float kF32Max = 3.402823466e+38f;
constexpr int kExact = 1 << 24;    // f32 integers below this are exact
constexpr int kMaxSide = 16384;    // |N| and f stay below 2^29 in int32
constexpr unsigned kMark = 0x80000000u;  // a far pixel's mark: its sign bit
constexpr int kFarThreads = 256;   // the far pass: 8 warps a row
constexpr int kFarStaged = 28672;  // widest row the far pass stages (112 KB)

// NaN-propagating min, like torch.minimum.
__device__ __forceinline__ float min_prop(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// The envelope's arithmetic: keys and costs, their cross products, a
// scratch entry.  Narrow: |N| and f below 2^29 (sides <= kMaxSide).
struct Narrow {
  using Key = int;
  using Prod = long long;
  using Entry = uint32_t;
  using Pos = int;  // a stack entry's offset, q * kWarp
  static constexpr bool kWide = false;
  __device__ static __forceinline__ void unpack(Entry e, int& s, int& gs) {
    s = (int)(e & 0xffffu);
    gs = (int)(e >> 16);
  }
  __device__ static __forceinline__ Entry pack(int s, int gs) {
    return (uint32_t)s | ((uint32_t)gs << 16);
  }
};

// Wide: sides up to 2^31 - 1; keys below 2^63, products in 128 bits.
struct Wide {
  using Key = long long;
  using Prod = __int128;
  using Entry = unsigned long long;
  using Pos = long long;
  static constexpr bool kWide = true;
  __device__ static __forceinline__ void unpack(Entry e, int& s, int& gs) {
    s = (int)(uint32_t)e;
    gs = (int)(uint32_t)(e >> 32);
  }
  __device__ static __forceinline__ Entry pack(int s, int gs) {
    return (Entry)(uint32_t)s | ((Entry)(uint32_t)gs << 32);
  }
};

template <class A>
__device__ __forceinline__ typename A::Key cost(int x, int s, int gs) {
  using Key = typename A::Key;
  const Key d = x - s;
  return d * d + (Key)gs * gs;
}

template <class A>
__device__ __forceinline__ typename A::Key key(int s, int gs) {
  using Key = typename A::Key;
  return (Key)s * s + (Key)gs * gs;
}

// fl(d^2) of an offset d as the band scan rounds it: in f32 (exact for
// |d| < 2^24, see the note above), or through double.
template <bool kF32>
__device__ __forceinline__ float square_offset(int d) {
  if constexpr (kF32) {
    const float df = (float)d;
    return __fmul_rn(df, df);
  } else {
    return __double2float_rn(__ll2double_rn((long long)d * d));
  }
}

// One candidate of the band scan: fl(fl(g^2) + fl(d^2)).
template <class A>
__device__ __forceinline__ float scan_value(float gs, int d) {
  return __fadd_rn(__fmul_rn(gs, gs), square_offset<!A::kWide>(d));
}

// The band scan's radius around a pixel whose winner's exact value is
// `exact`, at most w (the band is clipped to the row anyway).
template <class A>
__device__ __forceinline__ unsigned band_radius(typename A::Key exact, int w) {
  long long r;
  if constexpr (A::kWide) {
    const double root = sqrt((double)exact);
    r = (long long)root + 2 + (long long)(root * 0x1p-22);
  } else {
    r = (int)sqrtf((float)exact) + 2;
  }
  return (unsigned)min(r, (long long)w);
}

template <class A>
__global__ void __launch_bounds__(kWarp)
edt_rows_kernel(const float* __restrict__ g, float* __restrict__ out,
                typename A::Entry* __restrict__ scratch,
                unsigned long long* __restrict__ far, long long n, int w,
                int take_sqrt) {
  using Key = typename A::Key;
  using Prod = typename A::Prod;
  using Pos = typename A::Pos;
  __shared__ float tile[kWarp * kPitch];
  const int lane = threadIdx.x;
  // this lane's entry q lives at stack[q * kWarp]
  typename A::Entry* stack = scratch + (size_t)blockIdx.x * w * kWarp + lane;
  const long long n_blocks = (n + kWarp - 1) / kWarp;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long row0 = blk * kWarp;
    const int rows = (int)min((long long)kWarp, n - row0);
    const bool live = lane < rows;

    // forward: the envelope; entries 0..q, top (sq, gq), below it (sp, gp),
    // with their keys s^2 + g^2 (N(i, u) = key(u) - key(i))
    int q = -1, sq = 0, gq = 0, sp = 0, gp = 0;
    Key kq = 0, kp = 0;
    for (int c0 = 0; c0 < w; c0 += kWarp) {
      const int cols = min(kWarp, w - c0);
      __syncwarp();
      if (lane < cols)
        for (int r = 0; r < rows; ++r)
          tile[r * kPitch + lane] = g[(row0 + r) * w + c0 + lane];
      __syncwarp();
      if (live) {
        for (int j = 0; j < cols; ++j) {
          const float gf = tile[lane * kPitch + j];
          if (!(gf < kF32Max)) continue;            // seedless column
          const int u = c0 + j, gu = (int)gf;
          const Key ku = key<A>(u, gu);
          while (q >= 1 && (Prod)(ku - kq) * (sq - sp) <=
                               (Prod)(kq - kp) * (u - sq)) {
            --q;
            sq = sp;
            gq = gp;
            kq = kp;
            if (q >= 1) {
              A::unpack(stack[(Pos)(q - 1) * kWarp], sp, gp);
              kp = key<A>(sp, gp);
            }
          }
          ++q;
          sp = sq;
          gp = gq;
          kp = kq;
          sq = u;
          gq = gu;
          kq = ku;
          stack[(Pos)q * kWarp] = A::pack(u, gu);
        }
      }
    }

    // backward: each pixel's parabola, the value, the epilogue; a far
    // pixel gets its mark and waits for the far pass
    bool has_far = false;
    for (int c0 = ((w - 1) / kWarp) * kWarp; c0 >= 0; c0 -= kWarp) {
      const int cols = min(kWarp, w - c0);
      if (live) {
        for (int j = cols - 1; j >= 0; --j) {
          const int x = c0 + j;
          float v = kF32Max;                         // no finite source
          if (q >= 0) {
            while (q >= 1 && cost<A>(x, sp, gp) <= cost<A>(x, sq, gq)) {
              --q;
              sq = sp;
              gq = gp;
              if (q >= 1) A::unpack(stack[(Pos)(q - 1) * kWarp], sp, gp);
            }
            const Key exact = cost<A>(x, sq, gq);
            if (exact < kExact) {
              v = scan_value<A>((float)gq, x - sq);
              if (take_sqrt) v = sqrtf(v);
            } else {
              v = __uint_as_float(kMark | band_radius<A>(exact, w));
              has_far = true;
            }
          }
          tile[lane * kPitch + j] = v;
        }
      }
      __syncwarp();
      if (lane < cols)
        for (int r = 0; r < rows; ++r)
          out[(row0 + r) * w + c0 + lane] = tile[r * kPitch + lane];
      __syncwarp();
    }

    // list the rows with far pixels: far[0] counts, far[1..] the rows
    const unsigned has = __ballot_sync(0xffffffffu, has_far);
    if (has) {
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(far, (unsigned long long)__popc(has));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (has_far)
        far[1 + base + __popc(has & ((1u << lane) - 1))] =
            (unsigned long long)(row0 + lane);
    }
  }
}

// The band scan's minimum at x over [lo, hi] of the row, one warp: lane l
// takes sources lo + l, lo + l + 32, ...; src holds fl(g^2) (kStaged, in
// shared memory) or g.  No candidate is NaN (g^2 is finite or inf, d^2
// finite), so the minimum does not depend on the order.
template <bool kF32, bool kStaged>
__device__ __forceinline__ float band_min(const float* __restrict__ src, int x,
                                          int lo, int hi, int lane) {
  float best = __int_as_float(0x7f800000);  // +inf
  for (unsigned s = lo + lane; s <= (unsigned)hi; s += kWarp) {
    float g2;
    if constexpr (kStaged) {
      g2 = src[s];
    } else {
      const float gs = __ldg(src + s);
      g2 = __fmul_rn(gs, gs);
    }
    best = min_prop(best, __fadd_rn(g2, square_offset<kF32>(x - (int)s)));
  }
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1)
    best = min_prop(best, __shfl_xor_sync(0xffffffffu, best, o));
  return best;
}

template <bool kF32, bool kStaged>
__device__ void far_rows(const float* __restrict__ g, float* __restrict__ out,
                         const unsigned long long* __restrict__ far, int w,
                         int take_sqrt, float* g2) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const unsigned long long n_far = far[0];
  for (unsigned long long i = blockIdx.x; i < n_far; i += gridDim.x) {
    const long long row = (long long)far[1 + i];
    const float* grow = g + row * w;
    float* orow = out + row * w;
    if constexpr (kStaged) {
      __syncthreads();                       // the previous row is done
      for (int s = threadIdx.x; s < w; s += blockDim.x) {
        const float gs = grow[s];
        g2[s] = __fmul_rn(gs, gs);
      }
      __syncthreads();
    }
    // warps take 32-px chunks of the row in turn; each marked pixel of a
    // chunk is scanned by the whole warp
    for (int c0 = warp * kWarp; c0 < w; c0 += warps * kWarp) {
      const int x = c0 + lane;
      const unsigned bits = x < w ? __float_as_uint(orow[x]) : 0u;
      unsigned marked = __ballot_sync(0xffffffffu, bits & kMark);
      while (marked) {
        const int j = __ffs(marked) - 1;
        marked &= marked - 1;
        const int xj = c0 + j;
        const int r = (int)(__shfl_sync(0xffffffffu, bits, j) & ~kMark);
        const int lo = (int)max(0LL, (long long)xj - r);
        const int hi = (int)min(w - 1LL, (long long)xj + r);
        const float v = band_min<kF32, kStaged>(kStaged ? g2 : grow, xj, lo,
                                                 hi, lane);
        if (lane == 0) orow[xj] = take_sqrt ? sqrtf(v) : v;
      }
    }
  }
}

__global__ void __launch_bounds__(kFarThreads)
edt_far_kernel(const float* __restrict__ g, float* __restrict__ out,
               const unsigned long long* __restrict__ far, int w,
               int take_sqrt) {
  extern __shared__ float g2[];  // the row's fl(g^2), rows <= kFarStaged
  const bool f32 = w <= kExact, staged = w <= kFarStaged;
  if (f32 && staged)
    far_rows<true, true>(g, out, far, w, take_sqrt, g2);
  else if (f32)
    far_rows<true, false>(g, out, far, w, take_sqrt, g2);
  else
    far_rows<false, false>(g, out, far, w, take_sqrt, g2);
}

template <class A>
int launch_rows(const float* g, float* out, typename A::Entry* scratch,
                unsigned long long* far, long long scratch_blocks, long long n,
                int w, int take_sqrt, cudaStream_t stream) {
  if (n <= 0 || w <= 0 || (!A::kWide && w > kMaxSide) || !scratch || !far ||
      scratch_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n + kWarp - 1) / kWarp;
  long long grid = n_blocks < scratch_blocks ? n_blocks : scratch_blocks;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  const cudaError_t rc = cudaMemsetAsync(far, 0, sizeof(*far), stream);
  if (rc != cudaSuccess) return (int)rc;
  edt_rows_kernel<A><<<(unsigned)grid, kWarp, 0, stream>>>(g, out, scratch,
                                                          far, n, w, take_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace

// The envelope pass.  g, out: (n, w) float32 rows.  scratch: room for
// scratch_blocks blocks' stacks, 32 * w 32-bit words each; the grid is that
// many blocks at most, each taking every scratch_blocks-th group of 32
// rows.  Columns of g below kMaxSide (w and the values both).  far: n + 1
// 64-bit words, far[0] zeroed here; the kernel lists the rows holding far
// pixels in far[1..far[0]] and marks those pixels in out for
// fdcm_minplus_far, which must run next on the same stream.
extern "C" int fdcm_minplus_rows(const float* g, float* out, uint32_t* scratch,
                                 unsigned long long* far,
                                 long long scratch_blocks, long long n, int w,
                                 int take_sqrt, cudaStream_t stream) {
  return launch_rows<Narrow>(g, out, scratch, far, scratch_blocks, n, w,
                             take_sqrt, stream);
}

// As fdcm_minplus_rows on Wide arithmetic, for any side: scratch entries of
// 64 bits.
extern "C" int fdcm_minplus_rows_wide(const float* g, float* out,
                                      unsigned long long* scratch,
                                      unsigned long long* far,
                                      long long scratch_blocks, long long n,
                                      int w, int take_sqrt,
                                      cudaStream_t stream) {
  return launch_rows<Wide>(g, out, scratch, far, scratch_blocks, n, w,
                           take_sqrt, stream);
}

// The far pass over the rows an envelope pass listed in far (n rows of w
// in g and out): each marked pixel of out gets the band scan's minimum (its
// square root when take_sqrt).  The grid is as many 256-thread blocks as
// the card holds at once, at most one a row; with no listed row each block
// reads far[0] and returns.
extern "C" int fdcm_minplus_far(const float* g, float* out,
                                const unsigned long long* far, long long n,
                                int w, int take_sqrt, cudaStream_t stream) {
  if (n <= 0 || w <= 0 || !far) return (int)cudaErrorInvalidValue;
  const size_t bytes = w <= kFarStaged ? (size_t)w * sizeof(float) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(edt_far_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edt_far_kernel,
                                                       kFarThreads, bytes);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = n < (long long)sms * per_sm ? n : (long long)sms * per_sm;
  edt_far_kernel<<<(unsigned)grid, kFarThreads, bytes, stream>>>(g, out, far,
                                                                w, take_sqrt);
  return (int)cudaGetLastError();
}
