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
// beyond 4096 px) rounding can reorder candidates, and the kernel takes the
// scan's minimum over the sources within sqrt(value) + 2 of x, which holds
// every candidate that can round to or below the winner.
//
// Canvases with a side above 16384 (the column-pass distance g enters the
// envelope squared, so a tall canvas counts too) run the same kernel on
// Wide arithmetic (fdcm_minplus_rows_wide): 64-bit keys and costs, 128-bit
// cross products, 64-bit scratch entries (s and g_s as two 32-bit halves),
// and a scan radius sqrt(value) + 2 widened by sqrt(value) / 2^22, which
// covers the candidates' rounding at any value; d^2 rounds through double
// as the band scan's Python scalar does (the same f32 wherever d^2 < 2^53).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPitch = kWarp + 1;  // tile row pitch: conflict-free columns
constexpr float kF32Max = 3.402823466e+38f;
constexpr int kExact = 1 << 24;    // f32 integers below this are exact
constexpr int kMaxSide = 16384;    // |N| and f stay below 2^29 in int32

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

// One candidate of the band scan: fl(fl(g^2) + fl(d^2)).
template <class A>
__device__ __forceinline__ float scan_value(float gs, int d) {
  float dd;
  if constexpr (A::kWide) {
    dd = __double2float_rn(__ll2double_rn((long long)d * d));
  } else {
    const float df = (float)d;
    dd = __fmul_rn(df, df);
  }
  return __fadd_rn(__fmul_rn(gs, gs), dd);
}

// The band scan's minimum at x over the sources within its radius of x.
template <class A>
__device__ __noinline__ float scan_min(const float* __restrict__ grow, int w,
                                       int x, typename A::Key exact) {
  int lo, hi;
  if constexpr (A::kWide) {
    const double root = sqrt((double)exact);
    const long long r = (long long)root + 2 + (long long)(root * 0x1p-22);
    lo = (int)max(0LL, x - r);
    hi = (int)min(w - 1LL, x + r);
  } else {
    const int r = (int)sqrtf((float)exact) + 2;
    lo = max(0, x - r);
    hi = min(w - 1, x + r);
  }
  float best = __int_as_float(0x7f800000);  // +inf
  for (int s = lo; s <= hi; ++s)
    best = min_prop(best, scan_value<A>(__ldg(grow + s), x - s));
  return best;
}

template <class A>
__global__ void __launch_bounds__(kWarp)
edt_rows_kernel(const float* __restrict__ g, float* __restrict__ out,
                typename A::Entry* __restrict__ scratch, long long n, int w,
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
    const float* grow = g + (row0 + (live ? lane : 0)) * w;

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

    // backward: each pixel's parabola, the value, the epilogue
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
            v = exact < kExact ? scan_value<A>((float)gq, x - sq)
                               : scan_min<A>(grow, w, x, exact);
            if (take_sqrt) v = sqrtf(v);
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
  }
}

template <class A>
int launch_rows(const float* g, float* out, typename A::Entry* scratch,
                long long scratch_blocks, long long n, int w, int take_sqrt,
                cudaStream_t stream) {
  if (n <= 0 || w <= 0 || (!A::kWide && w > kMaxSide) || !scratch ||
      scratch_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n + kWarp - 1) / kWarp;
  long long grid = n_blocks < scratch_blocks ? n_blocks : scratch_blocks;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  edt_rows_kernel<A><<<(unsigned)grid, kWarp, 0, stream>>>(g, out, scratch, n,
                                                          w, take_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace

// g, out: (n, w) float32 rows.  scratch: room for scratch_blocks blocks'
// stacks, 32 * w 32-bit words each; the grid is that many blocks at most,
// each taking every scratch_blocks-th group of 32 rows.  Columns of g below
// kMaxSide (w and the values both).
extern "C" int fdcm_minplus_rows(const float* g, float* out, uint32_t* scratch,
                                 long long scratch_blocks, long long n, int w,
                                 int take_sqrt, cudaStream_t stream) {
  return launch_rows<Narrow>(g, out, scratch, scratch_blocks, n, w, take_sqrt,
                             stream);
}

// As fdcm_minplus_rows on Wide arithmetic, for any side: scratch entries of
// 64 bits.
extern "C" int fdcm_minplus_rows_wide(const float* g, float* out,
                                      unsigned long long* scratch,
                                      long long scratch_blocks, long long n,
                                      int w, int take_sqrt,
                                      cudaStream_t stream) {
  return launch_rows<Wide>(g, out, scratch, scratch_blocks, n, w, take_sqrt,
                           stream);
}
