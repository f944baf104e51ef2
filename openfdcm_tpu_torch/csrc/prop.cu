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
// flight per SM (Little's law: about 25 KB at 3.35 TB/s over 132 SMs and
// 1 us), and the steps of one pixel form one dependent chain.
// * prop_fixed<D, V>, for the depths the repo uses (12, 30, 60) and the
//   reference's step pattern (forward c-1 -> c for c < ceil(1.5 D), then
//   backward c+1 -> c for c from D down to -floor(1.5 D) + 1, indices mod
//   D): every step index is a compile-time constant, so the vectors live
//   in registers, all of a thread's loads are in flight at once, and the
//   weights are kernel parameters (constant bank).  V = 2 neighbouring
//   pixels a thread (8-byte loads and stores) where H*W is even and
//   D <= 30; V = 1 otherwise (D = 60 would spill).
// * Any other depth or step list runs one relaxation (relax) with each
//   pixel's vector in shared memory ([d][thread], conflict-free) or, past
//   the deepest vector 32 threads hold in shared memory, in device memory.
//   The step list of every build is a chain: step k reads c1[k] == c2[k-1],
//   which step k-1 has just written.  A store -> load -> add -> min -> store
//   round trip through memory at every step made the chain as slow as the
//   memory's latency, so the relaxation carries the last written value in
//   a register and takes it for c1 wherever c1[k] == c2[k-1] (a test on
//   the step list alone, the same for every thread).  The other operands
//   (v[c2[k]], and v[c1[k]] off the chain) are read L steps ahead into
//   registers and each step is fetched L steps before that, L in {1, 2, 4,
//   8} at most the list's least revisit distance (the fewest steps from a
//   write of an index to a later read of it, found by the wrapper on the
//   host), so no read-ahead value can be stale and no read waits on the
//   one before it.
//   - prop_any<L, V>: the steps (<= 384, depth <= 96) a kernel parameter;
//   - prop_shared<L, V, staged>: the steps in a device table (int32 c1, c2
//     and the weights' f32 bits, one row each), depth <= 1816;
//   both stage the steps once per block in shared memory (16 bytes a step:
//   the two offsets into the block's vectors, the weight, the chain flag;
//   where the table does not fit beside the vectors, prop_shared reads it
//   through the read-only cache) and run as many blocks as stay resident,
//   each looping over tiles of pixels.  A thread holds V = 2 neighbouring
//   pixels (float2) where H*W is even, else 1.  Its vector arrives by
//   cp.async, all D loads issued at once: a tile's whole vectors are in
//   flight (92 KB a 64-thread block at depth 180, two blocks an SM), where
//   8 loads a thread (4 KB a 128-thread block) were before; where two
//   vectors of pixel pairs a thread still leave 128 threads an SM, the
//   next tile's loads are in flight while this tile relaxes (plan_tiles).
//   - prop_global<L>: the vector in device memory, the table read as
//     prop_shared reads an unstaged one.  Its traffic is each step's
//     read-ahead load and store, not one read and write a pixel: it stays
//     far from the bound.
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

// ---- the relaxation of one pixel's vector ----------------------------

// One pixel (float) or two neighbouring pixels (float2) a thread.
__device__ __forceinline__ float2 min_prop(float2 a, float2 b) {
  return make_float2(min_prop(a.x, b.x), min_prop(a.y, b.y));
}
__device__ __forceinline__ float add_rn(float a, float w) { return __fadd_rn(a, w); }
__device__ __forceinline__ float2 add_rn(float2 a, float w) {
  return make_float2(__fadd_rn(a.x, w), __fadd_rn(a.y, w));
}
template <int V>
using Pixels = typename std::conditional<V == 2, float2, float>::type;

// A thread's vector: v[c] at p[c * stride] (shared or device memory); with
// kUnit the steps give offsets already scaled by the stride.
template <class T, class Index, bool kUnit = false>
struct Column {
  T* p;
  Index stride;
  __device__ __forceinline__ T& operator[](Index c) const {
    return kUnit ? p[c] : p[c * stride];
  }
};

// A step as the relaxation reads it: the indices (or offsets) of its
// operands, its weight, and whether it is chained (c1 == the previous
// step's c2: its c1 operand is the value just written).
struct Step {
  int i1, i2;
  float w;
  bool chain;
};

// Steps staged in shared memory by a block of nt threads: c1 * nt, c2 * nt
// (offsets into the block's [d][thread] vectors), the weight's bits, the
// chain flag; entries past the list are zeros (never applied).
struct StagedSteps {
  const int4* t;
  __device__ __forceinline__ void get(int k, int /*prev*/, Step& s) const {
    const int4 e = t[k];
    s = {e.x, e.y, __int_as_float(e.z), e.w != 0};
  }
};

__device__ __forceinline__ int4 staged_step(int c1, int c2, float w, bool chain,
                                            int nt) {
  return make_int4(c1 * nt, c2 * nt, __float_as_int(w), chain);
}

// The device table (3, n): c1, c2, the weights' bits; zeros past the list.
// A step is chained when its c1 is prev, the c2 of the step before it.
struct TableSteps {
  const int* t;
  int n;
  __device__ __forceinline__ void get(int k, int prev, Step& s) const {
    if (k < n)
      s = {__ldg(t + k), __ldg(t + n + k), __int_as_float(__ldg(t + 2 * n + k)),
           false};
    else
      s = {0, 0, 0.f, false};
    s.chain = s.i1 == prev;
  }
};

// Apply step k + j of the ring (if kCheck says it exists), then read the
// operands of step k + j + L, whose step sits in next[j], and fetch step
// k + j + 2L into next[j]: the step a round ahead of its operands, so that
// no read waits on the one before it.
template <int L, bool kCheck, class T, class S, class V>
__device__ __forceinline__ void relax_round(const V& v, const S& steps, int n,
                                            int k, Step (&cur)[L],
                                            Step (&next)[L], T (&a)[L],
                                            T (&b)[L], T& carry) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (!kCheck || k + j < n) {
      carry = min_prop(b[j], add_rn(cur[j].chain ? carry : a[j], cur[j].w));
      v[cur[j].i2] = carry;
    }
    cur[j] = next[j];
    b[j] = v[cur[j].i2];
    a[j] = cur[j].chain ? T{} : v[cur[j].i1];
    steps.get(k + j + 2 * L, next[(j + L - 1) % L].i2, next[j]);
  }
}

// The n steps in order on v.  Slot j of the ring holds step k + j's
// operands, read after step k + j - L was applied: valid while L is at most
// the list's least revisit distance.  c1 of a chained step is the carry,
// the value the step before it wrote.
template <int L, class T, class S, class V>
__device__ __forceinline__ void relax(const V& v, const S& steps, int n) {
  Step cur[L], next[L];
  T a[L], b[L];
  int last = -1;  // no step before the first
#pragma unroll
  for (int j = 0; j < L; ++j) {
    steps.get(j, last, cur[j]);
    last = cur[j].i2;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    steps.get(L + j, last, next[j]);
    last = next[j].i2;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    b[j] = v[cur[j].i2];
    a[j] = cur[j].chain ? T{} : v[cur[j].i1];
  }
  T carry = {};
  const int whole = n / L * L;
  for (int k = 0; k < whole; k += L)
    relax_round<L, false>(v, steps, n, k, cur, next, a, b, carry);
  if (whole < n)
    relax_round<L, true>(v, steps, n, whole, cur, next, a, b, carry);
}

template <class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Staged step entries for n steps fetched 2L ahead: whole rounds of L,
// then 2L more.
__host__ __device__ constexpr int staged_entries(int n, int L) {
  return (n + L - 1) / L * L + 2 * L;
}

// The shared-memory kernels' tiles: blockDim.x threads of V pixels at a
// time, each thread's vector into a buffer of vec by cp.async, the
// relaxation, the vector out.  With two buffers (nbuf 2) the next tile's
// loads are in flight while this tile relaxes.  Each thread waits for its
// own copies only: no barrier.  hw and total count pixels.
template <int L, int V, class S, class Col>
__device__ __forceinline__ void shared_tiles(float* __restrict__ stack,
                                             const S& steps, Col col, int nsteps,
                                             int depth, long long hw,
                                             long long total, void* vec,
                                             int nbuf) {
  using T = Pixels<V>;
  const int nt = blockDim.x;
  const long long hv = hw / V, groups = total / V;
  T* const buf0 = reinterpret_cast<T*>(vec) + threadIdx.x;
  T* const buf1 = buf0 + (nbuf - 1) * depth * nt;
  const long long tiles = (groups + nt - 1) / nt;
  auto column = [&](long long p) {
    const long long st = p / hv;
    return reinterpret_cast<T*>(stack) + st * depth * hv + (p - st * hv);
  };
  auto issue = [&](long long tile, T* v) {
    const long long p = tile * nt + threadIdx.x;
    if (tile < tiles && p < groups) {
      const T* px = column(p);
#pragma unroll 8
      for (int d = 0; d < depth; ++d) cp_async(v + d * nt, px + d * hv);
    }
    cp_async_commit();
  };
  bool second = false;
  if (nbuf == 2) issue(blockIdx.x, buf0);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    T* const v = second ? buf1 : buf0;
    if (nbuf == 2) {
      issue(tile + gridDim.x, second ? buf0 : buf1);
      cp_async_wait<1>();
      second = !second;
    } else {
      issue(tile, v);
      cp_async_wait<0>();
    }
    const long long p = tile * nt + threadIdx.x;
    if (p >= groups) continue;
    col.p = v;
    relax<L, T>(col, steps, nsteps);
    T* px = column(p);
#pragma unroll 8
    for (int d = 0; d < depth; ++d) px[d * hv] = v[d * nt];
  }
  cp_async_wait<0>();
}

template <int L, int V>
__global__ void __launch_bounds__(kThreads)
prop_any(float* __restrict__ stack, const Steps s, int nsteps, int depth,
         long long hw, long long total, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];  // steps, vectors
  int4* tab = reinterpret_cast<int4*>(smem);
  const int nt = blockDim.x, staged = staged_entries(nsteps, L);
  for (int k = threadIdx.x; k < staged; k += nt)
    tab[k] = k < nsteps ? staged_step(s.c1[k], s.c2[k], s.w[k],
                                      k > 0 && s.c1[k] == s.c2[k - 1], nt)
                        : make_int4(0, 0, 0, 0);
  __syncthreads();
  shared_tiles<L, V>(stack, StagedSteps{tab}, Column<Pixels<V>, int, true>{},
                     nsteps, depth, hw, total, tab + staged, nbuf);
}

template <int L, int V, bool kStaged>
__global__ void __launch_bounds__(kThreads)
prop_shared(float* __restrict__ stack, const int* __restrict__ table, int nsteps,
            int depth, long long hw, long long total, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];  // [steps,] vectors
  const TableSteps t = {table, nsteps};
  const int nt = blockDim.x;
  if constexpr (kStaged) {
    int4* tab = reinterpret_cast<int4*>(smem);
    const int staged = staged_entries(nsteps, L);
    for (int k = threadIdx.x; k < staged; k += nt) {
      Step e;
      t.get(k, k > 0 && k <= nsteps ? __ldg(table + nsteps + k - 1) : -1, e);
      tab[k] = k < nsteps ? staged_step(e.i1, e.i2, e.w, e.chain, nt)
                          : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    shared_tiles<L, V>(stack, StagedSteps{tab}, Column<Pixels<V>, int, true>{},
                       nsteps, depth, hw, total, tab + staged, nbuf);
  } else {
    shared_tiles<L, V>(stack, t, Column<Pixels<V>, int>{nullptr, nt}, nsteps,
                       depth, hw, total, smem, nbuf);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
prop_global(float* __restrict__ stack, const int* __restrict__ table, int nsteps,
            int depth, long long hw, long long total) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const long long st = p / hw;
  const Column<float, long long> col = {stack + st * depth * hw + (p - st * hw), hw};
  relax<L, float>(col, TableSteps{table, nsteps}, nsteps);
}

// ---- launch ------------------------------------------------------------

// The launch shapes tried, best first: (pixels a thread, buffers a thread).
// Two pixels a thread need an even H*W and an 8-byte aligned stack.  The
// first shape that keeps kMinResident threads an SM resident is taken
// (else the shape that keeps the most): with fewer, the relaxation's chain
// latency, not the memory, sets the time.  Two pixels a thread halve the
// step fetches and address arithmetic a pixel and make each load and
// store 8 bytes (a 64-thread tile reads 512 contiguous bytes a depth);
// two buffers overlap a tile's loads with the tile before it, where they
// leave enough threads (at depth 100 on 640^2, not at depth 180).  One
// pixel a thread (an odd H*W) keeps one buffer: two were slower in a trial
// on the card.
constexpr int kShapes[][2] = {{2, 2}, {2, 1}, {1, 1}};
constexpr int kMinResident = 128;

// A shared-memory kernel's launch: kernel, block width, pixels and buffers
// a thread, dynamic bytes, threads resident an SM.
struct Plan {
  const void* kernel = nullptr;
  int threads = 0, pixels = 0, nbuf = 0;
  size_t bytes = 0;
  int resident = 0;
  long long grid_cap = 0;  // blocks resident on the card
};

// kernels[v - 1][i]: kernel i (prop_shared's staged and unstaged) for v
// pixels a thread.  Per shape, the block width and kernel that keep the
// most threads resident (the first on ties: staged, narrower); the shape
// as kShapes says.  plan.threads == 0 when nothing fits.
cudaError_t plan_tiles(const void* const (*kernels)[2], const size_t* table_bytes,
                       int n_kernels, int depth, bool pairs, Plan* plan) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  for (const auto& shape : kShapes) {
    const int v = shape[0], nbuf = shape[1];
    if (v == 2 && !pairs) continue;
    Plan best;
    for (int i = 0; i < n_kernels; ++i) {
      const void* kernel = kernels[v - 1][i];
      rc = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
      if (rc != cudaSuccess) return rc;
      for (int nt = 32; nt <= kThreads; nt += 32) {
        const size_t bytes =
            table_bytes[i] + (size_t)nbuf * nt * v * depth * sizeof(float);
        if (bytes > (size_t)optin) break;
        rc = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
        int per_sm = 0;
        if (rc == cudaSuccess)
          rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             nt, bytes);
        if (rc != cudaSuccess) return rc;
        if (per_sm * nt > best.resident)
          best = {kernel, nt, v, nbuf, bytes, per_sm * nt, (long long)per_sm * sms};
      }
    }
    if (best.resident > plan->resident) *plan = best;
    if (plan->resident >= kMinResident) break;
  }
  if (!plan->threads) return cudaSuccess;
  return cudaFuncSetAttribute(plan->kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)plan->bytes);
}

// Launch the plan's kernel over total pixels: as many blocks as stay
// resident, at most one a tile.  args: the kernel's arguments but the last,
// the buffer count, which the plan gives.
int launch_tiles(Plan& plan, void** args, int n_args, long long total,
                 cudaStream_t stream) {
  if (!plan.threads) return (int)cudaErrorInvalidValue;
  args[n_args] = &plan.nbuf;
  const long long groups = total / plan.pixels;
  const long long tiles = (groups + plan.threads - 1) / plan.threads;
  const long long grid = tiles < plan.grid_cap ? tiles : plan.grid_cap;
  const cudaError_t rc =
      cudaLaunchKernel(plan.kernel, dim3((unsigned)grid), dim3(plan.threads),
                       args, plan.bytes, stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

bool pairs_of(const float* stack, long long hw) {
  return hw % 2 == 0 && reinterpret_cast<uintptr_t>(stack) % 8 == 0;
}

template <int L>
int launch_any(float* stack, Steps& s, int nsteps, int depth, long long hw,
               long long total, cudaStream_t stream) {
  const void* const k[2][2] = {
      {reinterpret_cast<const void*>(&prop_any<L, 1>), nullptr},
      {reinterpret_cast<const void*>(&prop_any<L, 2>), nullptr}};
  const size_t tb[] = {staged_entries(nsteps, L) * sizeof(int4)};
  Plan plan;
  const cudaError_t rc = plan_tiles(k, tb, 1, depth, pairs_of(stack, hw), &plan);
  if (rc != cudaSuccess) return (int)rc;
  void* args[] = {&stack, &s, &nsteps, &depth, &hw, &total, nullptr};
  return launch_tiles(plan, args, 6, total, stream);
}

template <int L>
int launch_table(float* stack, const int* table, int nsteps, int depth,
                 long long hw, long long total, int shared, cudaStream_t stream) {
  if (!shared) {
    prop_global<L><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(stack, table, nsteps, depth, hw, total);
    return (int)cudaGetLastError();
  }
  const void* const k[2][2] = {
      {reinterpret_cast<const void*>(&prop_shared<L, 1, true>),
       reinterpret_cast<const void*>(&prop_shared<L, 1, false>)},
      {reinterpret_cast<const void*>(&prop_shared<L, 2, true>),
       reinterpret_cast<const void*>(&prop_shared<L, 2, false>)}};
  const size_t staged = (size_t)staged_entries(nsteps, L) * sizeof(int4);
  const size_t tb[] = {nsteps < (1 << 24) ? staged : ~(size_t)0 / 2, 0};
  Plan plan;
  const cudaError_t rc = plan_tiles(k, tb, 2, depth, pairs_of(stack, hw), &plan);
  if (rc != cudaSuccess) return (int)rc;
  void* args[] = {&stack, &table, &nsteps, &depth, &hw, &total, nullptr};
  return launch_tiles(plan, args, 6, total, stream);
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
// nsteps entries; ahead: the read-ahead L (1, 2, 4 or 8), at most the
// list's least revisit distance.  *general: 1 when prop_any ran, 0 when
// prop_fixed did.  Returns a cudaError_t; 1 (cudaErrorInvalidValue) on a
// shape or step list the kernels do not take.
extern "C" int fdcm_prop(float* stack, const int* c1, const int* c2,
                         const float* wt, int nsteps, int depth, long long hw,
                         long long n_stacks, int ahead, int* general,
                         cudaStream_t stream) {
  if (depth <= 0 || depth > kMaxDepth || hw <= 0 || n_stacks <= 0 ||
      nsteps < 0 || nsteps > kMaxSteps || !general)
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
  const bool fixed = reference_pattern(c1, c2, nsteps, depth) &&
                     (depth == 12 || depth == 30 || depth == 60);
  *general = !fixed;
  const bool pairs = pairs_of(stack, hw);
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
  else if (ahead == 8)
    return launch_any<8>(stack, s, nsteps, depth, hw, total, stream);
  else if (ahead == 4)
    return launch_any<4>(stack, s, nsteps, depth, hw, total, stream);
  else if (ahead == 2)
    return launch_any<2>(stack, s, nsteps, depth, hw, total, stream);
  else if (ahead == 1)
    return launch_any<1>(stack, s, nsteps, depth, hw, total, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}


// In place on stack (n_stacks, depth, hw), any depth and step list.  table:
// a device (3, nsteps) int32 table (c1, c2, the weights' f32 bits), indices
// in [0, depth).  shared: 1 for prop_shared, 0 for prop_global.  ahead: as
// fdcm_prop's.  Returns a cudaError_t; 1 (cudaErrorInvalidValue) on a shape
// prop_shared cannot hold in this card's shared memory at 32 threads.
extern "C" int fdcm_prop_table(float* stack, const int* table, int nsteps,
                               int depth, long long hw, long long n_stacks,
                               int shared, int ahead, cudaStream_t stream) {
  if (depth <= 0 || hw <= 0 || n_stacks <= 0 || nsteps < 0 || !table)
    return (int)cudaErrorInvalidValue;
  const long long total = n_stacks * hw;
  switch (ahead) {
    case 8: return launch_table<8>(stack, table, nsteps, depth, hw, total, shared, stream);
    case 4: return launch_table<4>(stack, table, nsteps, depth, hw, total, shared, stream);
    case 2: return launch_table<2>(stack, table, nsteps, depth, hw, total, shared, stream);
    case 1: return launch_table<1>(stack, table, nsteps, depth, hw, total, shared, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
