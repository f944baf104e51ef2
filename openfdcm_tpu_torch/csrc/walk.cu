// The walk decisions over one scored window, one launch: per candidate, the
// greedy walk (DefaultOptimize, IndulgentOptimize) or the BatchOptimize
// batches over window scores (M, H) at steps t0 .. t0 + H - 1, of which only
// steps <= tcov were evaluated.  It computes what the plain version
// openfdcm_tpu_torch/ops/walk.py::decide_window_plain computes, bit for
// bit: the first stop and the first minimum by index, NaN propagated as torch's amin and min(dim) propagate it
// (min(dim) names the first NaN), the masked steps' 3e38, the decidable and
// frozen rule of the batches, and t_next.  Every sum and product is
// __fadd_rn/__fmul_rn/__fdiv_rn in the plain version's order.
//
// Replaces no TPU kernel: the JAX package decides a window in XLA, fused
// into one program.  In eager PyTorch the plain versions dispatch 30 to 450
// small operations a window (a Python loop over batches), each a few
// microseconds of host time and nothing on the device.
//
// What bounds it on the H100: the launch.  It reads M * H scores and writes
// five values a candidate (a 30,720 x 63 main pass reads 7.7 MB).  One
// thread walks one candidate's row in step order, as the reference does,
// and stops reading at its first stop; the warp's 32 rows are read through
// L1, each 32-byte sector serving 8 steps.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;   // a step outside the walk (optimize._BIG)

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fffffff); }

// torch.minimum: NaN if either is
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) || is_nan(b) ? nan_value() : fminf(a, b);
}

struct State {
  float prev, best, bmul, t;
  bool done;
};

// _greedy_chain_cov: the kept prefix runs up to the first ascent or step
// that is past tcov, past t_limit or of a finished walk; the window's
// minimum is over the kept steps and kBig at every later step.
__device__ void greedy(const float* __restrict__ s, int h, float lim,
                       float cov, float sign, State& st) {
  const float t0 = st.t;
  float last = st.prev;   // the last kept score
  float wmin = 0.0f;
  int widx = h;           // h: no kept step that is not NaN
  bool nan_kept = false;
  int k = h;
  for (int i = 0; i < h; ++i) {
    const float x = s[i];
    const float step = __fadd_rn(t0, (float)i);
    const bool valid = step <= cov && step <= lim && !st.done;
    if (x > last || !valid) {
      k = i;
      break;
    }
    if (is_nan(x))
      nan_kept = true;
    else if (widx == h || x < wmin) {
      wmin = x;
      widx = i;
    }
    last = x;
  }
  if (nan_kept) {         // amin is NaN, and no step equals it
    wmin = nan_value();
    widx = h;
  } else if (k < h && (widx == h || kBig < wmin)) {
    wmin = kBig;          // the first masked step
    widx = k;
  }
  if (wmin < st.best) {
    st.best = wmin;
    st.bmul = __fmul_rn(sign, __fadd_rn(t0, (float)widx));
  }
  st.prev = last;
  st.t = __fadd_rn(t0, (float)k);
  // a stop at an unevaluated step within the limit leaves the walk live
  st.done = st.done || (k < h && (st.t <= cov || st.t > lim));
}

// _batch_stats and _batch_step over the window's whole batches, in order; a
// batch is decidable when min(its last step, t_limit) <= tcov, and the first
// that is not freezes the candidate.  A finished walk changes nothing more.
__device__ void batches(const float* __restrict__ s, int h, float lim,
                        float cov, float sign, int batch, State& st) {
  const float t0 = st.t;
  const int nb = h / batch;
  for (int b = 0; b < nb && !st.done; ++b) {
    const int i0 = b * batch;
    const float t0b = __fadd_rn(t0, (float)i0);
    const float end = __fsub_rn(__fadd_rn(t0b, (float)batch), 1.0f);
    if (!(min_nan(end, lim) <= cov)) break;   // frozen
    // min(dim) over the masked steps t0 + i: the first minimum, or the
    // first NaN
    float bmin = 0.0f;
    int barg = -1, n_valid = 0;
    bool nan_seen = false;
    for (int j = 0; j < batch; ++j) {
      const bool in = __fadd_rn(t0, (float)(i0 + j)) <= lim;
      const float x = in ? s[i0 + j] : kBig;
      n_valid += in;
      if (nan_seen) continue;
      if (is_nan(x)) {
        nan_seen = true;
        bmin = x;
        barg = j;
      } else if (barg < 0 || x < bmin) {
        bmin = x;
        barg = j;
      }
    }
    const int il = i0 + (n_valid > 0 ? n_valid - 1 : 0);
    const float last = __fadd_rn(t0, (float)il) <= lim ? s[il] : kBig;
    // batchoptimize.cpp:60-93: break before keeping a worse batch, or
    // after keeping one that rose inside
    const bool keep = !(bmin > st.prev);
    if (keep && bmin < st.best) {
      st.best = bmin;
      st.bmul = __fmul_rn(sign, __fadd_rn(t0b, (float)barg));
    }
    if (keep) st.prev = bmin;
    const bool interior = keep && bmin < last;
    const bool exhausted = __fadd_rn(t0b, (float)batch) > lim;
    st.done = !keep || interior || exhausted;
  }
  // resume after the batches tcov decides, whatever was decided
  float nb_dec = floorf(__fdiv_rn(__fadd_rn(__fsub_rn(cov, t0), 1.0f),
                                  (float)batch));
  if (!is_nan(nb_dec)) nb_dec = fminf(fmaxf(nb_dec, 0.0f), (float)nb);
  st.t = __fadd_rn(t0, __fmul_rn(nb_dec, (float)batch));
}

__global__ void __launch_bounds__(kThreads)
decide_kernel(const float* __restrict__ scores, long long ld, int h,
              const float* __restrict__ t_limit, const float* __restrict__ tcov,
              const float* __restrict__ prev, const float* __restrict__ best,
              const float* __restrict__ bmul, const bool* __restrict__ done,
              const float* __restrict__ t0, float* __restrict__ out,
              bool* __restrict__ out_done, long long m, float sign,
              int batch) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= m) return;
  State st{prev[c], best[c], bmul[c], t0[c], done[c]};
  const float* s = scores + c * ld;
  if (batch > 0)
    batches(s, h, t_limit[c], tcov[c], sign, batch, st);
  else
    greedy(s, h, t_limit[c], tcov[c], sign, st);
  out[c] = st.prev;
  out[m + c] = st.best;
  out[2 * m + c] = st.bmul;
  out[3 * m + c] = st.t;
  out_done[c] = st.done;
}

}  // namespace

// scores: (m, h) rows ld floats apart; out: (4, m) new prev, best, bmul,
// t_next; out_done: (m,).  batch 0: the greedy walk.
extern "C" int fdcm_decide_window(const float* scores, long long ld,
                                  const float* t_limit, const float* tcov,
                                  const float* prev, const float* best,
                                  const float* bmul, const bool* done,
                                  const float* t0, float* out, bool* out_done,
                                  long long m, int h, int sign, int batch,
                                  cudaStream_t stream) {
  if (m <= 0 || h <= 0 || ld < h || batch < 0 || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decide_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      scores, ld, h, t_limit, tcov, prev, best, bmul, done, t0, out, out_done,
      m, (float)sign, batch);
  return (int)cudaGetLastError();
}
