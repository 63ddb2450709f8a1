// Fused normalize + reject + mean over an (N, P) frame stack: kernel K1,
// every rejection mode on float32 or raw int16 input, with every
// normalization mode and optional weights.
//   K1a  window modes: NO_REJEC, PERCENTILE, SIGMA, MAD, WINSORIZED
//   K1b  SIGMEDIAN  (values replaced by the running median, re-sorted)
//   K1c  LINEARFIT  (line fit over the kept ranks, mask keep set)
//   K1d  GESDT      (generalized ESD walk, two passes, λ table input)
//   K1e  weighted mean over the kept values' [pmin, pmax] range
//
// Replaces the TPU kernel siril_tpu/pallas/reject_stack.py::
// pallas_reject_mean (pallas_call at :804, body _build_kernel :202; K1a
// :269-477, K1b :478, K1c :521, K1d :586, K1e :719).  Its plain PyTorch
// version is siril_tpu_torch/ops/stacking.py::reject_stack_plain.
//
// What bounds it on an H100: one read of the stack (4 or 2 bytes per
// value), the weights, and 12 bytes written per pixel: ~90 us of HBM time
// for a main-path block (24 x 2.8 Mpix f32).  The float operations the
// data needs (~2,400 a pixel at N = 24, most of them in the winsorized σ
// iteration) take about as long at the f32 peak.  The kernel is held back
// by instruction issue and latency instead: every sum runs in row order,
// one lane per pixel, to stay bit-equal to the plain version, so each σ
// step is two chains of N dependent adds, and the winsorized iteration
// takes from 1 to ~1000 steps a pixel (~14 on average).
//
// Two paths.
// 1. Registers: every mode but GESDT at N <= 32 (K1a, K1b, K1c, and K1e
//    over them; register_kernel, templated on NMAX = 8, 16, 24, 32, on
//    the weighting, and on the mode class: the window modes, winsorized,
//    SIGMEDIAN, LINEARFIT, so that no kernel carries another class's code
//    and registers).
//    - The column lives in registers, padded with +inf, sorted by an
//      odd-even merge network; loops over rows are unrolled and predicated
//      on a row mask, the median is a tree of selects, so nothing spills.
//      The N loads of a column are issued before any is used: one memory
//      latency a column, not N.
//    - The winsorized accumulated values are clamp(xs[k], L, H): clamps
//      compose on a sorted column, so two floats per pixel replace the
//      w array.
//    - SIGMEDIAN re-sorts its column with the same network after a round
//      that replaced values.
//    - LINEARFIT's keep set is one 32-bit mask; a kept value's rank is a
//      running count over the mask, and its N-r<=4 guard accepts the
//      candidates in row order through a running candidate count.
//    - Against divergence, warps take pixels from one counter for the
//      whole grid, and each warp runs its loop (the σ iteration, or the
//      SIGMEDIAN or LINEARFIT rounds) as a loop of single steps; when a
//      ready count of its lanes (per class) are done, those lanes act
//      together (winsorized: clip and start the next round; any class:
//      write the result and take the next pixel), while the others keep
//      their state.  A lane whose pixel is done early so works on instead
//      of idling until the warp's slowest pixel is done, and no block
//      idles while others still have pixels to take.
//    - A weighted mean keeps the normalized column in frame order in
//      shared memory: the stack is read once.  Per-frame weights (pixel
//      stride 0) are staged in shared memory, never materialized per
//      pixel.
//    - The column is read straight from global memory: the lanes of a
//      warp that take pixels together get consecutive ones, so each row
//      read is a run of consecutive words.  Results are stored per pixel.
// 2. Shared memory: GESDT at any N and every other mode at N > 32
//    (reject_stack_kernel), one thread per pixel column.
//    - The column's N values live in shared memory laid out [N][threads]
//      (element k of thread t at k*threads + t: no bank conflicts), with a
//      second such array where the mode needs one (MAD deviations, the
//      keep flags of LINEARFIT and GESDT) or, for a weighted mean in the
//      other modes, the original values.  When they do not fit a block of
//      32 threads, the columns live in a global scratch buffer laid out
//      [N][cols], and the launcher walks the pixels in chunks of `cols`.
//    - Values are insertion-sorted as they are loaded; the mask modes
//      count ranks and the N-r<=4 guard in the thread's serial loop;
//      SIGMEDIAN re-sorts in place after each replacement round; GESDT
//      reads its λ table through the read-only cache, pass 1 records the
//      last flagged walk step, pass 2 replays the walk.
//    - A weighted mean in LINEARFIT, GESDT or MAD re-reads the column's
//      original values from global memory (mostly from L2).
//
// Arithmetic follows the plain version operation by operation: sums run
// in row order, the multiply-adds XLA contracts in the reference are
// single-rounding fused multiply-adds (__fmaf_rn) — the window variance,
// the winsorized clip bounds, the additive normalization and the
// LINEARFIT intercept and line — and the build passes --fmad=false so no
// other product is fused.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NO_REJEC = 0;
constexpr int PERCENTILE = 1;
constexpr int SIGMA = 2;
constexpr int MAD = 3;
constexpr int SIGMEDIAN = 4;
constexpr int WINSORIZED = 5;
constexpr int LINEARFIT = 6;
constexpr int GESDT = 7;

constexpr int NO_NORM = 0;
constexpr int ADDITIVE = 1;
constexpr int ADDITIVE_SCALING = 3;

// ops/rejection.py SIGMEDIAN_MAX_ROUNDS, WINSOR_MAX_STEPS
constexpr int SIGMEDIAN_MAX_ROUNDS = 1000;
constexpr int WINSOR_MAX_STEPS = 1000;

constexpr float INV_U16 = (float)(1.0 / 65535.0);

// shared memory a block may opt in to on Hopper (232,448 bytes)
constexpr size_t SMEM_OPTIN = 227 * 1024;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

struct Params {
  const void* stack;
  int n, p;
  const float* scale;
  const float* offset;
  const float* mul;
  const float* weights;      // null: unweighted mean
  long long w_sn, w_sp;      // weight strides (frame, pixel) in elements
  const float* crit;         // GESDT λ table, >= max(max_outliers, 1)
  int rtype, mode;
  float siglow, sighigh;
  int n_full, max_outliers;  // LINEARFIT / GESDT
  float m_x, inv_mdx2;       // LINEARFIT constants for n_full
  float* mean;
  int* rejl;
  int* rejh;
  float* scratch;            // global columns when shared memory is short
  int cols;                  // columns of the scratch buffer
  unsigned long long* capped;  // loops stopped at their mode's bound
  unsigned* queue;             // register path: the next pixel to hand out
};

// One pixel column: element k at p[k * stride] — in shared memory
// ([N][threads], stride = threads) or in the global scratch buffer
// ([N][cols], stride = cols, the columns of one launch chunk).
struct Col {
  float* p;
  int stride;
  __device__ float& operator[](int k) const {
    return p[(size_t)k * stride];
  }
};

__device__ float window_median(Col xs, int n_all, int lo, int hi) {
  int n = max(hi - lo, 1);
  int i0 = lo + (n - 1) / 2;
  int i1 = lo + n / 2;
  float v0 = i0 < n_all ? xs[i0] : 0.f;
  float v1 = i1 < n_all ? xs[i1] : 0.f;
  return 0.5f * (v0 + v1);
}

// Sample sd (N-1) of the window [lo, hi), one-pass as in the reference.
__device__ float window_sd(Col xs, int lo, int hi) {
  float t1 = 0.f, t2 = 0.f;
  for (int k = lo; k < hi; ++k) {
    float v = xs[k];
    t1 += v;
    t2 += v * v;
  }
  float n = (float)(hi - lo);
  float mean = t1 / fmaxf(n, 1.f);
  float var = __fmaf_rn(-t1, mean, t2) / fmaxf(n - 1.f, 1.f);
  float sd = sqrtf(fmaxf(var, 0.f));
  return n > 1.f ? sd : 0.f;
}

// Median of |x - med| over the window (deviations sorted into d).
__device__ float mad_spread(Col xs, Col d, int lo, int hi, float med) {
  int m = 0;
  for (int k = lo; k < hi; ++k) {
    float v = fabsf(xs[k] - med);
    int j = m++;
    while (j > 0 && d[j - 1] > v) {
      d[j] = d[j - 1];
      --j;
    }
    d[j] = v;
  }
  return window_median(d, hi - lo, 0, hi - lo);
}

// Iterated winsorized sigma (rejection_float.c:222-236), the exact C
// iteration: no extrapolation, at most WINSOR_MAX_STEPS steps (``capped``
// is set when a column is still moving after them).  The accumulated
// clipped values are clamp(xs[k], L, H): the column is sorted and nested
// clamps compose, so two floats replace the w array.
__device__ float winsor_sd(Col xs, int lo, int hi, float med, bool& capped) {
  float sigma = window_sd(xs, lo, hi);
  if (hi - lo <= 1) return sigma;
  float n = fmaxf((float)(hi - lo), 1.f);
  float nm1 = fmaxf(n - 1.f, 1.f);
  float L = -INFINITY, H = INFINITY;
  for (int it = 0; it < WINSOR_MAX_STEPS; ++it) {
    float m0 = __fmaf_rn(-1.5f, sigma, med);
    float m1 = __fmaf_rn(1.5f, sigma, med);
    L = fminf(fmaxf(L, m0), m1);
    H = fminf(fmaxf(H, m0), m1);
    float t1 = 0.f;
    for (int k = lo; k < hi; ++k) t1 += fminf(fmaxf(xs[k], L), H);
    float mean = t1 / n;
    float t2 = 0.f;
    for (int k = lo; k < hi; ++k) {
      float dv = fminf(fmaxf(xs[k], L), H) - mean;
      t2 += dv * dv;
    }
    float ns = 1.134f * sqrtf(fmaxf(t2 / nm1, 0.f));
    bool conv = fabsf(ns - sigma) <= sigma * 5e-4f;
    sigma = ns;
    if (conv) return sigma;
  }
  capped = true;
  return sigma;
}

struct Window {
  int lo, hi, r, rejl, rejh, seg_lo, seg_hi;
};

// One clipping round with the cumulative N-r<=4 guard in closed form
// (low candidates are a prefix of the sorted window, high ones a suffix).
// A truncated high side keeps its largest candidates as the kept segment.
// Returns whether anything was rejected.
__device__ bool clip_round(Col xs, Window& w, float center, float spread,
                           float siglow, float sighigh) {
  int ncl = 0, nch = 0;
  for (int k = w.lo; k < w.hi; ++k) {
    float v = xs[k];
    if ((center - v) > spread * siglow) ++ncl;
    if ((v - center) > spread * sighigh) ++nch;
  }
  int max_acc = max(w.hi - w.lo - w.r - 4, 0);
  int n_low = min(ncl, max_acc);
  int n_high = min(nch, max_acc - n_low);
  bool trunc = n_high > 0 && n_high < nch;
  if (trunc) {
    w.seg_lo = w.hi - nch + n_high;
    w.seg_hi = w.hi;
  }
  w.lo += n_low;
  w.hi -= trunc ? nch : n_high;
  w.r += n_low + n_high;
  w.rejl += n_low;
  w.rejh += n_high;
  return n_low + n_high > 0;
}


// Mean and sample sd (N-1) of the window [lo, hi), one-pass.
__device__ void window_mean_sd(Col xs, int lo, int hi, float& mean,
                               float& sd) {
  float t1 = 0.f, t2 = 0.f;
  for (int k = lo; k < hi; ++k) {
    float v = xs[k];
    t1 += v;
    t2 += v * v;
  }
  float n = (float)(hi - lo);
  mean = t1 / fmaxf(n, 1.f);
  float var = __fmaf_rn(-t1, mean, t2) / fmaxf(n - 1.f, 1.f);
  sd = n > 1.f ? sqrtf(fmaxf(var, 0.f)) : 0.f;
}

// Insertion sort of xs[0, m) in place.
__device__ void sort_column(Col xs, int m) {
  for (int i = 1; i < m; ++i) {
    float v = xs[i];
    int j = i;
    while (j > 0 && xs[j - 1] > v) {
      xs[j] = xs[j - 1];
      --j;
    }
    xs[j] = v;
  }
}

// K1b: SIGMEDIAN (rejection_float.c:210-221).  Rejected values become the
// running median and the column is re-sorted, until a round replaces
// nothing.  Mean and sd are two-pass over the valid rows.  Returns true
// when the loop stopped at SIGMEDIAN_MAX_ROUNDS while still replacing.
__device__ bool sigmedian(Col xs, int n, int nvalid, float siglow,
                          float sighigh, int& rejl, int& rejh) {
  float nv = (float)nvalid;
  float nvs = fmaxf(nv, 1.f), nvm1 = fmaxf(nv - 1.f, 1.f);
  bool active = nvalid > 1;
  for (int round = 0; active && round < SIGMEDIAN_MAX_ROUNDS; ++round) {
    float med = window_median(xs, n, 0, nvalid);
    float t = 0.f;
    for (int k = 0; k < nvalid; ++k) t += xs[k];
    float mean = t / nvs;
    float t2 = 0.f;
    for (int k = 0; k < nvalid; ++k) {
      float d = xs[k] - mean;
      t2 += d * d;
    }
    float sd = nv > 1.f ? sqrtf(fmaxf(t2 / nvm1, 0.f)) : 0.f;
    int nl = 0, nh = 0;
    for (int k = 0; k < nvalid; ++k) {
      float v = xs[k];
      bool lo = (med - v) > sd * siglow;
      bool hi = (v - med) > sd * sighigh;
      if (lo || hi) xs[k] = med;
      nl += lo;
      nh += hi;
    }
    if (nl + nh > 0) sort_column(xs, nvalid);
    rejl += nl;
    rejh += nh;
    active = nl + nh > 0;
  }
  return active;
}

// K1c: LINEARFIT (rejection_float.c:259-300).  keep[k] != 0 marks a kept
// sorted value; its position is its rank among the kept.  m_x and
// 1/m_dx2 are the full-size constants (median_and_mean.c:1491-1499).
__device__ void linearfit(Col xs, Col keep, int nvalid, float siglow,
                          float sighigh, float m_x, float inv_mdx2, int n,
                          int& rejl, int& rejh) {
  int r = 0;
  bool active = nvalid > 1;
  while (active) {
    int nk = 0;
    float sy = 0.f;
    for (int k = 0; k < n; ++k) {
      if (keep[k] != 0.f) {
        sy += xs[k];
        ++nk;
      }
    }
    float nks = fmaxf((float)nk, 1.f);
    float m_y = sy / nks;
    float sxy = 0.f;
    int c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep[k] != 0.f) {
        float pos = (float)c++;
        sxy += (pos - m_x) * (xs[k] - m_y);
      }
    }
    float a = (sxy / nks) * inv_mdx2;
    float b = __fmaf_rn(-m_x, a, m_y);
    float sr = 0.f;
    c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep[k] != 0.f) {
        float pos = (float)c++;
        sr += fabsf(xs[k] - __fmaf_rn(a, pos, b));
      }
    }
    float sigma = sr / nks;
    int max_acc = max(nk - r - 4, 0);
    int rank = 0, nl = 0, nh = 0;
    c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep[k] != 0.f) {
        float pos = (float)c++;
        float resid = xs[k] - __fmaf_rn(a, pos, b);
        bool lo = (-resid) > sigma * siglow;
        bool hi = resid > sigma * sighigh;
        if ((lo || hi) && ++rank <= max_acc) {
          keep[k] = 0.f;
          nl += lo;
          nh += hi;
        }
      }
    }
    r += nl + nh;
    rejl += nl;
    rejh += nh;
    active = nl + nh > 0 && (nk - nl - nh) > 3;
  }
}

// One step of the GESDT walk over the sorted window [lo, hi).
struct EsdStep {
  int size;
  float g, first, last;
  bool take_high, valid;
};

__device__ EsdStep esd_step(Col xs, int n, int lo, int hi, int j,
                            int budget) {
  EsdStep s;
  s.size = hi - lo;
  float mean, sd;
  window_mean_sd(xs, lo, hi, mean, sd);
  s.first = lo < n ? xs[lo] : 0.f;
  s.last = xs[max(hi - 1, 0)];
  float dev_low = mean - s.first;
  float dev_high = s.last - mean;
  s.take_high = dev_high > dev_low;  // strict > (grubbs_stat:88-96)
  s.g = (s.take_high ? dev_high : dev_low) / fmaxf(sd, 1e-30f);
  s.valid = j < budget && s.size > 1;
  return s;
}

// K1d: GESDT (rejection_float.c:302-345 + confirm_outliers,
// median_and_mean.c:685-701).  keep[k] != 0 marks a kept sorted value.
__device__ void gesdt(Col xs, Col keep, int n, int nvalid, int n_full,
                      int max_outliers, const float* __restrict__ crit,
                      int& rejl, int& rejh) {
  int M = max(max_outliers, 1);
  int removed = n_full - nvalid;
  int budget = max_outliers - removed;
  float median0 = window_median(xs, n, 0, nvalid);
  // pass 1: the last flagged step
  int lo = 0, hi = nvalid, last_flag = -1;
  for (int j = 0; j < M; ++j) {
    EsdStep s = esd_step(xs, n, lo, hi, j, budget);
    float lam = __ldg(crit + min(removed + j, M - 1));
    if (s.valid && s.size > 2 && s.g > lam) last_flag = j;
    if (s.valid) {
      if (s.take_high) --hi;
      else ++lo;
    }
  }
  int i_conf = max(last_flag, min(1, M - 1));
  // pass 2: replay, rejecting the confirmed steps
  bool budget_ok = removed < max_outliers;
  lo = 0;
  hi = nvalid;
  for (int j = 0; j < M; ++j) {
    EsdStep s = esd_step(xs, n, lo, hi, j, budget);
    if (j <= i_conf && s.valid && budget_ok) {
      float x_rm = s.take_high ? s.last : s.first;
      if (x_rm >= median0) ++rejh;
      else ++rejl;
      // high removals record the shrunk-array index (rejection_float.c:332)
      keep[s.take_high ? s.size - 1 : lo] = 0.f;
    }
    if (s.valid) {
      if (s.take_high) --hi;
      else ++lo;
    }
  }
}

// Frame k of pixel px: decode (int16), normalize.
template <typename T>
__device__ float load_value(const Params& a, int k, int px) {
  float x = (float)((const T*)a.stack)[(size_t)k * a.p + px];
  float s = __ldg(a.scale + k);
  if (sizeof(T) == 2) {
    x = x + 32768.f;
    if (a.mode == NO_NORM) x = x * INV_U16;
    else s = s * INV_U16;   // decode folded into the scale
  }
  if (a.mode == ADDITIVE || a.mode == ADDITIVE_SCALING) {
    float o = __fmaf_rn(x, s, -__ldg(a.offset + k));
    x = x != 0.f ? o : 0.f;
  } else if (a.mode != NO_NORM) {
    x = x * s * __ldg(a.mul + k);
  }
  return x;
}

// Whether a mode keeps a second per-column array (MAD deviations, the keep
// flags of LINEARFIT and GESDT); in the other modes the second array, when
// there is one, holds a weighted mean's original values.
__host__ __device__ bool uses_aux(int rtype) {
  return rtype == MAD || rtype == LINEARFIT || rtype == GESDT;
}

// Per-column arrays of the shared-memory and global layouts.
__host__ __device__ int column_arrays(int rtype, bool weighted) {
  return uses_aux(rtype) || weighted ? 2 : 1;
}

template <typename T, bool GLOBAL>
__global__ void reject_stack_kernel(Params a, int p0, int p1) {
  extern __shared__ float smem[];
  int t = threadIdx.x;
  int px = p0 + blockIdx.x * blockDim.x + t;
  if (px >= p1) return;
  const int n = a.n;
  // a weighted mean keeps the original values in the second array when
  // the mode leaves it free, so the stack is read once
  const bool orig_in_aux = a.weights != nullptr && !uses_aux(a.rtype);
  Col xs, aux;
  if (GLOBAL) {
    float* base = a.scratch + (px - p0);
    xs = Col{base, a.cols};
    aux = Col{base + (size_t)n * a.cols, a.cols};
  } else {
    xs = Col{smem + t, (int)blockDim.x};
    aux = Col{smem + n * blockDim.x + t, (int)blockDim.x};
  }
  const float siglow = a.siglow, sighigh = a.sighigh;

  // load, decode, normalize; insertion-sort the valid (non-zero, finite)
  // values into xs[0, nvalid)
  int nvalid = 0, n_neg = 0;
  for (int k = 0; k < n; ++k) {
    float x = load_value<T>(a, k, px);
    if (orig_in_aux) aux[k] = x;
    if (x != 0.f && isfinite(x)) {
      int j = nvalid++;
      while (j > 0 && xs[j - 1] > x) {
        xs[j] = xs[j - 1];
        --j;
      }
      xs[j] = x;
      if (x < 0.f) ++n_neg;
    }
  }
  for (int k = nvalid; k < n; ++k) xs[k] = INFINITY;

  const int rtype = a.rtype;
  // kept set: the window [lo, hi) plus the segment [seg_lo, seg_hi), or
  // the keep flags in aux for the mask modes
  bool masked = rtype == LINEARFIT || rtype == GESDT;
  Window w{0, nvalid, 0, 0, 0, 0, 0};
  if (masked) {
    for (int k = 0; k < n; ++k) aux[k] = k < nvalid ? 1.f : 0.f;
  }
  if (rtype == PERCENTILE) {
    float med = window_median(xs, n, 0, nvalid);
    bool dead = med == 0.f || nvalid <= 1;
    int nl = 0, nh = 0;
    for (int k = 0; k < nvalid; ++k) {
      float v = xs[k];
      if ((med - v) > med * siglow) ++nl;
      if ((v - med) > med * sighigh) ++nh;
    }
    w.lo = dead ? 0 : nl;
    w.hi = dead ? 0 : nvalid - nh;
    w.rejl = dead ? 0 : nl;
    w.rejh = dead ? 0 : nh;
  } else if (rtype == SIGMA || rtype == MAD) {
    float med = window_median(xs, n, 0, nvalid);
    bool dead = med == 0.f || nvalid <= 1;
    bool active = !dead, first = true;
    while (active) {
      float spread = rtype == MAD ? mad_spread(xs, aux, w.lo, w.hi, med)
                                  : window_sd(xs, w.lo, w.hi);
      if (!first) med = window_median(xs, n, w.lo, w.hi);
      first = false;
      active = clip_round(xs, w, med, spread, siglow, sighigh) &&
               (w.hi - w.lo) > 3;
    }
    if (dead) w.lo = w.hi = w.seg_hi = 0;
  } else if (rtype == WINSORIZED) {
    bool active = nvalid > 1;
    while (active) {
      float med = window_median(xs, n, w.lo, w.hi);
      bool capped = false;
      float sig = winsor_sd(xs, w.lo, w.hi, med, capped);
      if (capped && a.capped != nullptr) atomicAdd(a.capped, 1ULL);
      active = clip_round(xs, w, med, sig, siglow, sighigh) &&
               (w.hi - w.lo) > 3;
    }
  } else if (rtype == SIGMEDIAN) {
    if (sigmedian(xs, n, nvalid, siglow, sighigh, w.rejl, w.rejh) &&
        a.capped != nullptr) {
      atomicAdd(a.capped, 1ULL);
    }
  } else if (rtype == LINEARFIT) {
    linearfit(xs, aux, nvalid, siglow, sighigh, a.m_x, a.inv_mdx2, n,
              w.rejl, w.rejh);
  } else if (rtype == GESDT) {
    gesdt(xs, aux, n, nvalid, a.n_full, a.max_outliers, a.crit, w.rejl,
          w.rejh);
  }
  if (nvalid <= 1) {  // kept <= 1 before rejection: keep as is
    masked = false;
    w.lo = 0;
    w.hi = nvalid;
    w.seg_hi = 0;
    w.rejl = w.rejh = 0;
  }

  float sum = 0.f, pmin = INFINITY, pmax = -INFINITY;
  int nkept = 0;
  for (int k = 0; k < n; ++k) {
    bool kept = masked ? aux[k] != 0.f
                       : (k >= w.lo && k < w.hi) ||
                             (k >= w.seg_lo && k < w.seg_hi);
    if (kept) {
      float v = xs[k];
      sum += v;
      ++nkept;
      pmin = fminf(pmin, v);
      pmax = fmaxf(pmax, v);
    }
  }
  float result;
  if (nkept > 0 && a.weights != nullptr) {
    // K1e: weighted mean over the original values in [pmin, pmax]
    float wsum = 0.f, wnorm = 0.f, fb = 0.f;
    for (int k = 0; k < n; ++k) {
      float x = orig_in_aux ? aux[k] : load_value<T>(a, k, px);
      if (x >= pmin && x <= pmax && x != 0.f) {
        float wk = __ldg(a.weights + k * a.w_sn + px * a.w_sp);
        wsum += x * wk;
        wnorm += wk;
        if (x > 0.f) fb += x;
      }
    }
    result = (wnorm != 0.f && wsum != 0.f) ? wsum / wnorm
                                           : fb / (float)nkept;
  } else if (nkept > 0) {
    result = sum / (float)nkept;
  } else {
    // median of the whole column, invalid entries counted as zeros: the
    // sorted order is negatives, then the zeros, then positives
    int nz = n - nvalid;
    float v[2];
    int ks[2] = {(n - 1) / 2, n / 2};
    for (int i = 0; i < 2; ++i) {
      int k = ks[i];
      if (k >= n_neg && k < n_neg + nz) {
        v[i] = 0.f;
      } else {
        int idx = k < n_neg ? k : k - nz;
        v[i] = xs[min(max(idx, 0), n - 1)];
      }
    }
    result = 0.5f * (v[0] + v[1]);
  }
  a.mean[px] = result;
  a.rejl[px] = w.rejl;
  a.rejh[px] = w.rejh;
}

// ---------------------------------------------------------------------------
// The register path: every mode but GESDT at N <= 32 frames
// ---------------------------------------------------------------------------

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int REG_THREADS = 128;
// pixels a lane should get at least, when sizing the grid
constexpr int REG_PIXELS_PER_LANE = 8;

// Mode classes of the register path, one kernel instantiation each.  The
// classes with steps run them under the warp vote of register_kernel.
constexpr int CLASS_WINDOW = 0;     // NO_REJEC, PERCENTILE, SIGMA, MAD
constexpr int CLASS_WINSOR = 1;     // a step: one winsorized σ step
constexpr int CLASS_SIGMEDIAN = 2;  // a step: one replacement round
constexpr int CLASS_LINEARFIT = 3;  // a step: one fit-and-clip round

// A warp leaves its steps once this many lanes wait to act, per class.
// Winsorized, on the main-path block: 16 refills too often and 32 lets
// lanes idle too long (scripts/k1_variants.py; PERF.md §6).
constexpr int READY_LANES = 24;
// SIGMEDIAN and LINEARFIT, the best of thresholds from 4 to 32 at the
// stack command's call size (32 is lockstep with the queue).
constexpr int SIGMEDIAN_READY_LANES = 8;
constexpr int LINEARFIT_READY_LANES = 24;

// Bits [lo, hi) of a row mask, 0 <= lo, hi <= 32 (empty when hi <= lo).
__device__ __forceinline__ unsigned span_mask(int lo, int hi) {
  return (unsigned)(((1ull << hi) - 1ull) & ~((1ull << lo) - 1ull));
}

__device__ __forceinline__ bool row_in(unsigned mask, int k) {
  return (mask >> k) & 1u;
}

// Register arrays are padded to a power of two for the networks below.
// (Every loop over them has a constant trip count, so that it unrolls and
// no array is indexed at run time.)
__host__ __device__ constexpr int pow2_up(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

__host__ __device__ constexpr int log2_of(int p2) {
  return p2 == 8 ? 3 : p2 == 16 ? 4 : 5;
}

// Batcher's odd-even merge sort over NMAX registers, ascending.  Every
// comparator puts the smaller value at the lower index, so the network for
// the next power of two, less its comparators that touch an index past
// NMAX (an +inf pad that never moves), sorts NMAX values.  With invalid
// entries at +inf and no NaN it yields the multiset of the insertion
// sort, bit for bit.
template <int NMAX>
__device__ __forceinline__ void sort_net(float (&v)[NMAX]) {
  constexpr int P2 = pow2_up(NMAX), L2 = log2_of(P2);
#pragma unroll
  for (int lp = 0; lp < L2; ++lp) {
#pragma unroll
    for (int lk = L2 - 1; lk >= 0; --lk) {
      const int p = 1 << lp, k = 1 << lk, j0 = k % p;
#pragma unroll
      for (int lo = 0; lo < NMAX; ++lo) {
        const int hi = lo + k;
        if (lk <= lp && lo >= j0 && (lo - j0) % (2 * k) < k && hi < NMAX &&
            lo / (2 * p) == hi / (2 * p)) {
          float a = v[lo], b = v[hi];
          v[lo] = fminf(a, b);
          v[hi] = fmaxf(a, b);
        }
      }
    }
  }
}

// v[i] by a tree of selects on the bits of i (no dynamic index, depth
// log2 NMAX); 0 when i >= n.
template <int NMAX>
__device__ __forceinline__ float reg_at(const float (&v)[NMAX], int i,
                                        int n) {
  constexpr int P2 = pow2_up(NMAX), L2 = log2_of(P2);
  float t[P2 / 2];
#pragma unroll
  for (int k = 0; k < P2 / 2; ++k) {
    float lo = 2 * k < NMAX ? v[2 * k] : 0.f;
    float hi = 2 * k + 1 < NMAX ? v[2 * k + 1] : 0.f;
    t[k] = (i & 1) ? hi : lo;
  }
#pragma unroll
  for (int lev = 1; lev < L2; ++lev) {
#pragma unroll
    for (int k = 0; k < P2 / 4; ++k) {
      if (k < (P2 >> (lev + 1))) {
        t[k] = ((i >> lev) & 1) ? t[2 * k + 1] : t[2 * k];
      }
    }
  }
  return i < n ? t[0] : 0.f;
}

template <int NMAX>
__device__ __forceinline__ float reg_median(const float (&xs)[NMAX],
                                            int n_all, int lo, int hi) {
  int n = max(hi - lo, 1);
  return 0.5f * (reg_at(xs, lo + (n - 1) / 2, n_all) +
                 reg_at(xs, lo + n / 2, n_all));
}

// Loops over rows k < n skip whole groups of 8 past the frame count n
// (the same n for every lane, so the skip does not diverge).
template <int NMAX>
__device__ __forceinline__ float reg_window_sd(const float (&xs)[NMAX],
                                               int n_rows, int lo, int hi) {
  const unsigned wm = span_mask(lo, hi);
  float t1 = 0.f, t2 = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n_rows) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(wm, k)) {
          float v = xs[k];
          t1 += v;
          t2 += v * v;
        }
      }
    }
  }
  float n = (float)(hi - lo);
  float mean = t1 / fmaxf(n, 1.f);
  float var = __fmaf_rn(-t1, mean, t2) / fmaxf(n - 1.f, 1.f);
  float sd = sqrtf(fmaxf(var, 0.f));
  return n > 1.f ? sd : 0.f;
}

// Median of |x - med| over the window: the deviations sorted in registers.
template <int NMAX>
__device__ __forceinline__ float reg_mad(const float (&xs)[NMAX], int lo,
                                         int hi, float med) {
  const unsigned wm = span_mask(lo, hi);
  float d[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    d[k] = row_in(wm, k) ? fabsf(xs[k] - med) : INFINITY;
  }
  sort_net(d);
  int m = hi - lo;
  return reg_median(d, m, 0, m);
}

template <int NMAX>
__device__ __forceinline__ bool reg_clip_round(const float (&xs)[NMAX],
                                               int n_rows, Window& w,
                                               float center, float spread,
                                               float siglow, float sighigh) {
  const unsigned wm = span_mask(w.lo, w.hi);
  int ncl = 0, nch = 0;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n_rows) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(wm, k)) {
          float v = xs[k];
          if ((center - v) > spread * siglow) ++ncl;
          if ((v - center) > spread * sighigh) ++nch;
        }
      }
    }
  }
  int max_acc = max(w.hi - w.lo - w.r - 4, 0);
  int n_low = min(ncl, max_acc);
  int n_high = min(nch, max_acc - n_low);
  bool trunc = n_high > 0 && n_high < nch;
  if (trunc) {
    w.seg_lo = w.hi - nch + n_high;
    w.seg_hi = w.hi;
  }
  w.lo += n_low;
  w.hi -= trunc ? nch : n_high;
  w.r += n_low + n_high;
  w.rejl += n_low;
  w.rejh += n_high;
  return n_low + n_high > 0;
}

// One lane's pixel: its sorted column (and, for a weighted mean, its
// normalized values in frame order), the kept window and the rejection
// counts, and the state of its class's loop between steps: the winsorized
// σ iteration (med, sigma, L, H, fn, nm1, wm, steps), SIGMEDIAN's rounds
// (fn, nm1, steps) or LINEARFIT's keep mask (keep, with its rejections
// in w.r).  A class's kernel keeps only the fields its code reads.
template <int NMAX, bool WEIGHTED>
struct Lane {
  float xs[NMAX];
  int px, nvalid, n_neg;
  Window w;
  float med, sigma, L, H, fn, nm1;
  unsigned wm, keep;
  int steps;
};

// Normalize frame k's raw value x with the per-frame coefficients in
// shared memory.
template <typename T>
__device__ __forceinline__ float norm_value(const Params& a, const float* sc,
                                            const float* off,
                                            const float* mu, int k,
                                            float x) {
  float s = sc[k];
  if (sizeof(T) == 2) {
    x = x + 32768.f;
    if (a.mode == NO_NORM) x = x * INV_U16;
    else s = s * INV_U16;
  }
  if (a.mode == ADDITIVE || a.mode == ADDITIVE_SCALING) {
    float o = __fmaf_rn(x, s, -off[k]);
    x = x != 0.f ? o : 0.f;
  } else if (a.mode != NO_NORM) {
    x = x * s * mu[k];
  }
  return x;
}

// A weighted mean keeps the lane's normalized column in frame order in
// shared memory, element k at xcol[k * REG_THREADS] (no bank conflicts).
template <typename T, int NMAX, bool WEIGHTED>
__device__ __forceinline__ void lane_load(const Params& a, const float* sc,
                                          const float* off, const float* mu,
                                          float* xcol,
                                          Lane<NMAX, WEIGHTED>& s) {
  const int n = a.n;
  // every load first, none behind a branch on another's value, so the
  // column costs one memory latency; rows past n re-read row n-1
  float raw[NMAX];
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        raw[k] = (float)((const T*)a.stack)[(size_t)min(k, n - 1) * a.p +
                                            s.px];
      }
    }
  }
  int nvalid = 0, n_neg = 0;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    float x = k < n ? norm_value<T>(a, sc, off, mu, k, raw[k]) : 0.f;
    if constexpr (WEIGHTED) {
      if (k < n) xcol[k * REG_THREADS] = x;
    }
    bool ok = k < n && x != 0.f && isfinite(x);
    s.xs[k] = ok ? x : INFINITY;
    nvalid += ok;
    n_neg += ok && x < 0.f;
  }
  sort_net(s.xs);
  s.nvalid = nvalid;
  s.n_neg = n_neg;
  s.w = Window{0, nvalid, 0, 0, 0, 0, 0};
}

// NO_REJEC, PERCENTILE, SIGMA and MAD: the whole rejection at once.
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ void lane_reject(const Params& a,
                                            Lane<NMAX, WEIGHTED>& s) {
  const int n = a.n, nvalid = s.nvalid, rtype = a.rtype;
  const float siglow = a.siglow, sighigh = a.sighigh;
  Window& w = s.w;
  if (rtype == PERCENTILE) {
    float med = reg_median(s.xs, n, 0, nvalid);
    bool dead = med == 0.f || nvalid <= 1;
    int nl = 0, nh = 0;
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
      if (k < nvalid) {
        float v = s.xs[k];
        if ((med - v) > med * siglow) ++nl;
        if ((v - med) > med * sighigh) ++nh;
      }
    }
    w.lo = dead ? 0 : nl;
    w.hi = dead ? 0 : nvalid - nh;
    w.rejl = dead ? 0 : nl;
    w.rejh = dead ? 0 : nh;
  } else if (rtype == SIGMA || rtype == MAD) {
    float med = reg_median(s.xs, n, 0, nvalid);
    bool dead = med == 0.f || nvalid <= 1;
    bool active = !dead, first = true;
    while (active) {
      float spread = rtype == MAD ? reg_mad(s.xs, w.lo, w.hi, med)
                                  : reg_window_sd(s.xs, n, w.lo, w.hi);
      if (!first) med = reg_median(s.xs, n, w.lo, w.hi);
      first = false;
      active = reg_clip_round(s.xs, n, w, med, spread, siglow, sighigh) &&
               (w.hi - w.lo) > 3;
    }
    if (dead) w.lo = w.hi = w.seg_hi = 0;
  }
}

// A winsorized clipping round begins: its median, σ0 and (L, H).
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_round_start(int n_rows,
                                                 Lane<NMAX, WEIGHTED>& s) {
  s.med = reg_median(s.xs, n_rows, s.w.lo, s.w.hi);
  s.sigma = reg_window_sd(s.xs, n_rows, s.w.lo, s.w.hi);
  s.fn = fmaxf((float)(s.w.hi - s.w.lo), 1.f);
  s.nm1 = fmaxf(s.fn - 1.f, 1.f);
  s.L = -INFINITY;
  s.H = INFINITY;
  s.wm = span_mask(s.w.lo, s.w.hi);
  s.steps = 0;
  return s.w.hi - s.w.lo > 1;
}

// One step of the winsorized σ iteration.  Returns false once σ settled
// or the step bound is reached (then counted in ``capped``).
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_sigma_step(const Params& a,
                                                Lane<NMAX, WEIGHTED>& s) {
  const int n = a.n;
  float m0 = __fmaf_rn(-1.5f, s.sigma, s.med);
  float m1 = __fmaf_rn(1.5f, s.sigma, s.med);
  float L = fminf(fmaxf(s.L, m0), m1);
  float H = fminf(fmaxf(s.H, m0), m1);
  float wv[NMAX];
  float t1 = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        wv[k] = fminf(fmaxf(s.xs[k], L), H);
        if (row_in(s.wm, k)) t1 += wv[k];
      }
    }
  }
  float mean = t1 / s.fn;
  float t2 = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(s.wm, k)) {
          float dv = wv[k] - mean;
          t2 += dv * dv;
        }
      }
    }
  }
  float ns = 1.134f * sqrtf(fmaxf(t2 / s.nm1, 0.f));
  bool conv = fabsf(ns - s.sigma) <= s.sigma * 5e-4f;
  s.L = L;
  s.H = H;
  s.sigma = ns;
  if (conv) return false;
  if (++s.steps < WINSOR_MAX_STEPS) return true;
  if (a.capped != nullptr) atomicAdd(a.capped, 1ULL);
  return false;
}

// One SIGMEDIAN round (rejection_float.c:210-221) on the sorted column:
// the median, the two-pass mean and sd over the valid rows in row order,
// the rejected values replaced by the median and the column sorted again.
// Returns whether the pixel goes on: false once a round replaced nothing,
// or at SIGMEDIAN_MAX_ROUNDS (then counted in ``capped``).
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_sigmedian_round(
    const Params& a, Lane<NMAX, WEIGHTED>& s) {
  const int n = a.n, nvalid = s.nvalid;
  const unsigned vm = span_mask(0, nvalid);
  const float med = reg_median(s.xs, n, 0, nvalid);
  float t = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(vm, k)) t += s.xs[k];
      }
    }
  }
  const float mean = t / s.fn;
  float t2 = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(vm, k)) {
          float d = s.xs[k] - mean;
          t2 += d * d;
        }
      }
    }
  }
  const float sd = nvalid > 1 ? sqrtf(fmaxf(t2 / s.nm1, 0.f)) : 0.f;
  const float tl = sd * a.siglow, th = sd * a.sighigh;
  unsigned rep = 0u;
  int nl = 0, nh = 0;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(vm, k)) {
          const float v = s.xs[k];
          const bool lo = (med - v) > tl, hi = (v - med) > th;
          rep |= (unsigned)(lo || hi) << k;
          nl += lo;
          nh += hi;
        }
      }
    }
  }
  s.w.rejl += nl;
  s.w.rejh += nh;
  if (nl + nh == 0) return false;
  // the replaced rows take the median and the network sorts the column
  // again.  (The low candidates are a prefix of the valid rows and the
  // high ones a suffix, so a merge of the median's copies into the
  // untouched middle gives the same column; built by selects, it ran
  // slower: scripts/k1_variants.py resort_merge, PERF.md §6.)
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (row_in(rep, k)) s.xs[k] = med;
  }
  sort_net(s.xs);
  if (++s.steps < SIGMEDIAN_MAX_ROUNDS) return true;
  if (a.capped != nullptr) atomicAdd(a.capped, 1ULL);
  return false;
}

// One LINEARFIT round (rejection_float.c:259-300) over the kept rows of
// the sorted column, the bits of s.keep: the line y = b + a·pos fitted by
// least squares, pos a value's rank among the kept, σ the mean |residual|;
// the candidates are accepted in row order while the cumulative N-r<=4
// guard allows.  m_x and 1/m_dx2 are the full-size constants
// (median_and_mean.c:1491-1499).  Returns whether the pixel goes on.
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_linearfit_round(
    const Params& a, Lane<NMAX, WEIGHTED>& s) {
  const int n = a.n;
  const unsigned keep = s.keep;
  const int nk = __popc(keep);
  const float nks = fmaxf((float)nk, 1.f), m_x = a.m_x;
  float sy = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(keep, k)) sy += s.xs[k];
      }
    }
  }
  const float m_y = sy / nks;
  float sxy = 0.f, pos = 0.f;  // pos: the rank among the kept, counted
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(keep, k)) {
          sxy += (pos - m_x) * (s.xs[k] - m_y);
          pos += 1.f;
        }
      }
    }
  }
  const float slope = (sxy / nks) * a.inv_mdx2;
  const float icpt = __fmaf_rn(-m_x, slope, m_y);
  float sr = 0.f;
  pos = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(keep, k)) {
          sr += fabsf(s.xs[k] - __fmaf_rn(slope, pos, icpt));
          pos += 1.f;
        }
      }
    }
  }
  const float sigma = sr / nks;
  const float tl = sigma * a.siglow, th = sigma * a.sighigh;
  const int max_acc = max(nk - s.w.r - 4, 0);
  // the residuals again, not kept from the σ pass: kept in registers they
  // cost occupancy or spill (scripts/k1_variants.py resid_regs, PERF.md §6)
  unsigned rej = 0u;
  int rank = 0, nl = 0, nh = 0;
  pos = 0.f;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(keep, k)) {
          const float resid = s.xs[k] - __fmaf_rn(slope, pos, icpt);
          pos += 1.f;
          const bool lo = (-resid) > tl, hi = resid > th;
          rank += lo || hi;
          const bool acc = (lo || hi) && rank <= max_acc;
          rej |= (unsigned)acc << k;
          nl += acc && lo;
          nh += acc && hi;
        }
      }
    }
  }
  s.keep = keep & ~rej;
  s.w.r += nl + nh;
  s.w.rejl += nl;
  s.w.rejh += nh;
  return nl + nh > 0 && (nk - nl - nh) > 3;
}

// A fresh pixel's SIGMEDIAN or LINEARFIT loop: its state before the first
// round, and whether there is a round to run (more than one valid value).
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_loop_start(Lane<NMAX, WEIGHTED>& s) {
  const int nvalid = s.nvalid;
  if constexpr (CLASS == CLASS_SIGMEDIAN) {
    s.fn = fmaxf((float)nvalid, 1.f);
    s.nm1 = fmaxf((float)nvalid - 1.f, 1.f);
    s.steps = 0;
  } else {
    s.keep = span_mask(0, nvalid);
  }
  return nvalid > 1;
}

// One step of a class's loop; false once the lane's pixel is done with it.
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_step(const Params& a,
                                          Lane<NMAX, WEIGHTED>& s) {
  if constexpr (CLASS == CLASS_WINSOR) {
    return lane_sigma_step(a, s);
  } else if constexpr (CLASS == CLASS_SIGMEDIAN) {
    return lane_sigmedian_round(a, s);
  } else if constexpr (CLASS == CLASS_LINEARFIT) {
    return lane_linearfit_round(a, s);
  } else {
    return false;  // the window modes have no steps
  }
}

// The kept rows of the sorted column once the rejection is over.
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ unsigned kept_rows(const Lane<NMAX, WEIGHTED>& s) {
  if constexpr (CLASS == CLASS_SIGMEDIAN) {
    return span_mask(0, s.nvalid);
  } else if constexpr (CLASS == CLASS_LINEARFIT) {
    return s.keep;
  } else {
    return span_mask(s.w.lo, s.w.hi) | span_mask(s.w.seg_lo, s.w.seg_hi);
  }
}

// The (weighted) mean of the kept rows km, written out with the counts.
template <typename T, int NMAX, bool WEIGHTED>
__device__ __forceinline__ void lane_finish(const Params& a,
                                            const float* xcol,
                                            const float* wframe,
                                            const Lane<NMAX, WEIGHTED>& s,
                                            unsigned km) {
  const int n = a.n, nvalid = s.nvalid;
  int rejl = s.w.rejl, rejh = s.w.rejh;
  if (nvalid <= 1) {  // kept <= 1 before rejection: keep as is
    km = span_mask(0, nvalid);
    rejl = rejh = 0;
  }
  float sum = 0.f, pmin = INFINITY, pmax = -INFINITY;
  int nkept = 0;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(km, k)) {
          float v = s.xs[k];
          sum += v;
          ++nkept;
          pmin = fminf(pmin, v);
          pmax = fmaxf(pmax, v);
        }
      }
    }
  }
  float result = sum / (float)max(nkept, 1);
  if constexpr (WEIGHTED) {
    if (nkept > 0) {
      // K1e: weighted mean over the original values in [pmin, pmax];
      // per-frame weights come from shared memory, per-pixel ones are
      // loaded first, all together
      float wt[NMAX];
#pragma unroll
      for (int g = 0; g < NMAX; g += 8) {
        if (g < n) {
#pragma unroll
          for (int k = g; k < g + 8; ++k) {
            wt[k] = a.w_sp == 0 ? wframe[min(k, n - 1)]
                                : __ldg(a.weights + min(k, n - 1) * a.w_sn +
                                        s.px * a.w_sp);
          }
        }
      }
      float wsum = 0.f, wnorm = 0.f, fb = 0.f;
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        float x = k < n ? xcol[k * REG_THREADS] : 0.f;
        if (x >= pmin && x <= pmax && x != 0.f) {
          float wk = wt[k];
          wsum += x * wk;
          wnorm += wk;
          if (x > 0.f) fb += x;
        }
      }
      result = (wnorm != 0.f && wsum != 0.f) ? wsum / wnorm
                                             : fb / (float)nkept;
    }
  }
  if (nkept == 0) {
    // median of the whole column, invalid entries counted as zeros
    int nz = n - nvalid;
    float v[2];
    int ks[2] = {(n - 1) / 2, n / 2};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int k = ks[i];
      int idx = k < s.n_neg ? k : k - nz;
      v[i] = (k >= s.n_neg && k < s.n_neg + nz)
                 ? 0.f
                 : reg_at(s.xs, min(max(idx, 0), n - 1), n);
    }
    result = 0.5f * (v[0] + v[1]);
  }
  a.mean[s.px] = result;
  a.rejl[s.px] = rejl;
  a.rejh[s.px] = rejh;
}

// Every mode but GESDT with the column in registers.  Warps take pixels
// from one counter for the grid (``queue``, zeroed before the launch);
// every lane works its own pixel.  A class with steps (the winsorized σ
// iteration, SIGMEDIAN's and LINEARFIT's rounds) runs them as a warp-wide
// loop of single steps while fewer than its ready count of lanes have
// finished theirs; then those lanes, together, act: a winsorized lane
// clips and starts its next round, any other writes its result and takes
// a new pixel.  A lane whose pixel is done early so works on instead of
// idling until the warp's slowest pixel is done.  Per pixel the
// operations and their order are those of the plain version, whatever
// pixels share a warp.
template <typename T, int NMAX, bool WEIGHTED, int CLASS>
__global__ void __launch_bounds__(REG_THREADS)
    register_kernel(Params a) {
  constexpr int ready = CLASS == CLASS_WINSOR      ? READY_LANES
                        : CLASS == CLASS_SIGMEDIAN ? SIGMEDIAN_READY_LANES
                                                   : LINEARFIT_READY_LANES;
  __shared__ float sc[NMAX], off[NMAX], mu[NMAX];
  __shared__ float xv[WEIGHTED ? NMAX * REG_THREADS : 1];
  __shared__ float wt[NMAX];  // per-frame weights (pixel stride 0)
  const int lane = threadIdx.x & 31;
  float* const xcol = xv + (WEIGHTED ? threadIdx.x : 0);
  const unsigned p1 = (unsigned)a.p;
  for (int k = threadIdx.x; k < a.n; k += blockDim.x) {
    sc[k] = a.scale[k];
    off[k] = a.offset[k];
    mu[k] = a.mul[k];
    if (WEIGHTED && a.w_sp == 0) wt[k] = a.weights[k * a.w_sn];
  }
  __syncthreads();

  Lane<NMAX, WEIGHTED> s;
  bool has = false, stepping = false, done = false;
  for (;;) {
    // the lanes that are not stepping act together until each steps or
    // has run dry: a lane whose steps ended writes its result (winsorized:
    // clips its window, then starts its next round or writes its result);
    // a lane without a pixel takes the next one, loads and sorts it, and
    // starts its steps
    for (;;) {
      const bool act = !stepping && !done;
      if (__ballot_sync(FULL_WARP, act) == 0) break;
      bool round = false;
      if (CLASS != CLASS_WINDOW && act && has) {
        if constexpr (CLASS == CLASS_WINSOR) {
          round = reg_clip_round(s.xs, a.n, s.w, s.med, s.sigma, a.siglow,
                                 a.sighigh) &&
                  (s.w.hi - s.w.lo) > 3;
        }
        if (!round) {
          lane_finish<T>(a, xcol, wt, s, kept_rows<CLASS>(s));
          has = false;
        }
      }
      const unsigned want = __ballot_sync(FULL_WARP, act && !has);
      bool fresh = false;
      if (want != 0) {
        const int leader = __ffs(want) - 1;
        unsigned base = 0;
        if (lane == leader) base = atomicAdd(a.queue, (unsigned)__popc(want));
        base = __shfl_sync(FULL_WARP, base, leader);
        if ((want >> lane) & 1u) {
          unsigned q = base + __popc(want & ((1u << lane) - 1u));
          if (q < p1) {
            s.px = (int)q;
            has = fresh = true;
          } else {
            done = true;
          }
        }
      }
      if (fresh) {
        lane_load<T>(a, sc, off, mu, xcol, s);
        if constexpr (CLASS == CLASS_WINDOW) {
          lane_reject(a, s);
          lane_finish<T>(a, xcol, wt, s, kept_rows<CLASS>(s));
          has = false;
        } else if constexpr (CLASS == CLASS_WINSOR) {
          // a column of at most one value goes to the clip, which keeps it
          round = s.nvalid > 1;
          s.med = s.sigma = 0.f;
        } else {
          // a column of at most one value is written at the next act
          stepping = lane_loop_start<CLASS>(s);
        }
      }
      if (CLASS == CLASS_WINSOR && round) stepping = lane_round_start(a.n, s);
    }
    if (__ballot_sync(FULL_WARP, stepping) == 0) break;  // all lanes done
    // steps until enough lanes wait to act
    for (;;) {
      if (__ballot_sync(FULL_WARP, stepping) == 0) break;
      if (__popc(__ballot_sync(FULL_WARP, has && !stepping)) >= ready) break;
      if (stepping) stepping = lane_step<CLASS>(a, s);
    }
  }
}

template <typename T, int NMAX, bool WEIGHTED, int CLASS>
cudaError_t launch_reg(const Params& a, cudaStream_t stream) {
  auto kernel = register_kernel<T, NMAX, WEIGHTED, CLASS>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      REG_THREADS, 0);
  }
  if (e == cudaSuccess) e = cudaMemsetAsync(a.queue, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return e;
  long long want = ((long long)a.p + REG_THREADS * REG_PIXELS_PER_LANE - 1) /
                   (REG_THREADS * REG_PIXELS_PER_LANE);
  int blocks = (int)std::max(1LL, std::min(want, (long long)sms * per_sm));
  kernel<<<blocks, REG_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool WEIGHTED, int CLASS>
cudaError_t launch_reg_n(const Params& a, cudaStream_t stream) {
  if (a.n <= 8) return launch_reg<T, 8, WEIGHTED, CLASS>(a, stream);
  if (a.n <= 16) return launch_reg<T, 16, WEIGHTED, CLASS>(a, stream);
  if (a.n <= 24) return launch_reg<T, 24, WEIGHTED, CLASS>(a, stream);
  return launch_reg<T, 32, WEIGHTED, CLASS>(a, stream);
}

template <typename T, int CLASS>
cudaError_t launch_reg_w(const Params& a, cudaStream_t stream) {
  return a.weights != nullptr ? launch_reg_n<T, true, CLASS>(a, stream)
                              : launch_reg_n<T, false, CLASS>(a, stream);
}

// One instantiation per column size, weighting and mode class, so that no
// kernel carries another class's code and registers.
template <typename T>
cudaError_t launch_reg_mode(const Params& a, cudaStream_t stream) {
  switch (a.rtype) {
    case WINSORIZED: return launch_reg_w<T, CLASS_WINSOR>(a, stream);
    case SIGMEDIAN: return launch_reg_w<T, CLASS_SIGMEDIAN>(a, stream);
    case LINEARFIT: return launch_reg_w<T, CLASS_LINEARFIT>(a, stream);
    default: return launch_reg_w<T, CLASS_WINDOW>(a, stream);
  }
}

// Whether a call takes the register path: every mode but GESDT at N <= 32.
bool register_path(int n, int rtype) { return n <= 32 && rtype != GESDT; }

// Threads per block when the columns fit shared memory (`arrays`
// [n][threads] float arrays, at least 32 threads), else 0: global scratch
// columns.
int smem_threads(int n, int arrays) {
  int threads = 128;
  while (threads > 32 && arrays * (size_t)n * threads * 4 > SMEM_DEFAULT) {
    threads /= 2;
  }
  return arrays * (size_t)n * threads * 4 <= SMEM_OPTIN ? threads : 0;
}

template <typename T>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  const bool weighted = a.weights != nullptr;
  if (register_path(a.n, a.rtype)) return launch_reg_mode<T>(a, stream);
  const int arrays = column_arrays(a.rtype, weighted);
  int threads = smem_threads(a.n, arrays);
  if (threads > 0) {
    size_t smem = arrays * (size_t)a.n * threads * sizeof(float);
    if (smem > SMEM_DEFAULT) {
      cudaError_t e = cudaFuncSetAttribute(
          reject_stack_kernel<T, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    int blocks = (a.p + threads - 1) / threads;
    reject_stack_kernel<T, false><<<blocks, threads, smem, stream>>>(
        a, 0, a.p);
    return cudaGetLastError();
  }
  if (a.scratch == nullptr || a.cols <= 0) return cudaErrorInvalidValue;
  threads = 128;
  for (int p0 = 0; p0 < a.p; p0 += a.cols) {
    int p1 = std::min(a.p, p0 + a.cols);
    int blocks = (p1 - p0 + threads - 1) / threads;
    reject_stack_kernel<T, true><<<blocks, threads, 0, stream>>>(a, p0, p1);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Whether a call of n frames in mode rtype (weighted or not) needs a
// global scratch buffer of 2 * n * cols floats: its columns fit neither
// registers nor shared memory.
extern "C" int siril_reject_stack_needs_scratch(int n, int rtype,
                                                int weighted) {
  return !register_path(n, rtype) &&
         smem_threads(n, column_arrays(rtype, weighted != 0)) == 0;
}

// C entry point bound through ctypes.  Pointers are device pointers
// (`weights` may be null, `critical` is read only by GESDT, `scratch` only
// when siril_reject_stack_needs_scratch says so; `capped`, when not null,
// is a 64-bit counter to which SIGMEDIAN adds one for every pixel whose
// loop stopped at SIGMEDIAN_MAX_ROUNDS and WINSORIZED one for every
// clipping round whose σ iteration stopped at WINSOR_MAX_STEPS; `queue`
// is a 32-bit word for the register path's pixel counter, which the
// launch sets to 0 on `stream` first); the launches go on `stream` and do
// not synchronize.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int siril_reject_stack(
    const void* stack, int is_i16, int n, int p, const void* scale,
    const void* offset, const void* mul, const void* weights,
    long long w_stride_n, long long w_stride_p, const void* critical,
    int rtype, int mode, float siglow, float sighigh, int n_full,
    int max_outliers, float m_x, float inv_mdx2, void* mean, void* rejl,
    void* rejh, void* scratch, int cols, void* capped, void* queue,
    void* stream) {
  if (n <= 0 || p <= 0 || rtype < NO_REJEC || rtype > GESDT) {
    return (int)cudaErrorInvalidValue;
  }
  if (rtype == GESDT && critical == nullptr) return (int)cudaErrorInvalidValue;
  if (register_path(n, rtype) && queue == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Params a{stack, n, p, (const float*)scale, (const float*)offset,
           (const float*)mul, (const float*)weights, w_stride_n,
           w_stride_p, (const float*)critical, rtype, mode, siglow,
           sighigh, n_full, max_outliers, m_x, inv_mdx2, (float*)mean,
           (int*)rejl, (int*)rejh, (float*)scratch, cols,
           (unsigned long long*)capped, (unsigned*)queue};
  auto fn = is_i16 ? &launch<int16_t> : &launch<float>;
  return (int)fn(a, (cudaStream_t)stream);
}
