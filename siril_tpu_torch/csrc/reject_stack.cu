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
// pallas_reject_mean (pallas_call at :804, body _build_kernel :202; K1b
// :478, K1c :521, K1d :586, K1e :719).  Its plain PyTorch version is
// siril_tpu_torch/ops/stacking.py::reject_stack_plain.
//
// Design for Hopper, not a block-by-block copy of the Pallas kernel:
// - one thread per pixel column, so every pixel iterates and converges on
//   its own (the Pallas tile iterated until its slowest lane converged);
// - the column's N values live in shared memory laid out [N][threads]
//   (element k of thread t at k*threads + t): consecutive threads hit
//   consecutive banks, free of bank conflicts.  When two such arrays do
//   not fit a block of 32 threads (N > 908), the columns live in a global
//   scratch buffer laid out [N][cols] instead, coalesced across threads,
//   and the launcher walks the pixels in chunks of `cols` columns;
// - values are insertion-sorted as they are loaded, in place of the
//   pltpu.roll bitonic network.  The second array holds the MAD
//   deviations, the winsorized accumulated values, or the keep flags of
//   the mask modes (LINEARFIT, GESDT), whose ranks and N-r<=4 guard come
//   from running counts in the thread's serial loop instead of the
//   Hillis-Steele prefix sums;
// - SIGMEDIAN re-sorts the column in place after each replacement round
//   (insertion sort of a nearly sorted column);
// - GESDT reads its λ table through the read-only cache; pass 1 records
//   only the last flagged walk step, pass 2 replays the walk;
// - the weighted mean re-reads the column's original values from global
//   memory (a second read of the stack, mostly from L2, which the
//   function does not need and the bound does not count) and the weights
//   through their (frame, pixel) strides: per-frame weights come with a
//   pixel stride of 0 and are never materialized per pixel.
//
// What bounds it on an H100: one read of the stack (4 or 2 bytes per
// value), the weights actually read, and 12 bytes written per pixel is
// ~90 us of HBM time for a main-path block (24 x 2.8 Mpix f32).  The
// arithmetic the data needs (the rejection loops and the sort) is less
// than that at the f32 peak, so memory sets the bound.  The kernel runs
// well above it: each thread's serial loop over shared memory, not either
// roofline, limits it.
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

// ops/rejection.py SIGMEDIAN_MAX_ROUNDS
constexpr int SIGMEDIAN_MAX_ROUNDS = 1000;

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
  unsigned long long* capped;  // SIGMEDIAN pixels stopped at the round cap
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

// Iterated winsorized sigma (rejection_float.c:222-236) with the
// reference's schedule: 3 plain steps, a guarded Aitken jump, the freeze
// check, at most 48 steps.  w holds the accumulated clipped values.
__device__ float winsor_sd(Col xs, Col w, int lo, int hi, float med) {
  float sigma = window_sd(xs, lo, hi);
  float n = fmaxf((float)(hi - lo), 1.f);
  float nm1 = fmaxf(n - 1.f, 1.f);
  for (int k = lo; k < hi; ++k) w[k] = xs[k];
  float h1 = sigma + 1.f, h2 = 0.f;
  bool frozen = (hi - lo) <= 1;
  for (int it = 0; !frozen && it < 48; it += 3) {
    for (int s = 0; s < 3 && !frozen; ++s) {
      float m0 = __fmaf_rn(-1.5f, sigma, med);
      float m1 = __fmaf_rn(1.5f, sigma, med);
      float t1 = 0.f;
      for (int k = lo; k < hi; ++k) {
        float v = fminf(fmaxf(w[k], m0), m1);
        w[k] = v;
        t1 += v;
      }
      float mean = t1 / n;
      float t2 = 0.f;
      for (int k = lo; k < hi; ++k) {
        float dv = w[k] - mean;
        t2 += dv * dv;
      }
      float ns = 1.134f * sqrtf(fmaxf(t2 / nm1, 0.f));
      frozen = fabsf(ns - sigma) <= sigma * 5e-4f;
      h2 = h1;
      h1 = sigma;
      sigma = ns;
    }
    if (frozen) break;
    float den = sigma - 2.f * h1 + h2;
    float num = (sigma - h1) * (sigma - h1);
    bool ok = fabsf(den) > 1e-12f;
    float sa = sigma - num / (ok ? den : 1.f);
    if (ok && sa > 0.f && fabsf(sa - sigma) < sigma) sigma = sa;
  }
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

template <typename T, bool GLOBAL>
__global__ void reject_stack_kernel(Params a, int p0, int p1) {
  extern __shared__ float smem[];
  int t = threadIdx.x;
  int px = p0 + blockIdx.x * blockDim.x + t;
  if (px >= p1) return;
  const int n = a.n;
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
      float sig = winsor_sd(xs, aux, w.lo, w.hi, med);
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
      float x = load_value<T>(a, k, px);
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

// Threads per block when the columns fit shared memory (two [n][threads]
// float arrays, at least 32 threads), else 0: global scratch columns.
int smem_threads(int n) {
  int threads = 128;
  while (threads > 32 && 2 * (size_t)n * threads * 4 > SMEM_DEFAULT) {
    threads /= 2;
  }
  return 2 * (size_t)n * threads * 4 <= SMEM_OPTIN ? threads : 0;
}

template <typename T>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  int threads = smem_threads(a.n);
  if (threads > 0) {
    size_t smem = 2 * (size_t)a.n * threads * sizeof(float);
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

// Threads per block of the shared-memory layout for n frames, or 0 when
// the kernel needs a global scratch buffer of 2 * n * cols floats.
extern "C" int siril_reject_stack_smem_threads(int n) {
  return smem_threads(n);
}

// C entry point bound through ctypes.  Pointers are device pointers
// (`weights` may be null, `critical` is read only by GESDT, `scratch` only
// when siril_reject_stack_smem_threads(n) is 0; `capped`, when not null,
// is a 64-bit counter to which SIGMEDIAN adds one for every pixel whose
// loop stopped at SIGMEDIAN_MAX_ROUNDS); the launches go on `stream` and
// do not synchronize.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int siril_reject_stack(
    const void* stack, int is_i16, int n, int p, const void* scale,
    const void* offset, const void* mul, const void* weights,
    long long w_stride_n, long long w_stride_p, const void* critical,
    int rtype, int mode, float siglow, float sighigh, int n_full,
    int max_outliers, float m_x, float inv_mdx2, void* mean, void* rejl,
    void* rejh, void* scratch, int cols, void* capped, void* stream) {
  if (n <= 0 || p <= 0 || rtype < NO_REJEC || rtype > GESDT) {
    return (int)cudaErrorInvalidValue;
  }
  if (rtype == GESDT && critical == nullptr) return (int)cudaErrorInvalidValue;
  Params a{stack, n, p, (const float*)scale, (const float*)offset,
           (const float*)mul, (const float*)weights, w_stride_n,
           w_stride_p, (const float*)critical, rtype, mode, siglow,
           sighigh, n_full, max_outliers, m_x, inv_mdx2, (float*)mean,
           (int*)rejl, (int*)rejh, (float*)scratch, cols,
           (unsigned long long*)capped};
  auto fn = is_i16 ? &launch<int16_t> : &launch<float>;
  return (int)fn(a, (cudaStream_t)stream);
}
