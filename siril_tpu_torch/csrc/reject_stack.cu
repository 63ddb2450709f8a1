// Fused normalize + reject + mean over an (N, P) frame stack: kernel K1,
// every rejection mode on float32 or raw int16 input, with every
// normalization mode and optional weights.
//   K1a  window modes: NO_REJEC, PERCENTILE, SIGMA, MAD, WINSORIZED
//   K1b  SIGMEDIAN  (values replaced by the running median, re-sorted)
//   K1c  LINEARFIT  (line fit over the kept ranks, mask keep set)
//   K1d  GESDT      (generalized ESD walk, then its confirmations)
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
// 1. Registers: every mode at N <= 32, and past that up to 48 or 64
//    frames where the columns still fit the registers with no spill and
//    beat the column kernel (REGISTER_FRAMES, by mode and weighting).
//    register_kernel is templated on NMAX = 8, 16, 24, 32, 48, 64, on the
//    weighting, and on the mode class: the window modes, winsorized,
//    SIGMEDIAN, LINEARFIT, GESDT, so that no kernel carries another
//    class's code and registers.
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
//    - LINEARFIT's and GESDT's keep sets are one row mask (32 bits, or
//      64 past 32 frames); a kept value's rank is a running count over
//      the mask, and LINEARFIT's N-r<=4 guard accepts the candidates in
//      row order through a running candidate count.
//    - GESDT walks once with its window sums and records each step's side
//      in a mask; the confirmations replay the walk from that mask, with
//      no sums.  Its λ table is staged in shared memory.
//    - Against divergence, warps take pixels from one counter for the
//      whole grid, and each warp runs its loop (the σ iteration, or the
//      SIGMEDIAN or LINEARFIT rounds) as a loop of single steps; when a
//      ready count of its lanes (per class) are done, those lanes act
//      together (winsorized: clip and start the next round; any class:
//      write the result and take the next pixel), while the others keep
//      their state.  A lane whose pixel is done early so works on instead
//      of idling until the warp's slowest pixel is done, and no block
//      idles while others still have pixels to take.  The window modes
//      and GESDT (the same number of walk steps in every pixel) run
//      without the vote.
//    - A weighted mean keeps the normalized column in frame order in
//      shared memory: the stack is read once.  Per-frame weights (pixel
//      stride 0) are staged in shared memory, never materialized per
//      pixel.
//    - The column is read straight from global memory: the lanes of a
//      warp that take pixels together get consecutive ones, so each row
//      read is a run of consecutive words.  Results are stored per pixel.
// 2. Columns: every mode past its register limit (column_kernel).  A
//    block of 128 threads takes tiles of C = 16, 32, 64 or 128
//    consecutive pixels from a counter for the grid (C: the most columns
//    resident on an SM, from the 227 KB a block may opt in to; 16 where
//    only one 32-column tile fits, as at N = 1000).
//    - The tile lives in shared memory laid out [row][C]: row r of the
//      tile is a run of C consecutive words of stack row r, loaded by the
//      whole block, in batches whose loads are all issued first, and
//      normalized on the way in, each column's valid and negative values
//      counted as they come.  The block then sorts every column with
//      the odd-even merge network (padded with +inf): its first five
//      stages by sorting runs of 32 rows in registers, one run a thread,
//      the others with their comparators shared among the threads; and
//      one thread a column rejects and writes the result.
//    - No second value array but a weighted mean's original values (frame
//      order): MAD finds the median deviation by merging the two runs of
//      deviations either side of the median, LINEARFIT and GESDT keep one
//      bit a row, SIGMEDIAN re-sorts by merging the median's copies into
//      the untouched middle of its column.
//    - Up to 44 frames the network's last stage is replaced by inserting
//      the rows past 32 (themselves sorted) into the first 32, one thread
//      a column.
//    - Past the frames a 32-column tile holds in shared memory (1698, or
//      875 with a weighted mean), the tile lives in a global scratch slab
//      of the block, laid out the same way (a warp's row read is one
//      128-byte line); it is loaded and sorted in shared-memory chunks of
//      128 rows, and the network's stages across chunks run in the slab.
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
#include <type_traits>

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

// shared memory a block may opt in to on Hopper (232,448 bytes), less a
// margin for the kernels' static shared memory
constexpr size_t SMEM_OPTIN = 227 * 1024;
constexpr size_t SMEM_DYNAMIC_MAX = SMEM_OPTIN - 1280;

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
  float* scratch;            // global tile slabs when shared memory is short
  int cols;                  // scratch: (2 n + 2 ceil(n/32)) cols floats
  unsigned long long* capped;  // loops stopped at their mode's bound
  unsigned* queue;             // the next pixel (registers) or tile to hand out
};

struct Window {
  int lo, hi, r, rejl, rejh, seg_lo, seg_hi;
};

// Normalize frame k's raw value x with the per-frame coefficients sc, off
// and mu (shared or global memory).
template <typename T>
__device__ __forceinline__ float norm_value(const Params& a, const float* sc,
                                            const float* off,
                                            const float* mu, int k,
                                            float x) {
  float s = sc[k];
  if (sizeof(T) == 2) {
    x = x + 32768.f;
    if (a.mode == NO_NORM) x = x * INV_U16;
    else s = s * INV_U16;   // decode folded into the scale
  }
  if (a.mode == ADDITIVE || a.mode == ADDITIVE_SCALING) {
    float o = __fmaf_rn(x, s, -off[k]);
    x = x != 0.f ? o : 0.f;
  } else if (a.mode != NO_NORM) {
    x = x * s * mu[k];
  }
  return x;
}

// ---------------------------------------------------------------------------
// The register path: every mode at N <= 32 frames
// ---------------------------------------------------------------------------

// The most frames of the register path, by mode and by weighting
// (unweighted, weighted): up to 64 where its columns were faster than the
// column kernel's (scripts/k1_variants.py, PERF.md §6) and no
// instantiation spills (chip_smoke.py's build phase).
constexpr int REGISTER_FRAMES[8][2] = {
    {64, 64},  // NO_REJEC
    {64, 64},  // PERCENTILE
    {32, 32},  // SIGMA
    {32, 32},  // MAD
    {48, 32},  // SIGMEDIAN
    {48, 48},  // WINSORIZED
    {64, 48},  // LINEARFIT
    {64, 64},  // GESDT
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

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
constexpr int CLASS_GESDT = 4;      // no vote: the walk, then the replay

// The largest column a class's kernel is instantiated for.
__host__ __device__ constexpr int class_frames(int cls, bool w) {
  return cls == CLASS_WINSOR      ? REGISTER_FRAMES[WINSORIZED][w]
         : cls == CLASS_SIGMEDIAN ? REGISTER_FRAMES[SIGMEDIAN][w]
         : cls == CLASS_LINEARFIT ? REGISTER_FRAMES[LINEARFIT][w]
         : cls == CLASS_GESDT     ? REGISTER_FRAMES[GESDT][w]
                                  : cmax(cmax(REGISTER_FRAMES[NO_REJEC][w],
                                              REGISTER_FRAMES[PERCENTILE][w]),
                                         cmax(REGISTER_FRAMES[SIGMA][w],
                                              REGISTER_FRAMES[MAD][w]));
}

// A warp leaves its steps once this many lanes wait to act, per class.
// Winsorized, on the main-path block: 16 refills too often and 32 lets
// lanes idle too long (scripts/k1_variants.py; PERF.md §6).
constexpr int READY_LANES = 24;
// SIGMEDIAN and LINEARFIT, the best of thresholds from 4 to 32 at the
// stack command's call size (32 is lockstep with the queue).
constexpr int SIGMEDIAN_READY_LANES = 8;
constexpr int LINEARFIT_READY_LANES = 24;

// A row mask, bit k for sorted row k: 32 bits, or 64 for a column of more
// than 32 rows.
template <int NMAX>
using RowMask =
    typename std::conditional<(NMAX > 32), unsigned long long, unsigned>::type;

// Bits [0, n) of a row mask, 0 <= n <= its width.
template <typename M>
__device__ __forceinline__ M low_rows(int n) {
  if constexpr (sizeof(M) == 4) {
    return (M)((1ull << n) - 1ull);
  } else {
    return n >= 64 ? ~0ull : (1ull << n) - 1ull;
  }
}

// Bits [lo, hi) of a row mask (empty when hi <= lo).
template <typename M>
__device__ __forceinline__ M span_mask(int lo, int hi) {
  return low_rows<M>(hi) & ~low_rows<M>(lo);
}

template <typename M>
__device__ __forceinline__ bool row_in(M mask, int k) {
  return (mask >> k) & 1u;
}

template <typename M>
__device__ __forceinline__ int popcount(M mask) {
  if constexpr (sizeof(M) == 4) {
    return __popc(mask);
  } else {
    return __popcll(mask);
  }
}

// Register arrays are padded to a power of two for the networks below.
// (Every loop over them has a constant trip count, so that it unrolls and
// no array is indexed at run time.)
__host__ __device__ constexpr int pow2_up(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 64;
}

__host__ __device__ constexpr int log2_of(int p2) {
  return p2 == 8 ? 3 : p2 == 16 ? 4 : p2 == 32 ? 5 : 6;
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

// Σx and Σx² over the rows of wm, in row order.  Loops over rows k < n
// skip whole groups of 8 past the frame count n (the same n for every
// lane, so the skip does not diverge).
template <int NMAX>
__device__ __forceinline__ void reg_sums(const float (&xs)[NMAX], int n_rows,
                                         RowMask<NMAX> wm, float& t1,
                                         float& t2) {
  t1 = 0.f;
  t2 = 0.f;
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
}

// Sample sd (N-1) of the window [lo, hi), one-pass as in the reference.
template <int NMAX>
__device__ __forceinline__ float reg_window_sd(const float (&xs)[NMAX],
                                               int n_rows, int lo, int hi) {
  float t1, t2;
  reg_sums(xs, n_rows, span_mask<RowMask<NMAX>>(lo, hi), t1, t2);
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
  const RowMask<NMAX> wm = span_mask<RowMask<NMAX>>(lo, hi);
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
  const RowMask<NMAX> wm = span_mask<RowMask<NMAX>>(w.lo, w.hi);
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
// (fn, nm1, steps), LINEARFIT's keep mask (keep, with its rejections in
// w.r) or GESDT's walk (the window w.lo, w.hi, the steps, the last
// flagged step, the side of each step in high, then keep).  A class's
// kernel keeps only the fields its code reads.
template <int NMAX, bool WEIGHTED>
struct Lane {
  float xs[NMAX];
  int px, nvalid, n_neg;
  Window w;
  float med, sigma, L, H, fn, nm1;
  RowMask<NMAX> wm, keep, high;
  int steps, last_flag;
};

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
    // (no code for a column larger than the mode's register limit)
    constexpr int sigma_rows = REGISTER_FRAMES[SIGMA][WEIGHTED];
    constexpr int mad_rows = REGISTER_FRAMES[MAD][WEIGHTED];
    if constexpr (NMAX <= cmax(sigma_rows, mad_rows)) {
      float med = reg_median(s.xs, n, 0, nvalid);
      bool dead = med == 0.f || nvalid <= 1;
      bool active = !dead, first = true;
      while (active) {
        float spread;
        if constexpr (NMAX <= mad_rows) {
          spread = rtype == MAD ? reg_mad(s.xs, w.lo, w.hi, med)
                                : reg_window_sd(s.xs, n, w.lo, w.hi);
        } else {
          spread = reg_window_sd(s.xs, n, w.lo, w.hi);
        }
        if (!first) med = reg_median(s.xs, n, w.lo, w.hi);
        first = false;
        active = reg_clip_round(s.xs, n, w, med, spread, siglow, sighigh) &&
                 (w.hi - w.lo) > 3;
      }
      if (dead) w.lo = w.hi = w.seg_hi = 0;
    }
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
  s.wm = span_mask<RowMask<NMAX>>(s.w.lo, s.w.hi);
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
  using Mask = RowMask<NMAX>;
  const int n = a.n, nvalid = s.nvalid;
  const Mask vm = span_mask<Mask>(0, nvalid);
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
  Mask rep = 0;
  int nl = 0, nh = 0;
#pragma unroll
  for (int g = 0; g < NMAX; g += 8) {
    if (g < n) {
#pragma unroll
      for (int k = g; k < g + 8; ++k) {
        if (row_in(vm, k)) {
          const float v = s.xs[k];
          const bool lo = (med - v) > tl, hi = (v - med) > th;
          rep |= (Mask)(lo || hi) << k;
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
  using Mask = RowMask<NMAX>;
  const int n = a.n;
  const Mask keep = s.keep;
  const int nk = popcount(keep);
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
  Mask rej = 0;
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
          rej |= (Mask)acc << k;
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

// GESDT (rejection_float.c:302-345 + confirm_outliers, median_and_mean.c:
// 685-701) on the sorted column.  The walk: each step takes the Grubbs
// statistic of the current window [lo, hi) and removes its farther end
// (the low end on a tie), while the budget and the window allow; the
// confirmed steps are those up to the last flagged one (and at least
// step 1).  The walk runs once, with its sums, and records each step's
// side in s.high; the confirmations replay it from those bits alone (the
// plain version's second pass recomputes sums whose statistic it never
// reads).  A fresh pixel's walk: no row rejected yet, and whether it has
// a step to take.
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_gesdt_start(const Params& a,
                                                 Lane<NMAX, WEIGHTED>& s) {
  s.keep = span_mask<RowMask<NMAX>>(0, s.nvalid);
  s.high = 0;
  s.steps = 0;
  s.last_flag = -1;
  return a.max_outliers - (a.n_full - s.nvalid) > 0 && s.nvalid > 1;
}

// The confirmations: the walk replayed from its sides, each confirmed
// step's removed value counted against the median, its row cleared from
// keep (a high removal clears the shrunk-array index size - 1,
// rejection_float.c:332).
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ void lane_gesdt_replay(const Params& a,
                                                  Lane<NMAX, WEIGHTED>& s) {
  using Mask = RowMask<NMAX>;
  const int n = a.n, M = max(a.max_outliers, 1);
  const float median0 = reg_median(s.xs, n, 0, s.nvalid);
  const int nconf = min(s.steps, max(s.last_flag, min(1, M - 1)) + 1);
  Mask keep = s.keep;
  int lo = 0, hi = s.nvalid, rejl = 0, rejh = 0;
  for (int j = 0; j < nconf; ++j) {
    const bool th = row_in(s.high, j);
    if (reg_at(s.xs, th ? hi - 1 : lo, n) >= median0) ++rejh;
    else ++rejl;
    keep &= ~((Mask)1 << (th ? hi - lo - 1 : lo));
    if (th) --hi;
    else ++lo;
  }
  s.keep = keep;
  s.w.rejl = rejl;
  s.w.rejh = rejh;
}

// One step of the walk, with its window sums; the last one replays the
// walk.  Returns whether the walk goes on.
template <int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_gesdt_step(const Params& a,
                                                const float* lam,
                                                Lane<NMAX, WEIGHTED>& s) {
  using Mask = RowMask<NMAX>;
  const int n = a.n, lo = s.w.lo, hi = s.w.hi, j = s.steps;
  const int M = max(a.max_outliers, 1), removed = a.n_full - s.nvalid;
  float t1, t2;
  reg_sums(s.xs, n, span_mask<Mask>(lo, hi), t1, t2);
  const float size = (float)(hi - lo);
  const float mean = t1 / fmaxf(size, 1.f);
  const float var = __fmaf_rn(-t1, mean, t2) / fmaxf(size - 1.f, 1.f);
  const float sd = size > 1.f ? sqrtf(fmaxf(var, 0.f)) : 0.f;
  const float dev_low = mean - reg_at(s.xs, lo, n);
  const float dev_high = reg_at(s.xs, max(hi - 1, 0), n) - mean;
  const bool take_high = dev_high > dev_low;  // strict > (grubbs_stat:88-96)
  const float g = (take_high ? dev_high : dev_low) / fmaxf(sd, 1e-30f);
  const int li = min(removed + j, M - 1);
  const float lam_j = (unsigned)li < (unsigned)NMAX ? lam[li]
                                                    : __ldg(a.crit + li);
  if (hi - lo > 2 && g > lam_j) s.last_flag = j;
  s.high |= (Mask)take_high << j;
  if (take_high) s.w.hi = hi - 1;
  else s.w.lo = lo + 1;
  s.steps = j + 1;
  if (s.steps < min(M, a.max_outliers - removed) && s.w.hi - s.w.lo > 1) {
    return true;
  }
  lane_gesdt_replay(a, s);
  return false;
}

// A fresh pixel's SIGMEDIAN, LINEARFIT or GESDT loop: its state before
// the first step, and whether there is a step to run (for SIGMEDIAN and
// LINEARFIT, more than one valid value).
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_loop_start(const Params& a,
                                                Lane<NMAX, WEIGHTED>& s) {
  const int nvalid = s.nvalid;
  if constexpr (CLASS == CLASS_SIGMEDIAN) {
    s.fn = fmaxf((float)nvalid, 1.f);
    s.nm1 = fmaxf((float)nvalid - 1.f, 1.f);
    s.steps = 0;
  } else if constexpr (CLASS == CLASS_GESDT) {
    return lane_gesdt_start(a, s);
  } else {
    s.keep = span_mask<RowMask<NMAX>>(0, nvalid);
  }
  return nvalid > 1;
}

// One step of a class's loop; false once the lane's pixel is done with it.
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ bool lane_step(const Params& a, const float* lam,
                                          Lane<NMAX, WEIGHTED>& s) {
  if constexpr (CLASS == CLASS_WINSOR) {
    return lane_sigma_step(a, s);
  } else if constexpr (CLASS == CLASS_SIGMEDIAN) {
    return lane_sigmedian_round(a, s);
  } else if constexpr (CLASS == CLASS_LINEARFIT) {
    return lane_linearfit_round(a, s);
  } else if constexpr (CLASS == CLASS_GESDT) {
    return lane_gesdt_step(a, lam, s);
  } else {
    return false;  // the window modes have no steps
  }
}

// The kept rows of the sorted column once the rejection is over.
template <int CLASS, int NMAX, bool WEIGHTED>
__device__ __forceinline__ RowMask<NMAX> kept_rows(
    const Lane<NMAX, WEIGHTED>& s) {
  using Mask = RowMask<NMAX>;
  if constexpr (CLASS == CLASS_SIGMEDIAN) {
    return span_mask<Mask>(0, s.nvalid);
  } else if constexpr (CLASS == CLASS_LINEARFIT || CLASS == CLASS_GESDT) {
    return s.keep;
  } else {
    return span_mask<Mask>(s.w.lo, s.w.hi) |
           span_mask<Mask>(s.w.seg_lo, s.w.seg_hi);
  }
}

// The (weighted) mean of the kept rows km, written out with the counts.
template <typename T, int NMAX, bool WEIGHTED>
__device__ __forceinline__ void lane_finish(const Params& a,
                                            const float* xcol,
                                            const float* wframe,
                                            const Lane<NMAX, WEIGHTED>& s,
                                            RowMask<NMAX> km) {
  const int n = a.n, nvalid = s.nvalid;
  int rejl = s.w.rejl, rejh = s.w.rejh;
  if (nvalid <= 1) {  // kept <= 1 before rejection: keep as is
    km = span_mask<RowMask<NMAX>>(0, nvalid);
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

// Every mode with the column in registers.  Warps take pixels from one
// counter for the grid (``queue``, zeroed before the launch); every lane
// works its own pixel.  A class with steps (the winsorized σ iteration,
// SIGMEDIAN's and LINEARFIT's rounds) runs them as a warp-wide loop of
// single steps while fewer than its ready count of lanes have finished
// theirs; then those lanes, together, act: a winsorized lane clips and
// starts its next round, any other writes its result and takes a new
// pixel.  A lane whose pixel is done early so works on instead of idling
// until the warp's slowest pixel is done.  The window modes and GESDT
// reject as they load.  Per pixel the operations and their order are
// those of the plain version, whatever pixels share a warp.
template <typename T, int NMAX, bool WEIGHTED, int CLASS>
__global__ void __launch_bounds__(REG_THREADS)
    register_kernel(Params a) {
  constexpr int ready = CLASS == CLASS_WINSOR      ? READY_LANES
                        : CLASS == CLASS_SIGMEDIAN ? SIGMEDIAN_READY_LANES
                                                   : LINEARFIT_READY_LANES;
  __shared__ float sc[NMAX], off[NMAX], mu[NMAX];
  __shared__ float xv[WEIGHTED ? NMAX * REG_THREADS : 1];
  __shared__ float wt[NMAX];  // per-frame weights (pixel stride 0)
  __shared__ float lam[CLASS == CLASS_GESDT ? NMAX : 1];  // GESDT λ table
  const int lane = threadIdx.x & 31;
  float* const xcol = xv + (WEIGHTED ? threadIdx.x : 0);
  const unsigned p1 = (unsigned)a.p;
  for (int k = threadIdx.x; k < a.n; k += blockDim.x) {
    sc[k] = a.scale[k];
    off[k] = a.offset[k];
    mu[k] = a.mul[k];
    if (WEIGHTED && a.w_sp == 0) wt[k] = a.weights[k * a.w_sn];
  }
  if constexpr (CLASS == CLASS_GESDT) {
    const int nlam = min(max(a.max_outliers, 1), NMAX);
    for (int k = threadIdx.x; k < nlam; k += blockDim.x) lam[k] = a.crit[k];
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
        if constexpr (CLASS == CLASS_WINDOW || CLASS == CLASS_GESDT) {
          if constexpr (CLASS == CLASS_GESDT) {
            if (lane_gesdt_start(a, s)) {
              while (lane_gesdt_step(a, lam, s)) {
              }
            }
          } else {
            lane_reject(a, s);
          }
          lane_finish<T>(a, xcol, wt, s, kept_rows<CLASS>(s));
          has = false;
        } else if constexpr (CLASS == CLASS_WINSOR) {
          // a column of at most one value goes to the clip, which keeps it
          round = s.nvalid > 1;
          s.med = s.sigma = 0.f;
        } else {
          // a column of at most one value is written at the next act
          stepping = lane_loop_start<CLASS>(a, s);
        }
      }
      if (CLASS == CLASS_WINSOR && round) stepping = lane_round_start(a.n, s);
    }
    if (__ballot_sync(FULL_WARP, stepping) == 0) break;  // all lanes done
    // steps until enough lanes wait to act
    for (;;) {
      if (__ballot_sync(FULL_WARP, stepping) == 0) break;
      if (__popc(__ballot_sync(FULL_WARP, has && !stepping)) >= ready) break;
      if (stepping) stepping = lane_step<CLASS>(a, lam, s);
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

// One instantiation per column size up to the class's largest.
template <typename T, bool WEIGHTED, int CLASS>
cudaError_t launch_reg_n(const Params& a, cudaStream_t stream) {
  constexpr int top = class_frames(CLASS, WEIGHTED);
  if (a.n <= 8) return launch_reg<T, 8, WEIGHTED, CLASS>(a, stream);
  if (a.n <= 16) return launch_reg<T, 16, WEIGHTED, CLASS>(a, stream);
  if (a.n <= 24) return launch_reg<T, 24, WEIGHTED, CLASS>(a, stream);
  if (top <= 32 || a.n <= 32) {
    return launch_reg<T, 32, WEIGHTED, CLASS>(a, stream);
  }
  if constexpr (top >= 48) {
    if (top <= 48 || a.n <= 48) {
      return launch_reg<T, 48, WEIGHTED, CLASS>(a, stream);
    }
  }
  if constexpr (top >= 64) return launch_reg<T, 64, WEIGHTED, CLASS>(a, stream);
  return cudaErrorInvalidValue;
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
    case GESDT: return launch_reg_w<T, CLASS_GESDT>(a, stream);
    default: return launch_reg_w<T, CLASS_WINDOW>(a, stream);
  }
}

// Whether a call takes the register path: up to its mode's and
// weighting's REGISTER_FRAMES.
bool register_path(int n, int rtype, bool weighted) {
  return n <= REGISTER_FRAMES[rtype][weighted];
}

// ---------------------------------------------------------------------------
// The column path: every mode at N > 32 frames, one thread a column
// ---------------------------------------------------------------------------

constexpr int COL_THREADS = 128;
// loads of a tile a thread issues before it uses one
constexpr int LOAD_BATCH = 8;
// the global layout's chunks: rows loaded and sorted in shared memory
constexpr int CHUNK_ROWS = 128;
constexpr int LOG2_CHUNK_ROWS = 7;
// Up to 32 + INSERT_ROWS frames the network's last stage (the merge of
// two runs of 32 rows) is replaced by inserting the second run's rows into
// the first, one thread a column: at N = 33 that stage sorts one row into
// 32.  Measured faster up to 44 frames, slower at 48
// (scripts/k1_variants.py, PERF.md §6).
constexpr int INSERT_ROWS = 12;

__host__ __device__ inline int bit_words(int n) { return (n + 31) >> 5; }

__host__ __device__ inline int ceil_log2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Floats of a tile of 2^lc columns: the sorted values, a weighted mean's
// original values, and two bit arrays (the keep flags of LINEARFIT and
// GESDT, GESDT's walk sides), each laid out [row][column].
__host__ __device__ inline size_t tile_floats(int n, int lc, bool weighted) {
  return (((size_t)(weighted ? 2 : 1) * n + 2 * (size_t)bit_words(n)) << lc);
}

// One pixel column of a tile: element k at p[k * stride].
struct Col {
  float* p;
  int stride;
  __device__ float& operator[](int k) const {
    return p[(size_t)k * stride];
  }
};

// One bit a row of a column: row k in bit k % 32 of word k / 32, word w
// at p[w * stride].
struct Bits {
  unsigned* p;
  int stride;
  __device__ unsigned& word(int w) const { return p[(size_t)w * stride]; }
  __device__ bool get(int k) const { return (word(k >> 5) >> (k & 31)) & 1u; }
  __device__ void clear(int k) const { word(k >> 5) &= ~(1u << (k & 31)); }
  // rows [0, m) set, the others clear, over n rows
  __device__ void set_prefix(int n, int m) const {
    for (int w = 0; w < bit_words(n); ++w) {
      const int b = m - 32 * w;
      word(w) = b >= 32 ? ~0u : b <= 0 ? 0u : (1u << b) - 1u;
    }
  }
};

// The first row in [lo, hi) of the sorted column whose value is >= v
// (hi when there is none).
__device__ int lower_bound(Col xs, int lo, int hi, float v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xs[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ float window_median(Col xs, int n_all, int lo, int hi) {
  int n = max(hi - lo, 1);
  int i0 = lo + (n - 1) / 2;
  int i1 = lo + n / 2;
  float v0 = i0 < n_all ? xs[i0] : 0.f;
  float v1 = i1 < n_all ? xs[i1] : 0.f;
  return 0.5f * (v0 + v1);
}

// Mean and sample sd (N-1) of the window [lo, hi), one-pass as in the
// reference.
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

__device__ float window_sd(Col xs, int lo, int hi) {
  float mean, sd;
  window_mean_sd(xs, lo, hi, mean, sd);
  return sd;
}

// Median of |x - med| over the sorted window [lo, hi), without sorting
// the deviations: those of the rows below the median, read downwards from
// it, and those of the other rows, read upwards, are two ascending runs
// (|x - med| is med - x or x - med exactly), and a merge walk up to the
// middle ranks finds the two middle deviations.
__device__ float mad_spread(Col xs, int lo, int hi, float med) {
  const int m = hi - lo;
  if (m <= 0) return 0.f;
  const int r0 = (m - 1) / 2, r1 = m / 2;
  int dn = lower_bound(xs, lo, hi, med) - 1, up = dn + 1;
  float dl = dn >= lo ? med - xs[dn] : INFINITY;
  float du = up < hi ? xs[up] - med : INFINITY;
  float v0 = 0.f, v1 = 0.f;
  for (int r = 0; r <= r1; ++r) {
    float v;
    if (dl <= du) {
      v = dl;
      --dn;
      dl = dn >= lo ? med - xs[dn] : INFINITY;
    } else {
      v = du;
      ++up;
      du = up < hi ? xs[up] - med : INFINITY;
    }
    if (r == r0) v0 = v;
    v1 = v;
  }
  return 0.5f * (v0 + v1);
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

// K1b: SIGMEDIAN (rejection_float.c:210-221).  Rejected values become the
// running median and the column is sorted again, until a round replaces
// nothing.  Mean and sd are two-pass over the valid rows.  Returns true
// when the loop stopped at SIGMEDIAN_MAX_ROUNDS while still replacing.
// The replaced rows are a prefix [0, nl) and a suffix [nvalid - nh,
// nvalid) of the sorted valid rows (rounded subtraction is monotone), so
// the sorted column is the untouched middle with u = min(nl + nh, nvalid)
// copies of the median merged in at its rank: moved in place, no sort
// (tests/test_torch_rejection.py::test_sigmedian_resort_closed_form).
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
      nl += (med - v) > sd * siglow;
      nh += (v - med) > sd * sighigh;
    }
    if (nl + nh > 0) {
      const int u = min(nl + nh, nvalid);
      const int j = lower_bound(xs, nl, nl + nvalid - u, med) - nl;
      for (int k = 0; k < j; ++k) xs[k] = xs[k + nl];
      for (int k = nvalid - 1; k >= j + u; --k) xs[k] = xs[k - (u - nl)];
      for (int k = j; k < j + u; ++k) xs[k] = med;
    }
    rejl += nl;
    rejh += nh;
    active = nl + nh > 0;
  }
  return active;
}

// K1c: LINEARFIT (rejection_float.c:259-300).  A set bit of keep marks a
// kept sorted value; its position is its rank among the kept.  m_x and
// 1/m_dx2 are the full-size constants (median_and_mean.c:1491-1499).
__device__ void linearfit(Col xs, Bits keep, int nvalid, float siglow,
                          float sighigh, float m_x, float inv_mdx2, int n,
                          int& rejl, int& rejh) {
  int r = 0;
  bool active = nvalid > 1;
  while (active) {
    int nk = 0;
    float sy = 0.f;
    for (int k = 0; k < n; ++k) {
      if (keep.get(k)) {
        sy += xs[k];
        ++nk;
      }
    }
    float nks = fmaxf((float)nk, 1.f);
    float m_y = sy / nks;
    float sxy = 0.f;
    int c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep.get(k)) {
        float pos = (float)c++;
        sxy += (pos - m_x) * (xs[k] - m_y);
      }
    }
    float a = (sxy / nks) * inv_mdx2;
    float b = __fmaf_rn(-m_x, a, m_y);
    float sr = 0.f;
    c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep.get(k)) {
        float pos = (float)c++;
        sr += fabsf(xs[k] - __fmaf_rn(a, pos, b));
      }
    }
    float sigma = sr / nks;
    int max_acc = max(nk - r - 4, 0);
    int rank = 0, nl = 0, nh = 0;
    c = 0;
    for (int k = 0; k < n; ++k) {
      if (keep.get(k)) {
        float pos = (float)c++;
        float resid = xs[k] - __fmaf_rn(a, pos, b);
        bool lo = (-resid) > sigma * siglow;
        bool hi = resid > sigma * sighigh;
        if ((lo || hi) && ++rank <= max_acc) {
          keep.clear(k);
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

// K1d: GESDT, as lane_gesdt_step / lane_gesdt_replay on the register path:
// one walk with its window sums that records each step's side in high,
// then the confirmations replayed from those bits.
__device__ void gesdt(Col xs, Bits keep, Bits high, int n, int nvalid,
                      int n_full, int max_outliers,
                      const float* __restrict__ crit, int& rejl,
                      int& rejh) {
  const int M = max(max_outliers, 1);
  const int removed = n_full - nvalid;
  const int walk = min(M, max_outliers - removed);  // steps the budget allows
  int lo = 0, hi = nvalid, steps = 0, last_flag = -1;
  unsigned side = 0u;
  for (; steps < walk && hi - lo > 1; ++steps) {
    const int j = steps;
    float mean, sd;
    window_mean_sd(xs, lo, hi, mean, sd);
    const float dev_low = mean - xs[lo];
    const float dev_high = xs[hi - 1] - mean;
    const bool take_high = dev_high > dev_low;  // strict > (grubbs_stat)
    const float g = (take_high ? dev_high : dev_low) / fmaxf(sd, 1e-30f);
    if (hi - lo > 2 && g > __ldg(crit + min(removed + j, M - 1))) {
      last_flag = j;
    }
    side |= (unsigned)take_high << (j & 31);
    if ((j & 31) == 31) {
      high.word(j >> 5) = side;
      side = 0u;
    }
    if (take_high) --hi;
    else ++lo;
  }
  if (steps & 31) high.word(steps >> 5) = side;
  const float median0 = window_median(xs, n, 0, nvalid);
  const int nconf = min(steps, max(last_flag, min(1, M - 1)) + 1);
  lo = 0;
  hi = nvalid;
  for (int j = 0; j < nconf; ++j) {
    const bool th = high.get(j);
    if ((th ? xs[hi - 1] : xs[lo]) >= median0) ++rejh;
    else ++rejl;
    // high removals record the shrunk-array index (rejection_float.c:332)
    keep.clear(th ? hi - lo - 1 : lo);
    if (th) --hi;
    else ++lo;
  }
}

// Rows [r0, r0 + rows) of the tile's 2^lc pixels from p0, decoded and
// normalized, into dst (invalid values as +inf) and, for a weighted mean,
// as they are into orig; both laid out [row][column] from row r0.  The
// whole block loads: element i is row i >> lc, column i & (C - 1), so a
// warp reads runs of consecutive words; a thread issues LOAD_BATCH loads
// before it uses one.  Every element of a thread is in its column
// threadIdx.x & (C - 1) (C divides COL_THREADS): the thread adds its valid
// and its negative values to nvalid and n_neg.
template <typename T>
__device__ void load_rows(const Params& a, int p0, int lc, int r0, int rows,
                          float* dst, float* orig, int& nvalid,
                          int& n_neg) {
  const int total = rows << lc, cmask = (1 << lc) - 1;
  for (int i0 = threadIdx.x; i0 < total; i0 += COL_THREADS * LOAD_BATCH) {
    float raw[LOAD_BATCH];
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b) {
      const int i = i0 + b * COL_THREADS;
      const int r = r0 + (i >> lc), px = p0 + (i & cmask);
      raw[b] = i < total && px < a.p
                   ? (float)((const T*)a.stack)[(size_t)r * a.p + px]
                   : 0.f;
    }
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b) {
      const int i = i0 + b * COL_THREADS;
      if (i < total) {
        const int r = r0 + (i >> lc), px = p0 + (i & cmask);
        const float x = px < a.p ? norm_value<T>(a, a.scale, a.offset,
                                                 a.mul, r, raw[b])
                                 : 0.f;
        if (orig != nullptr) orig[i] = x;
        const bool ok = x != 0.f && isfinite(x);
        dst[i] = ok ? x : INFINITY;
        nvalid += ok;
        n_neg += ok && x < 0.f;
      }
    }
  }
}

// Stages [lp0, lp1) of Batcher's odd-even merge sort (sort_net's network)
// over rows [0, n) of every column of a [row][2^lc] tile, its comparators
// shared among the block's threads (a warp's comparators touch one row
// pair of 32 consecutive columns); the block synchronizes after each.
// Candidate q of a stage (p, k) is the pair (lo, lo + k), lo = k % p +
// 2k (q / k) + q % k; P2 / 2 candidates cover every comparator.
__device__ void sort_stages(float* xs, int n, int lc, int lp0, int lp1) {
  const int half = 1 << max(ceil_log2(n) - 1, 0);
  const int total = half << lc, cmask = (1 << lc) - 1;
  for (int lp = lp0; lp < lp1; ++lp) {
    for (int lk = lp; lk >= 0; --lk) {
      const int k = 1 << lk, j0 = k & ((1 << lp) - 1);
      for (int i = threadIdx.x; i < total; i += COL_THREADS) {
        const int q = i >> lc, c = i & cmask;
        const int lo = j0 + ((q >> lk) << (lk + 1)) + (q & (k - 1));
        const int hi = lo + k;
        if (hi < n && (lo >> (lp + 1)) == (hi >> (lp + 1))) {
          float* const x = xs + ((size_t)lo << lc) + c;
          float* const y = xs + ((size_t)hi << lc) + c;
          const float u = *x, v = *y;
          *x = fminf(u, v);
          *y = fmaxf(u, v);
        }
      }
      __syncthreads();
    }
  }
}

// The first five stages of the network over a [row][2^lc] tile, rows
// [0, n): every aligned run of 32 rows of a column sorted in registers by
// sort_net, one run a thread (rows past n are +inf pads there).  The
// block synchronizes after it.
__device__ void sort_runs32(float* xs, int n, int lc) {
  const int runs = (n + 31) >> 5, cmask = (1 << lc) - 1;
  for (int i = threadIdx.x; i < (runs << lc); i += COL_THREADS) {
    const int r0 = (i >> lc) << 5, c = i & cmask;
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      v[k] = r0 + k < n ? xs[((size_t)(r0 + k) << lc) + c] : INFINITY;
    }
    sort_net(v);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (r0 + k < n) xs[((size_t)(r0 + k) << lc) + c] = v[k];
    }
  }
  __syncthreads();
}

// One pixel's rejection and (weighted) mean over its sorted column xs
// (orig: its values in frame order, for a weighted mean) of nvalid valid
// values, n_neg of them negative.
__device__ void column_reject(const Params& a, int px, Col xs, Col orig,
                              Bits keep, Bits high, int nvalid, int n_neg) {
  const int n = a.n, rtype = a.rtype;
  const float siglow = a.siglow, sighigh = a.sighigh;
  // kept set: the window [lo, hi) plus the segment [seg_lo, seg_hi), or
  // the keep bits for the mask modes
  bool masked = rtype == LINEARFIT || rtype == GESDT;
  Window w{0, nvalid, 0, 0, 0, 0, 0};
  if (masked) keep.set_prefix(n, nvalid);
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
      float spread = rtype == MAD ? mad_spread(xs, w.lo, w.hi, med)
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
    linearfit(xs, keep, nvalid, siglow, sighigh, a.m_x, a.inv_mdx2, n,
              w.rejl, w.rejh);
  } else if (rtype == GESDT) {
    gesdt(xs, keep, high, n, nvalid, a.n_full, a.max_outliers, a.crit,
          w.rejl, w.rejh);
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
    bool kept = masked ? keep.get(k)
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
      float x = orig[k];
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

// Every mode at N > 32, one thread a column.  Blocks take tiles of 2^lc
// consecutive pixels from ``queue`` (zeroed before the launch): the block
// loads the tile, sorts its columns, and its first 2^lc threads reject
// and write one pixel each.  The tile lives in dynamic shared memory, or
// (GLOBAL) in the block's slab of the scratch buffer, loaded and sorted in
// chunks of CHUNK_ROWS rows in shared memory before the network's stages
// across chunks run in the slab.
template <typename T, bool GLOBAL>
__global__ void __launch_bounds__(COL_THREADS)
    column_kernel(Params a, int lc) {
  extern __shared__ float smem[];
  __shared__ unsigned tile_at;
  __shared__ int counts[2][COL_THREADS];  // valid, negative values a column
  const int n = a.n, t = threadIdx.x, C = 1 << lc;
  const bool weighted = a.weights != nullptr;
  float* const tile =
      GLOBAL ? a.scratch + blockIdx.x * tile_floats(n, lc, weighted) : smem;
  float* const xs = tile;
  float* const orig = weighted ? tile + ((size_t)n << lc) : nullptr;
  unsigned* const keep =
      (unsigned*)(tile + ((size_t)(weighted ? 2 : 1) * n << lc));
  unsigned* const high = keep + ((size_t)bit_words(n) << lc);
  const unsigned tiles = (unsigned)((a.p + C - 1) >> lc);
  const int l2 = ceil_log2(n);
  for (;;) {
    if (t == 0) tile_at = atomicAdd(a.queue, 1u);
    __syncthreads();
    const unsigned at = tile_at;
    if (at >= tiles) break;
    const int p0 = (int)(at << lc);
    if (t < C) counts[0][t] = counts[1][t] = 0;
    int nvalid = 0, n_neg = 0;
    if (GLOBAL) {
      for (int r0 = 0; r0 < n; r0 += CHUNK_ROWS) {
        const int rows = min(CHUNK_ROWS, n - r0);
        load_rows<T>(a, p0, lc, r0, rows, smem,
                     weighted ? orig + ((size_t)r0 << lc) : nullptr, nvalid,
                     n_neg);
        __syncthreads();
        sort_runs32(smem, rows, lc);
        sort_stages(smem, rows, lc, 5, LOG2_CHUNK_ROWS);
        for (int i = t; i < rows << lc; i += COL_THREADS) {
          xs[((size_t)r0 << lc) + i] = smem[i];
        }
        __syncthreads();
      }
      sort_stages(xs, n, lc, LOG2_CHUNK_ROWS, l2);
    } else {
      load_rows<T>(a, p0, lc, 0, n, xs, orig, nvalid, n_neg);
      __syncthreads();
      sort_runs32(xs, n, lc);
      if (n <= 32 + INSERT_ROWS) {
        // rows 32.. are sorted: each goes down into rows 0.. in turn
        const Col col{xs + t, C};
        for (int k = 32; t < C && k < n; ++k) {
          const float x = col[k];
          int j = k;
          while (j > 0 && col[j - 1] > x) {
            col[j] = col[j - 1];
            --j;
          }
          col[j] = x;
        }
        __syncthreads();
      } else {
        sort_stages(xs, n, lc, 5, l2);
      }
    }
    atomicAdd(&counts[0][t & (C - 1)], nvalid);
    atomicAdd(&counts[1][t & (C - 1)], n_neg);
    __syncthreads();
    if (t < C && p0 + t < a.p) {
      column_reject(a, p0 + t, Col{xs + t, C},
                    Col{weighted ? orig + t : nullptr, C},
                    Bits{keep + t, C}, Bits{high + t, C}, counts[0][t],
                    counts[1][t]);
    }
    __syncthreads();  // the tile is free for the next one
  }
}

// The columns a tile of the shared-memory layout takes (log2: 4 to 7),
// the most resident on an SM; -1 when 32 do not fit.  (Occupancy by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with the opt-in set.)
template <typename T>
cudaError_t column_tile(int n, bool weighted, int& lc, size_t& smem,
                        int& per_sm) {
  auto kernel = column_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_DYNAMIC_MAX);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  }
  lc = -1;
  per_sm = 0;
  for (int l = 7; e == cudaSuccess && l >= 4; --l) {
    const size_t bytes = tile_floats(n, l, weighted) * sizeof(float);
    if (bytes > SMEM_DYNAMIC_MAX) continue;
    if (l == 4 && lc < 0) break;  // past a 32-column tile: the global layout
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      COL_THREADS, bytes);
    if (e != cudaSuccess) break;
    if (lc < 0 ? blocks > 0 : (blocks << l) > (per_sm << lc)) {
      lc = l;
      smem = bytes;
      per_sm = blocks;
    }
  }
  return e;
}

template <typename T>
cudaError_t launch_columns(const Params& a, cudaStream_t stream) {
  const bool weighted = a.weights != nullptr;
  int dev = 0, sms = 0, lc = -1, per_sm = 0;
  size_t smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) e = column_tile<T>(a.n, weighted, lc, smem, per_sm);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.queue, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return e;
  if (lc >= 0) {
    const long long tiles = ((long long)a.p + (1 << lc) - 1) >> lc;
    const int blocks = (int)std::min(tiles, (long long)sms * per_sm);
    column_kernel<T, false><<<blocks, COL_THREADS, smem, stream>>>(a, lc);
    return cudaGetLastError();
  }
  // the global layout: 128-column tiles, one slab of the scratch each
  if (a.scratch == nullptr || a.cols <= 0) return cudaErrorInvalidValue;
  lc = 7;
  smem = ((size_t)CHUNK_ROWS << lc) * sizeof(float);
  auto kernel = column_kernel<T, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      COL_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  const size_t scratch = (2 * (size_t)a.n + 2 * (size_t)bit_words(a.n)) *
                         (size_t)a.cols;
  const long long slabs = (long long)(scratch / tile_floats(a.n, lc, weighted));
  const long long tiles = ((long long)a.p + (1 << lc) - 1) >> lc;
  const int blocks = (int)std::min(
      {tiles, (long long)sms * std::max(per_sm, 1), slabs});
  if (blocks <= 0) return cudaErrorInvalidValue;
  kernel<<<blocks, COL_THREADS, smem, stream>>>(a, lc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  if (register_path(a.n, a.rtype, a.weights != nullptr)) {
    return launch_reg_mode<T>(a, stream);
  }
  return launch_columns<T>(a, stream);
}

}  // namespace

// Whether a call of n frames in mode rtype (weighted or not) takes the
// register path (else the column kernel).
extern "C" int siril_reject_stack_register_path(int n, int rtype,
                                                int weighted) {
  return rtype >= 0 && rtype < 8 && register_path(n, rtype, weighted != 0);
}

// Whether a call of n frames in mode rtype (weighted or not) needs a
// global scratch buffer of (2 n + 2 ceil(n / 32)) cols floats (any cols
// >= 128): a 32-column tile of its columns does not fit shared memory.
extern "C" int siril_reject_stack_needs_scratch(int n, int rtype,
                                                int weighted) {
  return !register_path(n, rtype, weighted != 0) &&
         tile_floats(n, 5, weighted != 0) * sizeof(float) > SMEM_DYNAMIC_MAX;
}

// C entry point bound through ctypes.  Pointers are device pointers
// (`weights` may be null, `critical` is read only by GESDT, `scratch` only
// when siril_reject_stack_needs_scratch says so; `capped`, when not null,
// is a 64-bit counter to which SIGMEDIAN adds one for every pixel whose
// loop stopped at SIGMEDIAN_MAX_ROUNDS and WINSORIZED one for every
// clipping round whose σ iteration stopped at WINSOR_MAX_STEPS; `queue`
// is a 32-bit word for the counter of pixels or tiles handed out, which
// the launch sets to 0 on `stream` first); the launches go on `stream`
// and do not synchronize.  Returns the CUDA error code of the launch (0
// on success).
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
  if (queue == nullptr) return (int)cudaErrorInvalidValue;
  Params a{stack, n, p, (const float*)scale, (const float*)offset,
           (const float*)mul, (const float*)weights, w_stride_n,
           w_stride_p, (const float*)critical, rtype, mode, siglow,
           sighigh, n_full, max_outliers, m_x, inv_mdx2, (float*)mean,
           (int*)rejl, (int*)rejh, (float*)scratch, cols,
           (unsigned long long*)capped, (unsigned*)queue};
  auto fn = is_i16 ? &launch<int16_t> : &launch<float>;
  return (int)fn(a, (cudaStream_t)stream);
}
