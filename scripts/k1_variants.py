"""Time design variants of kernel K1 on one CUDA card.

    python3 scripts/k1_variants.py [--mode MODE[,MODE...]] [--size SIZE]
        [--n N[,N...]] [--p P[,P...]] [--tags TAGS] [--reps R]
        [--rounds K] [--parent FILE] [variant ...]

MODE is winsorized (default), sigmedian, linearfit, gesdt, sigma, mad,
percentile or none; a list runs each mode in turn on the same builds.
SIZE is block (default: chip_smoke.py's main-path block, 2,793,472
pixels), stack (the stack command's call size, 16,777,216) or k1e (the
size of chip_smoke.py's weighted comparisons, 1,048,576); ``--p`` sets the
pixels directly.  ``--n`` sets the frames (default chip_smoke.py's 24):
past the register path's limit (32 frames, or 48 or 64 for some modes;
REGISTER_FRAMES) the calls take the column kernel.  Lists of
frame counts (with one pixel count, or one for each) run every size on
the same builds, on data made anew for each size from a seed of its own.
Each variant is a textual edit of ``siril_tpu_torch/csrc/reject_stack.cu`` (see
``variants``), built with the port's nvcc flags (float32 instantiations
only; all variants' builds run together) into a scratch directory beside
the build directory and bound through the wrapper; ``--parent FILE`` adds
the variant ``parent``, built from another version of the source with the
same C interface (an earlier commit's, unpacked with git archive).  Every
variant runs the mode on chip_smoke.py's ``make_stack`` data (float32,
additive+scaling; TAGS, a comma list of none, frame and pixel: unweighted,
with per-frame and with per-pixel weights, default all three) and must
give the first variant's result bit for bit.  Times are CUDA events around
R back-to-back launches (default 10), median of K such batches (default
5); ``parent`` by one launch where that takes more than a second.  Needs
CUDA and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SRC = os.path.join(HERE, "siril_tpu_torch", "csrc", "reject_stack.cu")

#: mode → (rtype, siglow, sighigh); GESDT's siglow is its outlier fraction
MODES = {"winsorized": (5, 3.0, 3.0), "sigmedian": (4, 3.0, 3.0),
         "linearfit": (6, 3.0, 3.0), "gesdt": (7, 0.3, 0.05),
         "sigma": (2, 3.0, 3.0), "mad": (3, 3.0, 3.0),
         "percentile": (1, 0.2, 0.1), "none": (0, 3.0, 3.0)}
#: each voting mode's threshold in the source (GESDT has none: ``ready``)
READY = {"winsorized": "READY_LANES", "sigmedian": "SIGMEDIAN_READY_LANES",
         "linearfit": "LINEARFIT_READY_LANES"}

LOCKSTEP = '''
template <typename T, int NMAX, bool WEIGHTED, int CLASS>
__global__ void __launch_bounds__(REG_THREADS) lockstep_kernel(Params a) {
  __shared__ float sc[NMAX], off[NMAX], mu[NMAX];
  __shared__ float xv[WEIGHTED ? NMAX * REG_THREADS : 1];
  __shared__ float wt[NMAX];
  __shared__ float lam[NMAX];
  for (int k = threadIdx.x; k < a.n; k += blockDim.x) {
    sc[k] = a.scale[k];
    off[k] = a.offset[k];
    mu[k] = a.mul[k];
    if (WEIGHTED && a.w_sp == 0) wt[k] = a.weights[k * a.w_sn];
  }
  if (CLASS == CLASS_GESDT) {
    for (int k = threadIdx.x; k < min(max(a.max_outliers, 1), NMAX);
         k += blockDim.x) {
      lam[k] = a.crit[k];
    }
  }
  __syncthreads();
  float* const xcol = xv + (WEIGHTED ? threadIdx.x : 0);
  for (int px = blockIdx.x * blockDim.x + threadIdx.x; px < a.p;
       px += gridDim.x * blockDim.x) {
    Lane<NMAX, WEIGHTED> s;
    s.px = px;
    lane_load<T>(a, sc, off, mu, xcol, s);
    if constexpr (CLASS == CLASS_WINDOW) {
      lane_reject(a, s);
    } else if constexpr (CLASS == CLASS_WINSOR) {
      bool round = s.nvalid > 1;
      while (round) {
        if (lane_round_start(a.n, s)) {
          while (lane_sigma_step(a, s)) {
          }
        }
        round = reg_clip_round(s.xs, a.n, s.w, s.med, s.sigma, a.siglow,
                               a.sighigh) && (s.w.hi - s.w.lo) > 3;
      }
    } else if (lane_loop_start<CLASS>(a, s)) {
      while (lane_step<CLASS>(a, lam, s)) {
      }
    }
    lane_finish<T>(a, xcol, wt, s, kept_rows<CLASS>(s));
  }
}
'''

#: SIGMEDIAN's re-sort (b): the low candidates are a prefix of the sorted
#: valid rows and the high ones a suffix (rounded subtraction is monotone),
#: so the sorted result is the untouched middle xs[nl, nvalid - nh) with
#: one copy of the median for each replaced row merged in at its rank,
#: built by selects from two copies of the column shifted by nl and
#: u - nl (one conditional pass per bit of the shift)
RESORT_MERGE = '''template <int NMAX>
__device__ __forceinline__ void shift_down(float (&v)[NMAX], int s) {
  constexpr int L2 = log2_of(pow2_up(NMAX));
#pragma unroll
  for (int b = 0; b < L2; ++b) {
    const int d = 1 << b;
    if ((s >> b) & 1) {
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i + d < NMAX) v[i] = v[i + d];
      }
    }
  }
}

template <int NMAX>
__device__ __forceinline__ void shift_up(float (&v)[NMAX], int s) {
  constexpr int L2 = log2_of(pow2_up(NMAX));
#pragma unroll
  for (int b = 0; b < L2; ++b) {
    const int d = 1 << b;
    if ((s >> b) & 1) {
#pragma unroll
      for (int i = NMAX - 1; i >= 0; --i) {
        if (i >= d) v[i] = v[i - d];
      }
    }
  }
}

template <int NMAX>
__device__ __forceinline__ void sigmedian_merge(float (&xs)[NMAX],
                                                int nvalid, float med,
                                                int nl, int nh) {
  const int u = min(nl + nh, nvalid);  // the prefix and the suffix may meet
  const RowMask<NMAX> mid = span_mask<RowMask<NMAX>>(nl, nvalid - nh);
  int j = 0;  // middle values below the median
#pragma unroll
  for (int k = 0; k < NMAX; ++k) j += row_in(mid, k) && xs[k] < med;
  float head[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) head[k] = xs[k];
  shift_down(head, nl);   // head[i] = xs[nl + i]
  shift_up(xs, u - nl);   // xs[i] = xs[nl + i - u] for i >= j + u
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    xs[i] = i < j ? head[i] : i < j + u ? med : i < nvalid ? xs[i] : INFINITY;
  }
}
'''

COUNTERS = '''
extern "C" int k1_counts(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_cnt, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_cnt, sizeof(g_cnt));
}
'''


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
    return s.replace(old, new)


def _counted(s: str) -> str:
    """Count, per warp of the register path, its step iterations and the
    lanes stepping in them, and its refill iterations and the lanes
    acting in them."""
    s = _sub(s, "constexpr unsigned FULL_WARP = 0xffffffffu;",
             "__device__ unsigned long long g_cnt[4];\n"
             "constexpr unsigned FULL_WARP = 0xffffffffu;")
    s = _sub(s, "      if (stepping) stepping = lane_step<CLASS>(a, lam, s);",
             "      const unsigned stepm = __ballot_sync(FULL_WARP, stepping);\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[0], 1ULL);\n"
             "        atomicAdd(&g_cnt[1], (unsigned long long)__popc(stepm));\n"
             "      }\n"
             "      if (stepping) stepping = lane_step<CLASS>(a, lam, s);")
    s = _sub(s, "      if (__ballot_sync(FULL_WARP, act) == 0) break;",
             "      const unsigned actm = __ballot_sync(FULL_WARP, act);\n"
             "      if (actm == 0) break;\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[2], 1ULL);\n"
             "        atomicAdd(&g_cnt[3], (unsigned long long)__popc(actm));\n"
             "      }")
    return s + COUNTERS


def _counted_columns(s: str) -> str:
    """Count, in the column kernel, the most columns in flight on one SM
    (tiles between their first load and their last write), the tiles, and
    the SM cycles of their load-and-sort and of their rejection phases."""
    s = _sub(s, "constexpr int COL_THREADS = 128;",
             "__device__ unsigned long long g_cnt[4];\n"
             "__device__ unsigned g_sm[1024];\n"
             "constexpr int COL_THREADS = 128;")
    s = _sub(s, "    const int p0 = (int)(at << lc);\n",
             "    const int p0 = (int)(at << lc);\n"
             "    unsigned sm_id = 0;\n"
             "    long long c0 = clock64(), c1 = 0;\n"
             "    if (t == 0) {\n"
             "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_id));\n"
             "      const unsigned now = atomicAdd(&g_sm[sm_id], (unsigned)C)"
             " + C;\n"
             "      atomicMax(&g_cnt[0], (unsigned long long)now);\n"
             "      atomicAdd(&g_cnt[1], 1ULL);\n"
             "    }\n")
    s = _sub(s, "    if (t < C && p0 + t < a.p) {\n      column_reject(",
             "    c1 = clock64();\n"
             "    if (t < C && p0 + t < a.p) {\n      column_reject(")
    s = _sub(s, "    __syncthreads();  // the tile is free for the next one\n",
             "    __syncthreads();  // the tile is free for the next one\n"
             "    if (t == 0) {\n"
             "      atomicSub(&g_sm[sm_id], (unsigned)C);\n"
             "      atomicAdd(&g_cnt[2], (unsigned long long)(c1 - c0));\n"
             "      atomicAdd(&g_cnt[3], (unsigned long long)(clock64() - c1));\n"
             "    }\n")
    return s + COUNTERS


def _lockstep(s: str) -> str:
    s = _sub(s, "template <typename T, int NMAX, bool WEIGHTED, int CLASS>\n"
             "cudaError_t launch_reg(",
             LOCKSTEP + "\ntemplate <typename T, int NMAX, bool WEIGHTED, "
             "int CLASS>\ncudaError_t launch_reg(")
    return _sub(s, "  auto kernel = register_kernel<T, NMAX, WEIGHTED, CLASS>;",
                "  auto kernel = lockstep_kernel<T, NMAX, WEIGHTED, CLASS>;")


def _resort_merge(s: str) -> str:
    """SIGMEDIAN's network re-sort replaced by RESORT_MERGE."""
    s = _sub(s, "// One SIGMEDIAN round (rejection_float.c",
             RESORT_MERGE + "\n// One SIGMEDIAN round (rejection_float.c")
    return _sub(s, "#pragma unroll\n  for (int k = 0; k < NMAX; ++k) {\n"
                "    if (row_in(rep, k)) s.xs[k] = med;\n  }\n"
                "  sort_net(s.xs);\n",
                "  sigmedian_merge(s.xs, nvalid, med, nl, nh);\n")


def _resid_regs(s: str) -> str:
    """LINEARFIT's residuals kept in registers from the σ pass for the
    clipping pass, not computed again."""
    s = _sub(s, "  float sr = 0.f;\n  pos = 0.f;\n",
             "  float sr = 0.f, res[NMAX];\n  pos = 0.f;\n")
    s = _sub(s, "          sr += fabsf(s.xs[k] - __fmaf_rn(slope, pos, icpt));",
             "          res[k] = s.xs[k] - __fmaf_rn(slope, pos, icpt);\n"
             "          sr += fabsf(res[k]);")
    return _sub(s, "          const float resid = s.xs[k] - "
                "__fmaf_rn(slope, pos, icpt);\n          pos += 1.f;\n",
                "          const float resid = res[k];\n")


def _ready(name: str, lanes: int):
    def edit(s: str) -> str:
        s2, k = re.subn(rf"constexpr int {name} = \d+;",
                        f"constexpr int {name} = {lanes};", s)
        if k != 1:
            raise SystemExit(f"variant edit does not apply: {name}")
        return s2
    return edit


def _gesdt_vote(lanes: int):
    """GESDT's walk steps under the warp vote, leaving at ``lanes`` ready
    lanes, as SIGMEDIAN's and LINEARFIT's rounds run (the source walks
    inside the lane's rejection, with no vote)."""
    def edit(s: str) -> str:
        s = _sub(s, "        if constexpr (CLASS == CLASS_WINDOW || "
                 "CLASS == CLASS_GESDT) {",
                 "        if constexpr (CLASS == CLASS_WINDOW) {")
        return _sub(s, "                        : CLASS == CLASS_SIGMEDIAN ? "
                    "SIGMEDIAN_READY_LANES\n",
                    "                        : CLASS == CLASS_SIGMEDIAN ? "
                    "SIGMEDIAN_READY_LANES\n"
                    f"                        : CLASS == CLASS_GESDT ? {lanes}\n")
    return edit


def _frames(n: int):
    """The register path's frame limits (REGISTER_FRAMES) all set to
    ``n``."""
    def edit(s: str) -> str:
        s2, k = re.subn(r"\{(\d+), (\d+)\},(\s*// \w+)",
                        lambda m: f"{{{n}, {n}}},{m.group(3)}", s)
        if k != 8:
            raise SystemExit("variant edit does not apply: REGISTER_FRAMES")
        return s2
    return edit


def variants(mode: str, columns: bool = False) -> dict:
    """name → (what it changes, edit of the source) for one mode; with
    ``columns``, the variants of the column kernel (calls past 32
    frames)."""
    out = {"base": ("the source as it is", lambda s: s)}
    if columns:
        out.update({
            "counted": ("the source with counters of the columns in flight "
                        "on an SM and of the tiles' phase cycles (slower)",
                        _counted_columns),
            "no16": ("no 16-column tiles (32 at least)",
                     lambda s: _sub(s, "  for (int l = 7; e == cudaSuccess "
                                    "&& l >= 4; --l) {",
                                    "  for (int l = 7; e == cudaSuccess && "
                                    "l >= 5; --l) {")),
            "columns64": ("the column kernel at 33-64 frames too (the "
                          "register path up to 32 frames)", _frames(32)),
            "insert0": ("the network's last stage at every N (no "
                        "insertion of the rows past 32)",
                        lambda s: _sub(s, "constexpr int INSERT_ROWS = ",
                                       "constexpr int INSERT_ROWS = 0;  // ")),
            "insert32": ("the rows past 32 inserted up to 64 frames",
                         lambda s: _sub(s, "constexpr int INSERT_ROWS = ",
                                        "constexpr int INSERT_ROWS = 32;  "
                                        "// ")),
            "registers64": ("the register path up to 64 frames in every "
                            "mode and weighting", _frames(64)),
        })
        return out
    out["counted"] = ("the source with counters of the warps' steps and "
                      "refills (slower; read for lane use)", _counted)
    if mode in READY:
        for lanes in (4, 8, 16, 24, 32):
            what = f"a warp leaves its steps at {lanes} ready lanes"
            if lanes == 32:
                what += (" (all lanes done: lockstep with the queue)"
                         if mode != "winsorized" else " (all lanes settled)")
            out[f"ready{lanes}"] = (what, _ready(READY[mode], lanes))
    if mode == "gesdt":
        for lanes in (16, 24):
            out[f"vote{lanes}"] = (f"the walk's steps under the warp vote, "
                                   f"leaving at {lanes} ready lanes",
                                   _gesdt_vote(lanes))
    out.update({
        "nmax32": ("N = 24 in the NMAX = 32 instantiation (no NMAX = 24)",
                   lambda s: _sub(s, "  if (a.n <= 24) return launch_reg<T, "
                                  "24, WEIGHTED, CLASS>(a, stream);\n", "")),
        "lockstep": ("one pixel a lane in lockstep: no warp vote, no queue",
                     _lockstep),
        "serial_loads": ("each frame's load issued inside the normalization "
                         "loop, behind a branch",
                         lambda s: _sub(s, "norm_value<T>(a, sc, off, mu, k, "
                                        "raw[k])", "norm_value<T>(a, sc, off, "
                                        "mu, k, (float)((const T*)a.stack)"
                                        "[(size_t)k * a.p + s.px])")),
        "columns": ("the column kernel (the design past the register "
                    "path) at every N",
                    lambda s: _sub(s, "  return n <= REGISTER_FRAMES[rtype]"
                                   "[weighted];", "  return false;")),
    })
    if mode == "sigmedian":
        out["resort_merge"] = ("re-sort (b): the closed-form merge of the "
                               "median's copies by selects, not the "
                               "network (a)", _resort_merge)
    if mode == "linearfit":
        out["resid_regs"] = ("the residuals kept in registers from the σ "
                             "pass for the clipping pass", _resid_regs)
    return out


def float_only(s: str) -> str:
    """Build no int16 instantiation (this script runs float32 stacks)."""
    return _sub(s, "auto fn = is_i16 ? &launch<int16_t> : &launch<float>;",
                "auto fn = &launch<float>;")


def build_all(srcs: dict, out_dir: str) -> dict:
    """{name: source} → {name: library}, one nvcc each, all together."""
    from siril_tpu_torch.kernels import build as kb

    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = so
    return libs


def time_mode(mode, n, p, stack, sc, off, one, weights, tags, names, libs,
              table, columns, batch_ms, args) -> bool:
    """Every variant on one mode and size, each weighting in TAGS; False
    when a variant's result differs from the first's."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    rtype, sl, sh = MODES[mode]
    extra = {}
    if rtype == rj.GESDT:
        mo = rj.gesdt_max_outliers(n, sl)
        extra = dict(max_outliers=mo,
                     critical=rj.gesdt_critical_values(n, sh, mo))
    ref, base_ms = {}, {}
    for wname in tags:
        tag = f"{mode} N={n}" if wname == "none" else \
            f"{mode} N={n}, {wname} weights"
        for name in names:
            k1._library = lambda lib=libs[name]: lib

            def run():
                return k1.reject_mean(stack, sc, off, one, rtype=rtype,
                                      mode=ADDITIVE_SCALING, siglow=sl,
                                      sighigh=sh, weights=weights[wname],
                                      **extra)

            out = run()
            ref.setdefault(tag, out)
            same = all(torch.equal(x, y) for x, y in zip(out, ref[tag]))
            del out
            once = batch_ms(run, 1) if name == "parent" else 0.0
            if once > 1000.0:
                times = [once]
            else:
                times = sorted(batch_ms(run, args.reps)
                               for _ in range(args.rounds))
            med = times[len(times) // 2]
            base_ms.setdefault(tag, med)
            if name == "counted":
                cnt = (ctypes.c_ulonglong * 4)()
                libs[name].k1_counts(cnt, 1)
                run()
                torch.cuda.synchronize()
                libs[name].k1_counts(cnt, 0)
                if columns:
                    print(f"{tag:34s} counted: at most {cnt[0]} columns "
                          f"in flight on one SM; {cnt[1]} tiles, SM cycles "
                          f"a tile: load and sort "
                          f"{cnt[2] / max(cnt[1], 1):.0f}, reject "
                          f"{cnt[3] / max(cnt[1], 1):.0f}", flush=True)
                else:
                    print(f"{tag:34s} counted: {cnt[0]} warp steps with "
                          f"{cnt[1]} lanes stepping "
                          f"({cnt[1] / 32 / max(cnt[0], 1):.1%} lane use); "
                          f"{cnt[2]} refill iterations with {cnt[3]} lanes "
                          f"acting ({cnt[3] / max(cnt[2], 1):.1f} a warp)",
                          flush=True)
            print(f"{tag:34s} {name:12s} {med:.3f} ms "
                  f"(min {times[0]:.3f}, max {times[-1]:.3f}; "
                  f"{med / base_ms[tag]:.3f}x the first), "
                  f"{'bit-equal to the first' if same else 'DIFFERS'}"
                  f" — {table[name][0]}", flush=True)
            if not same:
                return False
    return True


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="winsorized")
    ap.add_argument("--size", choices=("block", "stack", "k1e"),
                    default="block")
    ap.add_argument("--n", default=None)
    ap.add_argument("--p", default=None)
    ap.add_argument("--tags", default="none,frame,pixel")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parent", default=None)
    ap.add_argument("names", nargs="*", metavar="variant")
    args = ap.parse_args(argv)
    modes = args.mode.split(",")
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m}")

    import time

    import torch

    import chip_smoke as cs
    from siril_tpu_torch.kernels import build as kb
    from siril_tpu_torch.kernels import reject_stack as k1

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    ns = [int(v) for v in (args.n or str(cs.FRAMES)).split(",")]
    columns = max(ns) > 32
    table = variants(modes[0], columns)
    if args.parent:
        table["parent"] = (f"the source of {args.parent}",
                           lambda s: open(args.parent).read())
    names = args.names or list(table)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(kb.BUILD_DIR, f"variants-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    src = open(SRC).read()
    t = time.perf_counter()
    paths = build_all({name: float_only(table[name][1](src))
                       for name in names}, out_dir)
    print(f"built {len(paths)} variants in {time.perf_counter() - t:.1f}s",
          flush=True)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        if not hasattr(lib, "siril_reject_stack_register_path"):
            # a source from before this export: its launches are counted
            # (by the wrapper, read by nothing here) as the column kernel's
            lib.siril_reject_stack_register_path = lambda n, r, w: 0
        k1.bind(lib)
        if name == "counted":
            lib.k1_counts.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.k1_counts.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    default_p = {"block": (256 << 20) // (cs.FRAMES * cs.SIZE * 4) * cs.SIZE,
                 "stack": cs.SIZE * cs.SIZE, "k1e": 1 << 20}[args.size]
    ps = [int(v) for v in args.p.split(",")] if args.p else [default_p]
    if len(ps) == 1:
        ps = ps * len(ns)
    tags = args.tags.split(",")

    def batch_ms(fn, reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    for n, p in zip(ns, ps):
        gen = torch.Generator(device=dev)
        gen.manual_seed(n)
        stack = cs.make_stack(gen, n, p, dev)
        sc = 1.0 + 0.02 * torch.randn(n, generator=gen, device=dev)
        off, one = sc * 0.1 - 0.1, torch.ones_like(sc)
        weights = {"none": None}
        if "frame" in tags:
            weights["frame"] = 0.5 + torch.rand(n, 1, generator=gen,
                                                device=dev)
        if "pixel" in tags:
            weights["pixel"] = 0.5 + torch.rand(n, p, generator=gen,
                                                device=dev)
        print(f"{args.mode} at N = {n}, P = {p}", flush=True)
        for mode in modes:
            if not time_mode(mode, n, p, stack, sc, off, one, weights, tags,
                             names, libs, table, columns, batch_ms, args):
                return 1
        del stack, weights
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
