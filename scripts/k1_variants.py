"""Time design variants of kernel K1's register path on one CUDA card.

    python3 scripts/k1_variants.py [--mode MODE] [--size SIZE] [variant ...]

MODE is winsorized (default), sigmedian or linearfit; SIZE is block
(default: chip_smoke.py's main-path block, 24 frames × 2,793,472 pixels),
stack (the stack command's call size, 24 × 16,777,216) or k1e (the size
of chip_smoke.py's weighted comparisons, 24 × 1,048,576).  Each variant
is a textual edit of ``siril_tpu_torch/csrc/reject_stack.cu`` (see
``variants``), built with the port's nvcc flags (float32 instantiations
only; all variants' builds run together) into a scratch directory beside
the build directory and bound through the wrapper.  Every variant runs the
mode on chip_smoke.py's ``make_stack`` data (float32, additive+scaling;
unweighted, with per-frame and with per-pixel weights) and must give the
first variant's result bit for bit.  Times are CUDA events around 10
back-to-back launches, median of 5.  Needs CUDA and nvcc; prints the
card's name and power limit first.
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

MODES = {"winsorized": 5, "sigmedian": 4, "linearfit": 6}
#: each mode's vote threshold in the source
READY = {"winsorized": "READY_LANES", "sigmedian": "SIGMEDIAN_READY_LANES",
         "linearfit": "LINEARFIT_READY_LANES"}

LOCKSTEP = '''
template <typename T, int NMAX, bool WEIGHTED, int CLASS>
__global__ void __launch_bounds__(REG_THREADS) lockstep_kernel(Params a) {
  __shared__ float sc[NMAX], off[NMAX], mu[NMAX];
  __shared__ float xv[WEIGHTED ? NMAX * REG_THREADS : 1];
  __shared__ float wt[NMAX];
  for (int k = threadIdx.x; k < a.n; k += blockDim.x) {
    sc[k] = a.scale[k];
    off[k] = a.offset[k];
    mu[k] = a.mul[k];
    if (WEIGHTED && a.w_sp == 0) wt[k] = a.weights[k * a.w_sn];
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
    } else if (lane_loop_start<CLASS>(s)) {
      while (lane_step<CLASS>(a, s)) {
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
  const unsigned mid = span_mask(nl, nvalid - nh);
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
    """Count, per warp, its step iterations and the lanes stepping in
    them, and its refill iterations and the lanes acting in them."""
    s = _sub(s, "constexpr unsigned FULL_WARP = 0xffffffffu;",
             "__device__ unsigned long long g_cnt[4];\n"
             "constexpr unsigned FULL_WARP = 0xffffffffu;")
    s = _sub(s, "      if (stepping) stepping = lane_step<CLASS>(a, s);",
             "      const unsigned stepm = __ballot_sync(FULL_WARP, stepping);\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[0], 1ULL);\n"
             "        atomicAdd(&g_cnt[1], (unsigned long long)__popc(stepm));\n"
             "      }\n"
             "      if (stepping) stepping = lane_step<CLASS>(a, s);")
    s = _sub(s, "      if (__ballot_sync(FULL_WARP, act) == 0) break;",
             "      const unsigned actm = __ballot_sync(FULL_WARP, act);\n"
             "      if (actm == 0) break;\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[2], 1ULL);\n"
             "        atomicAdd(&g_cnt[3], (unsigned long long)__popc(actm));\n"
             "      }")
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


def variants(mode: str) -> dict:
    """name → (what it changes, edit of the source) for one mode."""
    ready = READY[mode]
    out = {
        "base": ("the source as it is", lambda s: s),
        "counted": ("the source with counters of the warps' steps and "
                    "refills (slower; read for lane use)", _counted),
    }
    for lanes in (4, 8, 16, 24, 32):
        what = f"a warp leaves its steps at {lanes} ready lanes"
        if lanes == 32:
            what += (" (all lanes done: lockstep with the queue)"
                     if mode != "winsorized" else " (all lanes settled)")
        out[f"ready{lanes}"] = (what, _ready(ready, lanes))
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
        "smem": ("the shared-memory path (one thread a column, the design "
                 "before the register path)",
                 lambda s: _sub(s, "{ return n <= 32 && rtype != GESDT; }",
                                "{ return false; }")),
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


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="winsorized")
    ap.add_argument("--size", choices=("block", "stack", "k1e"),
                    default="block")
    ap.add_argument("names", nargs="*", metavar="variant")
    args = ap.parse_args(argv)

    import time

    import torch

    import chip_smoke as cs
    from siril_tpu_torch.kernels import build as kb
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    table = variants(args.mode)
    names = args.names or list(table)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(kb.BUILD_DIR, f"variants-{args.mode}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    src = float_only(open(SRC).read())
    t = time.perf_counter()
    paths = build_all({name: table[name][1](src) for name in names},
                      out_dir)
    print(f"built {len(paths)} variants in {time.perf_counter() - t:.1f}s",
          flush=True)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.siril_reject_stack.argtypes = k1._ARGTYPES
        lib.siril_reject_stack.restype = ctypes.c_int
        lib.siril_reject_stack_needs_scratch.argtypes = [ctypes.c_int] * 3
        lib.siril_reject_stack_needs_scratch.restype = ctypes.c_int
        if name == "counted":
            lib.k1_counts.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.k1_counts.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = cs.FRAMES
    p = {"block": (256 << 20) // (cs.FRAMES * cs.SIZE * 4) * cs.SIZE,
         "stack": cs.SIZE * cs.SIZE, "k1e": 1 << 20}[args.size]
    stack = cs.make_stack(gen, n, p, dev)
    sc = 1.0 + 0.02 * torch.randn(n, generator=gen, device=dev)
    off, one = sc * 0.1 - 0.1, torch.ones_like(sc)
    wf = 0.5 + torch.rand(n, 1, generator=gen, device=dev)
    wp = 0.5 + torch.rand(n, p, generator=gen, device=dev)
    print(f"{args.mode} at N = {n}, P = {p} ({args.size})", flush=True)

    def batch_ms(fn, reps=10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    ref, base_ms = {}, {}
    for tag, w in ((args.mode, None), (f"{args.mode}, frame weights", wf),
                   (f"{args.mode}, pixel weights", wp)):
        for name in names:
            k1._library = lambda lib=libs[name]: lib

            def run():
                return k1.reject_mean(stack, sc, off, one,
                                      rtype=MODES[args.mode],
                                      mode=ADDITIVE_SCALING, siglow=3.0,
                                      sighigh=3.0, weights=w)

            out = run()
            ref.setdefault(tag, out)
            same = all(torch.equal(x, y) for x, y in zip(out, ref[tag]))
            times = sorted(batch_ms(run) for _ in range(5))
            base_ms.setdefault(tag, times[2])
            if name == "counted":
                cnt = (ctypes.c_ulonglong * 4)()
                libs[name].k1_counts(cnt, 1)
                run()
                torch.cuda.synchronize()
                libs[name].k1_counts(cnt, 0)
                print(f"{tag:30s} counted: {cnt[0]} warp steps with "
                      f"{cnt[1]} lanes stepping ({cnt[1] / 32 / max(cnt[0], 1):.1%}"
                      f" lane use); {cnt[2]} refill iterations with "
                      f"{cnt[3]} lanes acting "
                      f"({cnt[3] / max(cnt[2], 1):.1f} a warp)", flush=True)
            print(f"{tag:30s} {name:12s} {times[2]:.3f} ms "
                  f"(min {times[0]:.3f}, max {times[-1]:.3f}; "
                  f"{times[2] / base_ms[tag]:.3f}x the first), "
                  f"{'bit-equal to the first' if same else 'DIFFERS'}"
                  f" — {table[name][0]}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
