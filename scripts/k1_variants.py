"""Time design variants of kernel K1's register path on one CUDA card.

    python3 scripts/k1_variants.py [variant ...]

Each variant is a textual edit of ``siril_tpu_torch/csrc/reject_stack.cu``
(see ``VARIANTS``), built with the port's nvcc flags into a scratch
directory beside the build directory and bound through the wrapper.  Every
variant runs winsorized rejection on chip_smoke.py's main-path block (24
frames × 2,793,472 pixels, float32, additive+scaling; unweighted and with
per-frame weights) and must give the unmodified source's result bit for
bit.  Times are CUDA events around 10 back-to-back launches, median of 5.
Needs CUDA and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SRC = os.path.join(HERE, "siril_tpu_torch", "csrc", "reject_stack.cu")

LOCKSTEP = '''
template <typename T, int NMAX, bool WEIGHTED, bool WINSOR>
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
    if (WINSOR && s.nvalid > 1) {
      bool round = true;
      while (round) {
        if (lane_round_start(a.n, s)) {
          while (lane_sigma_step(a, s)) {
          }
        }
        round = reg_clip_round(s.xs, a.n, s.w, s.med, s.sigma, a.siglow,
                               a.sighigh) && (s.w.hi - s.w.lo) > 3;
      }
    } else if (!WINSOR) {
      lane_reject(a, s);
    }
    lane_finish<T>(a, xcol, wt, s);
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


def _counted(s: str) -> str:
    """Count, per warp, its σ-step iterations and the lanes stepping in
    them, and its refill iterations and the lanes acting in them."""
    s = _sub(s, "constexpr unsigned FULL_WARP = 0xffffffffu;",
             "__device__ unsigned long long g_cnt[4];\n"
             "constexpr unsigned FULL_WARP = 0xffffffffu;")
    s = _sub(s, "      if (stepping) stepping = lane_sigma_step(a, s);",
             "      const unsigned stepm = __ballot_sync(FULL_WARP, stepping);\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[0], 1ULL);\n"
             "        atomicAdd(&g_cnt[1], (unsigned long long)__popc(stepm));\n"
             "      }\n"
             "      if (stepping) stepping = lane_sigma_step(a, s);")
    s = _sub(s, "      if (__ballot_sync(FULL_WARP, act) == 0) break;",
             "      const unsigned actm = __ballot_sync(FULL_WARP, act);\n"
             "      if (actm == 0) break;\n"
             "      if (lane == 0) {\n"
             "        atomicAdd(&g_cnt[2], 1ULL);\n"
             "        atomicAdd(&g_cnt[3], (unsigned long long)__popc(actm));\n"
             "      }")
    return s + COUNTERS


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
    return s.replace(old, new)


def _lockstep(s: str) -> str:
    s = _sub(s, "template <typename T, int NMAX, bool WEIGHTED, bool WINSOR>\n"
             "cudaError_t launch_reg(",
             LOCKSTEP + "\ntemplate <typename T, int NMAX, bool WEIGHTED, "
             "bool WINSOR>\ncudaError_t launch_reg(")
    return _sub(s, "  auto kernel = reg_window_kernel<T, NMAX, WEIGHTED, "
                "WINSOR>;", "  auto kernel = lockstep_kernel<T, NMAX, "
                "WEIGHTED, WINSOR>;")


#: name → (what it changes, edit of the source)
VARIANTS = {
    "base": ("the source as it is", lambda s: s),
    "counted": ("the source with counters of the warps' σ steps and "
                "refills (slower; read for lane use)", _counted),
    "ready16": ("a warp leaves its σ steps at 16 ready lanes, not 24",
                lambda s: _sub(s, "constexpr int READY_LANES = 24;",
                               "constexpr int READY_LANES = 16;")),
    "ready32": ("... at 32 ready lanes (all lanes settled)",
                lambda s: _sub(s, "constexpr int READY_LANES = 24;",
                               "constexpr int READY_LANES = 32;")),
    "nmax32": ("N = 24 in the NMAX = 32 instantiation (no NMAX = 24)",
               lambda s: _sub(s, "  if (a.n <= 24) return launch_reg<T, 24, "
                              "WEIGHTED, WINSOR>(a, stream);\n", "")),
    "lockstep": ("one pixel a lane in lockstep: no warp vote, no queue",
                 _lockstep),
    "serial_loads": ("each frame's load issued inside the normalization "
                     "loop, behind a branch (the earlier layout)",
                     lambda s: _sub(s, "norm_value<T>(a, sc, off, mu, k, "
                                    "raw[k])", "norm_value<T>(a, sc, off, mu, "
                                    "k, (float)((const T*)a.stack)"
                                    "[(size_t)k * a.p + s.px])")),
    "smem": ("the shared-memory path (one thread a column) at N = 24",
             lambda s: _sub(s, "  return n <= 32 && (rtype == NO_REJEC",
                            "  return false && (rtype == NO_REJEC")),
}


def build(name: str, src: str, out_dir: str) -> str:
    from siril_tpu_torch.kernels import build as kb

    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                         f"{proc.stderr}")
    return so


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from siril_tpu_torch.kernels import build as kb
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    names = argv or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(kb.BUILD_DIR, "variants")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    src = open(SRC).read()
    libs = {}
    for name in names:
        lib = ctypes.CDLL(build(name, VARIANTS[name][1](src), out_dir))
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
    n, p = cs.FRAMES, (256 << 20) // (cs.FRAMES * cs.SIZE * 4) * cs.SIZE
    block = cs.make_stack(gen, n, p, dev)
    sc = 1.0 + 0.02 * torch.randn(n, generator=gen, device=dev)
    off, one = sc * 0.1 - 0.1, torch.ones_like(sc)
    wf = 0.5 + torch.rand(n, 1, generator=gen, device=dev)

    def batch_ms(fn, reps=10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    ref = {}
    for tag, w in (("winsorized", None), ("winsorized, frame weights", wf)):
        for name in names:
            k1._library = lambda lib=libs[name]: lib

            def run():
                return k1.reject_mean(block, sc, off, one,
                                      rtype=rj.WINSORIZED,
                                      mode=ADDITIVE_SCALING, siglow=3.0,
                                      sighigh=3.0, weights=w)

            out = run()
            ref.setdefault(tag, out)
            same = all(torch.equal(x, y) for x, y in zip(out, ref[tag]))
            times = sorted(batch_ms(run) for _ in range(5))
            if name == "counted":
                cnt = (ctypes.c_ulonglong * 4)()
                libs[name].k1_counts(cnt, 1)
                run()
                torch.cuda.synchronize()
                libs[name].k1_counts(cnt, 0)
                print(f"{tag:26s} counted: {cnt[0]} warp σ steps with "
                      f"{cnt[1]} lanes stepping ({cnt[1] / 32 / cnt[0]:.1%}"
                      f" lane use); {cnt[2]} refill iterations with "
                      f"{cnt[3]} lanes acting ({cnt[3] / cnt[2]:.1f} a "
                      "warp)", flush=True)
            print(f"{tag:26s} {name:9s} {times[2]:.3f} ms "
                  f"(min {times[0]:.3f}, max {times[-1]:.3f}), "
                  f"{'bit-equal to base' if same else 'DIFFERS FROM BASE'}"
                  f" — {VARIANTS[name][0]}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
