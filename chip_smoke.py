"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Phases, each printing a flushed start and end line with elapsed seconds:
  1. card   — device name, count, and nvidia-smi's name and power limit;
  2. build  — every kernel of the main path, from an empty build directory,
              with ptxas's registers, shared memory and spills for each
              instantiation (every register-path instantiation must be
              there, and none may spill or keep a stack frame);
  3. k1a    — the reject_stack kernel against its plain PyTorch version on
              the card: every window mode × {float32, int16} × {no norm,
              additive+scaling, multiplicative} at N=24, P=2^20, then one
              full row block of the main path (N=FRAMES, P=682·SIZE) with
              the winsorized σ steps its pixels took, and winsorized at
              N=64, P=2^20 (the shared-memory path);
  k1     — the variants K1b SIGMEDIAN, K1c LINEARFIT, K1d GESDT over the
              same dtypes and normalizations at N=24, P=2^20; K1b and K1c
              at N=8, 16, 32 (each register-path column size) and 33 (the
              shared-memory path); K1e (weights, per frame and per pixel)
              over winsorized, sigma, sigmedian, linearfit and GESDT ×
              {float32, int16}; one stack of 1000 frames; and each of
              K1b-K1e at the stack command's call size (N=FRAMES, P=SIZE²,
              float32, additive+scaling), with its bound and, for K1b and
              K1c, the rounds its pixels ran; for SIGMEDIAN, the pixels
              each version stopped at its round cap;
  4. fusedstack — the main path through the CLI entry point
              (``python -m siril_tpu_torch.cli -d <dir> fusedstack light_``)
              on FRAMES synthetic SIZE×SIZE 16-bit frames, checked against the
              known scene, with the time of each stage;
  stack  — the staged ``stack`` command through the CLI on FRAMES aligned
              float32 SIZE×SIZE frames (``r_light_``, as registration leaves
              them) with SIGMEDIAN, LINEARFIT, GESDT, noise weights, and
              rejection maps (the streamed row-block path), each checked
              against the known scene and its variant's launches.
Then a JSON line describing every kernel, the card line, and last the
result line.  Any failure exits non-zero without a result line.  The script
needs CUDA and the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()

# the main path's session: 24 mono 16-bit frames of 4096×4096 (bench.py:36)
FRAMES = 24
SIZE = 4096

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t
        state = "FAILED" if exc_type else "done"
        log(f"phase {self.name}: {state} in {dt:.2f}s")
        return False


def phase_card():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"device {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"card: {card}")
    return name, card


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, smem, stack, spill_stores, spill_loads}} from
    the ``-Xptxas -v`` output of a build."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return {k: v for k, v in out.items() if "registers" in v}


#: the register path's kernel and its mode classes (csrc/reject_stack.cu
#: CLASS_*); one instantiation per class, weighting, NMAX and input type
REGISTER_KERNEL = "register_kernel"
CLASSES = ("window", "winsorized", "sigmedian", "linearfit")
REGISTER_INSTANTIATIONS = len(CLASSES) * 2 * 4 * 2


def _kernel_label(mangled: str) -> str:
    """register_kernel<float, NMAX, weighted, class> or
    reject_stack_kernel<float, global> from a mangled name."""
    import re

    m = re.search(rf"({REGISTER_KERNEL}|reject_stack_kernel)I([fs])"
                  r"(?:Li(\d+)E)?Lb([01])E(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    name, t, nmax, flag, cls = m.groups()
    t = "float" if t == "f" else "int16"
    if nmax:
        return (f"{name}<{t}, NMAX={nmax}, weighted={flag == '1'}, "
                f"{CLASSES[int(cls)]}>")
    return f"{name}<{t}, global={flag == '1'}>"


def phase_build():
    from siril_tpu_torch.kernels import build

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    paths = build.build(["reject_stack"])
    dt = time.perf_counter() - t
    spilled, registers = [], 0
    for name, path in paths.items():
        log(f"built {name} → {os.path.relpath(path)} in {dt:.2f}s")
        for kern, r in sorted(ptxas_report(
                build.build_log.get(name, "")).items()):
            label = _kernel_label(kern)
            log(f"  ptxas {label}: {r['registers']} registers, "
                f"{r['smem']} B static smem, stack {r.get('stack', 0)} B, "
                f"spill stores {r.get('spill_stores', 0)} B, loads "
                f"{r.get('spill_loads', 0)} B")
            if REGISTER_KERNEL in kern:
                registers += 1
                if (r.get("spill_stores", 0) or r.get("spill_loads", 0)
                        or r.get("stack", 0)):
                    spilled.append(label)
    log(f"  {registers} register-path instantiations, built in {dt:.2f}s")
    if registers != REGISTER_INSTANTIATIONS:
        raise RuntimeError(f"ptxas reported {registers} register-path "
                           f"instantiations, not {REGISTER_INSTANTIATIONS}")
    if spilled:
        raise RuntimeError(f"the register path spills: {spilled}")
    return dt


def _events_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def make_stack(gen, n: int, p: int, device):
    """(n, p) float32 stack in [0, 1]: per-pixel level + noise, cosmic-ray
    and dead outliers, ~3% zeros, and on one pixel in 8 a heavy high tail
    with low outliers, so the N−r≤4 guard truncates the high side."""
    import torch

    base = 0.05 + 0.6 * torch.rand(p, generator=gen, device=device)
    x = base + 0.01 * torch.randn(n, p, generator=gen, device=device)
    u = torch.rand(n, p, generator=gen, device=device)
    x = torch.where(u < 0.02, 0.95, x)
    x = torch.where((u >= 0.02) & (u < 0.03), 0.002, x)
    guard = (torch.arange(p, device=device) % 8) == 0
    tail = torch.zeros(n, p, device=device)
    tail[-6:] = 0.3 + 0.4 * torch.rand(6, p, generator=gen, device=device)
    tail[:2] = -0.03
    x = torch.where(guard, x + tail, x)
    x = torch.where(torch.rand(n, p, generator=gen, device=device) < 0.03,
                    0.0, x)
    return x.clamp(0.0, 1.0).contiguous()


def compare_k1(name, stack, scale, offset, mul, rtype, mode, siglow,
               sighigh, time_plain_reps=1, work=None, **extra):
    """Kernel vs plain version on the card; returns a result dict.
    ``extra``: weights, critical, max_outliers of the K1b-K1e variants."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.rejection import SIGMEDIAN, WINSORIZED
    from siril_tpu_torch.ops.stacking import reject_stack_plain

    kw = dict(rtype=rtype, mode=mode, siglow=siglow, sighigh=sighigh,
              **extra)
    # loops stopped at their mode's bound, by each version
    capped0 = k1.capped_pixels()
    got = k1.reject_mean(stack, scale, offset, mul, **kw)
    capped_kernel = k1.capped_pixels() - capped0
    capped_plain = torch.zeros((), dtype=torch.int64, device=stack.device)
    refs = []
    plain_ms = _events_ms(
        lambda: refs.append(reject_stack_plain(
            stack, scale, offset, mul, work=None if refs else work,
            capped=None if refs else capped_plain, **kw)),
        time_plain_reps)
    ref = refs[0]
    torch.cuda.synchronize()
    capped_plain = int(capped_plain)
    # the kernel computes what the plain version computes, bit for bit
    nbad = int(((got[1] != ref[1]) | (got[2] != ref[2])).sum())
    err = float((got[0] - ref[0]).abs().max())
    p = stack.shape[1]
    ok = (nbad == 0 and err == 0.0 and bool(torch.isfinite(got[0]).all())
          and capped_kernel == capped_plain == 0)
    for _ in range(2):
        k1.reject_mean(stack, scale, offset, mul, **kw)
    ms = _events_ms(lambda: k1.reject_mean(stack, scale, offset, mul, **kw),
                    10)
    log(f"  {name}: count mismatches {nbad}/{p}, max|Δmean| {err:.3g}, rej "
        f"{int(got[1].sum())}/{int(got[2].sum())}, kernel {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms"
        + (f", loops stopped at their bound: kernel {capped_kernel} plain "
           f"{capped_plain}" if rtype in (SIGMEDIAN, WINSORIZED) else "")
        + ('' if ok else '  <-- DIFFERS FROM THE PLAIN VERSION'))
    return dict(ok=ok, nbad=nbad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                capped=capped_kernel)


def log_steps(name: str, work: dict, p: int) -> None:
    """The steps of each per-pixel loop the plain version counted for a
    call (winsorized σ steps, SIGMEDIAN and LINEARFIT rounds): per pixel
    on average, the most one pixel took, and the mean over warps of 32
    consecutive pixels of their slowest pixel's (what a warp with one
    pixel a lane would run)."""
    for loop, unit, what in (("winsor", "steps", "winsorized σ steps"),
                             ("sigmedian", "rounds", "SIGMEDIAN rounds"),
                             ("linearfit", "rounds", "LINEARFIT rounds")):
        if not work.get(f"{loop}_warps"):
            continue
        total = work[f"{loop}_{unit}"]
        log(f"  {name} {what}: {total} in all, {total / p:.2f} a pixel, at "
            f"most {work[f'{loop}_{unit}_max']}, warp-of-32 maximum "
            f"{work[f'{loop}_warp_{unit}'] / work[f'{loop}_warps']:.2f} on "
            f"average")


def phase_k1a(seed: int):
    import torch

    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        MULTIPLICATIVE,
        NO_NORM,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, p = 24, 1 << 20
    stack = make_stack(gen, n, p, dev)
    raw = (torch.round(stack * 65535.0) - 32768.0).to(torch.int16)
    scale = 1.0 + 0.05 * torch.randn(n, generator=gen, device=dev)
    offset = 0.01 * torch.randn(n, generator=gen, device=dev)
    mul = 1.0 + 0.03 * torch.randn(n, generator=gen, device=dev)
    modes = [("none", rj.NO_REJEC, 3.0, 3.0),
             ("percentile", rj.PERCENTILE, 0.2, 0.1),
             ("sigma", rj.SIGMA, 3.0, 3.0),
             ("mad", rj.MAD, 3.0, 3.0),
             ("winsorized", rj.WINSORIZED, 3.0, 3.0)]
    norms = [("nonorm", NO_NORM), ("addscale", ADDITIVE_SCALING),
             ("mul", MULTIPLICATIVE)]
    failures = []
    for mname, rtype, sl, sh in modes:
        for dname, data in (("f32", stack), ("i16", raw)):
            for nname, mode in norms:
                r = compare_k1(f"{mname}/{dname}/{nname} N={n} P={p}", data,
                               scale, offset, mul, rtype, mode, sl, sh)
                if not r["ok"]:
                    failures.append(f"{mname}/{dname}/{nname}")

    # one full row block of the main path: rows = 256 MiB // (n·W·4)
    frames = FRAMES
    rows = (256 << 20) // (frames * SIZE * 4)
    pb = rows * SIZE
    block = make_stack(gen, frames, pb, dev)
    sc = 1.0 + 0.02 * torch.randn(frames, generator=gen, device=dev)
    off = sc * 0.1 - 0.1
    work = {}
    full = compare_k1(f"main-path block N={frames} P={pb} "
                      "winsorized/f32/addscale", block, sc, off,
                      torch.ones_like(sc), rj.WINSORIZED, ADDITIVE_SCALING,
                      3.0, 3.0, time_plain_reps=3, work=work)
    if not full["ok"]:
        failures.append("main-path block")
    nbytes = frames * pb * 4 + 3 * frames * 4 + pb * 12
    ops = work.get("flops", 0) + work.get("compares", 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    full.update(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    log(f"  main-path block bound: {nbytes / 1e6:.1f} MB → {bytes_ms:.4f} "
        f"ms; {ops / 1e9:.2f} G float ops → {ops_ms:.4f} ms; kernel "
        f"{full['ms']:.3f} ms = {full['ms'] / full['bound_ms']:.2f}x the "
        f"bound, plain {full['plain_ms']:.1f} ms, no library call computes "
        "this function")
    log_steps("main-path block", work, pb)
    del block

    # winsorized at 64 frames: the shared-memory path
    n64 = 64
    st64 = make_stack(gen, n64, p, dev)
    c64 = 1.0 + 0.02 * torch.randn(n64, generator=gen, device=dev)
    work64 = {}
    r64 = compare_k1(f"winsorized/f32/addscale N={n64} P={p} (shared "
                     "memory)", st64, c64, c64 * 0.1 - 0.1,
                     torch.ones_like(c64), rj.WINSORIZED, ADDITIVE_SCALING,
                     3.0, 3.0, work=work64)
    log_steps(f"N={n64}", work64, p)
    if not r64["ok"]:
        failures.append(f"winsorized N={n64}")
    del st64
    if failures:
        raise RuntimeError(f"K1a out of tolerance: {failures}")
    return full


def _bound(nbytes: int, work: dict) -> dict:
    """The least time for the work: bytes over the HBM rate or float
    operations (and sort comparisons) over the f32 peak, the larger."""
    ops = work.get("flops", 0) + work.get("compares", 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


#: the stack command's variants: (variant, label, rtype, siglow, sighigh,
#: weighted) — K1e is the weighted mean (winsorized here)
STACK_VARIANTS = [("K1b", "sigmedian", 4, 3.0, 3.0, False),
                  ("K1c", "linearfit", 6, 3.0, 3.0, False),
                  ("K1d", "gesdt", 7, 0.3, 0.05, False),
                  ("K1e", "winsorized+weights", 5, 3.0, 3.0, True)]


def phase_k1(seed: int):
    """K1b-K1e against their plain versions; returns {variant: result}
    with each variant's worst error and its numbers at the stack
    command's call size."""
    import torch

    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        MULTIPLICATIVE,
        NO_NORM,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def coeffs(n, g=gen):
        return (1.0 + 0.05 * torch.randn(n, generator=g, device=dev),
                0.01 * torch.randn(n, generator=g, device=dev),
                1.0 + 0.03 * torch.randn(n, generator=g, device=dev))

    def gesdt_kw(rtype, n, sl, sh):
        if rtype != rj.GESDT:
            return {}
        mo = rj.gesdt_max_outliers(n, sl)
        return dict(max_outliers=mo,
                    critical=rj.gesdt_critical_values(n, sh, mo))

    n, p = 24, 1 << 20
    stack = make_stack(gen, n, p, dev)
    raw = (torch.round(stack * 65535.0) - 32768.0).to(torch.int16)
    scale, offset, mul = coeffs(n)
    norms = [("nonorm", NO_NORM), ("addscale", ADDITIVE_SCALING),
             ("mul", MULTIPLICATIVE)]
    errs = {v: 0.0 for v, *_ in STACK_VARIANTS}
    nbad = {v: 0 for v, *_ in STACK_VARIANTS}
    capped = {v: 0 for v, *_ in STACK_VARIANTS}
    failures = []

    def record(var, tag, r):
        errs[var] = max(errs[var], r["max_abs_err"])
        nbad[var] += r["nbad"]
        capped[var] += r["capped"]
        if not r["ok"]:
            failures.append(tag)

    for var, label, rtype, sl, sh, _ in STACK_VARIANTS[:3]:
        for dname, data in (("f32", stack), ("i16", raw)):
            for nname, mode in norms:
                tag = f"{var} {label}/{dname}/{nname} N={n} P={p}"
                record(var, tag, compare_k1(
                    tag, data, scale, offset, mul, rtype, mode, sl, sh,
                    **gesdt_kw(rtype, n, sl, sh)))
    # K1b and K1c at each register-path column size NMAX = 8, 16, 32 and
    # past it (N = 33: shared memory), on data of their own generator
    gen_n = torch.Generator(device=dev)
    gen_n.manual_seed(seed + 2)
    for nn in (8, 16, 32, 33):
        st = make_stack(gen_n, nn, p, dev)
        sraw = (torch.round(st * 65535.0) - 32768.0).to(torch.int16)
        cs, co, cm = coeffs(nn, gen_n)
        for var, label, rtype, sl, sh, _ in STACK_VARIANTS[:2]:
            for dname, data in (("f32", st), ("i16", sraw)):
                tag = f"{var} {label}/{dname}/addscale N={nn} P={p}"
                record(var, tag, compare_k1(tag, data, cs, co, cm, rtype,
                                            ADDITIVE_SCALING, sl, sh))
        del st, sraw
    wf = 0.5 + torch.rand(n, 1, generator=gen, device=dev)
    wp = 0.5 + torch.rand(n, p, generator=gen, device=dev)
    for label, rtype, sl, sh in (("winsorized", rj.WINSORIZED, 3.0, 3.0),
                                 ("sigma", rj.SIGMA, 3.0, 3.0),
                                 ("sigmedian", rj.SIGMEDIAN, 3.0, 3.0),
                                 ("linearfit", rj.LINEARFIT, 3.0, 3.0),
                                 ("gesdt", rj.GESDT, 0.3, 0.05)):
        for dname, data in (("f32", stack), ("i16", raw)):
            for wname, w in (("frame", wf), ("pixel", wp)):
                tag = (f"K1e {label}/{dname}/addscale weights per {wname} "
                       f"N={n} P={p}")
                record("K1e", tag, compare_k1(
                    tag, data, scale, offset, mul, rtype, ADDITIVE_SCALING,
                    sl, sh, weights=w, **gesdt_kw(rtype, n, sl, sh)))
    del stack, raw, wp

    # more frames than shared memory holds: columns in global scratch
    # (SIGMEDIAN: its plain version's cost grows least with N)
    nb, pb = 1000, 1 << 14
    big = make_stack(gen, nb, pb, dev)
    bs, bo, bm = coeffs(nb)
    tag = f"K1b sigmedian/f32/addscale N={nb} P={pb} (global columns)"
    record("K1b", tag, compare_k1(tag, big, bs, bo, bm, rj.SIGMEDIAN,
                                  ADDITIVE_SCALING, 3.0, 3.0))
    del big

    # each variant at the stack command's call size: the resident layer
    results = {}
    nf, pf = FRAMES, SIZE * SIZE
    full = make_stack(gen, nf, pf, dev)
    sc = 1.0 + 0.02 * torch.randn(nf, generator=gen, device=dev)
    off = sc * 0.1 - 0.1
    one = torch.ones_like(sc)
    wframe = 0.5 + torch.rand(nf, 1, generator=gen, device=dev)
    for var, label, rtype, sl, sh, weighted in STACK_VARIANTS:
        extra = gesdt_kw(rtype, nf, sl, sh)
        if weighted:
            extra["weights"] = wframe
        work = {}
        tag = f"{var} {label}/f32/addscale N={nf} P={pf} (stack call size)"
        r = compare_k1(tag, full, sc, off, one, rtype, ADDITIVE_SCALING, sl,
                       sh, work=work, **extra)
        record(var, tag, r)
        # the stack once, 3 coefficient vectors, 12 B per pixel out; a
        # weighted mean its per-frame weights; GESDT its λ table
        nbytes = nf * pf * 4 + 3 * nf * 4 + pf * 12
        if weighted:
            nbytes += nf * 4
        if "critical" in extra:
            nbytes += 4 * len(extra["critical"])
        r.update(_bound(nbytes, work))
        r["max_abs_err"] = errs[var]
        r["nbad_all"] = nbad[var]
        log(f"  {var} bound at the stack call size: {nbytes / 1e6:.1f} MB "
            f"→ {r['bytes_ms']:.4f} ms; {r['ops'] / 1e9:.2f} G operations "
            f"→ {r['ops_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); kernel {r['ms']:.3f} ms = "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound; plain "
            f"{r['plain_ms']:.1f} ms; count mismatches over all its "
            f"configurations {nbad[var]}"
            + (f", loops stopped at their bound {capped[var]}"
               if var in ("K1b", "K1e") else "")
            + "; no library call computes this function")
        log_steps(f"{var} at the stack call size", work, pf)
        results[var] = r
    del full
    if failures:
        raise RuntimeError(f"K1b-K1e out of tolerance: {failures}")
    return results


def synth_frames(seed: int, n: int, size: int, aligned: bool = False):
    """A scene of Gaussian stars on a sky background, and ``n`` frames of
    it shifted by integer + sub-pixel offsets, with noise and cosmic rays.
    Returns (scene, frames u16 list, shifts, noise σ, ray value).  With
    ``aligned`` the frames are not shifted (as registration leaves them)
    and are float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sky, sigma_n, ray = 0.1, 0.01, 1.0
    nstars = 4000
    sx = rng.uniform(40, size - 40, nstars)
    sy = rng.uniform(40, size - 40, nstars)
    amp = 0.5 * rng.pareto(1.5, nstars) * 0.02 + 0.02
    amp = np.minimum(amp, 0.55)
    psf_s = 1.3

    def render(dx, dy):
        img = np.full((size, size), sky, np.float32)
        r = 6
        oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
        cx = sx + dx
        cy = sy + dy
        ix = np.floor(cx).astype(np.int64)
        iy = np.floor(cy).astype(np.int64)
        px = ix[:, None, None] + ox[None]
        py = iy[:, None, None] + oy[None]
        d2 = (px + 0.5 - cx[:, None, None]) ** 2 + \
            (py + 0.5 - cy[:, None, None]) ** 2
        val = amp[:, None, None] * np.exp(-d2 / (2 * psf_s ** 2))
        np.add.at(img, (py.ravel(), px.ravel()), val.ravel().astype(
            np.float32))
        return img

    scene = render(0.0, 0.0)
    shifts = [(0.0, 0.0)] * n if aligned else \
        [(0.0, 0.0)] + [(float(rng.integers(-12, 13)
                               + rng.uniform(-0.5, 0.5)),
                         float(rng.integers(-12, 13)
                               + rng.uniform(-0.5, 0.5)))
                        for _ in range(n - 1)]
    frames = []
    for dx, dy in shifts:
        f = scene.copy() if aligned else render(dx, dy)
        f += sigma_n * rng.standard_normal((size, size), dtype=np.float32)
        k = size * size // 4000
        f[rng.integers(0, size, k), rng.integers(0, size, k)] = ray
        f = np.clip(f, 0, 1)
        frames.append(f if aligned else
                      np.rint(f * 65535.0).astype(np.uint16))
    return scene, frames, shifts, sigma_n, ray


def write_u16_fits(path: str, u16) -> None:
    """Minimal 16-bit FITS (BZERO 32768, bottom-up rows)."""
    import numpy as np

    h, w = u16.shape
    cards = ["SIMPLE  =                    T", "BITPIX  =                   16",
             "NAXIS   =                    2",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}",
             "BZERO   =              32768.0", "BSCALE  =                  1.0",
             "EXPTIME =                 60.0", "END"]
    hdr = "".join(c.ljust(80) for c in cards).encode("ascii")
    hdr += b" " * ((-len(hdr)) % 2880)
    body = (u16[::-1].astype(np.int32) - 32768).astype(">i2").tobytes()
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(b"\0" * ((-len(body)) % 2880))


def write_f32_fits(path: str, img) -> None:
    """Minimal float32 FITS (BITPIX -32, bottom-up rows)."""
    import numpy as np

    h, w = img.shape
    cards = ["SIMPLE  =                    T", "BITPIX  =                  -32",
             "NAXIS   =                    2",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}",
             "EXPTIME =                 60.0", "END"]
    hdr = "".join(c.ljust(80) for c in cards).encode("ascii")
    hdr += b" " * ((-len(hdr)) % 2880)
    body = np.ascontiguousarray(img[::-1]).astype(">f4").tobytes()
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(b"\0" * ((-len(body)) % 2880))


def phase_fusedstack(seed: int):
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.kernels import reject_stack as k1

    frames, size = FRAMES, SIZE
    t = time.perf_counter()
    scene, u16s, shifts, sigma_n, ray = synth_frames(seed, frames, size)
    log(f"  synthesized {frames} frames of {size}x{size} in "
        f"{time.perf_counter() - t:.2f}s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t = time.perf_counter()
        for i, u in enumerate(u16s):
            write_u16_fits(os.path.join(tmp, f"light_{i + 1:05d}.fit"), u)
        del u16s
        log(f"  wrote FITS in {time.perf_counter() - t:.2f}s")
        k1.reset_counts()
        t = time.perf_counter()
        session = cli.run(["-d", tmp, "fusedstack", "light_"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = sum(k1.launches.values())
        res = session.result
        if res is None:
            raise RuntimeError("fusedstack produced no result")
        for stage, s in res.stage_s.items():
            log(f"  stage {stage:<10} {s:8.3f} s")
        log(f"  fusedstack wall {wall:.2f}s, K1a launches {launches}")
        out = res.image.host()[0]
        rows = (256 << 20) // (frames * size * 4)
        want_blocks = -(-size // rows)
        reg = session.sequence.reg(0)
        m = 48
        inner = np.s_[m:-m, m:-m]
        err = float(np.abs(out[inner] - scene[inner]).mean())
        rl, rh = res.total_rejected
        checks = {
            "all frames registered": int(reg.valid.sum()) == frames,
            f"K1a launches == {want_blocks} row blocks":
                launches == want_blocks,
            "interior mean |Δ| < noise/3": err < sigma_n / 3,
            "cosmic rays rejected (rej_high > 0)": rh > 0,
            "no loop stopped at its bound": res.capped == 0,
            "result max well below the ray value":
                float(out.max()) < 0.8 * ray,
            "result finite, expected shape":
                bool(np.isfinite(out).all()) and out.shape == (size, size),
            "result file written":
                os.path.exists(os.path.join(tmp, "light_fused.fit")),
        }
        log(f"  interior mean |Δ| vs scene {err:.5f} (noise {sigma_n}), "
            f"rejected low/high {rl}/{rh}, max {float(out.max()):.4f}")
        for name, good in checks.items():
            log(f"  check {name}: {'ok' if good else 'FAILED'}")
        if not all(checks.values()):
            raise RuntimeError("fusedstack checks failed")
        return launches, res.stage_s, wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the stack commands of the stack phase and the variant each must launch
STACK_RUNS = [("K1b", "rej a 3 3 -norm=addscale"),
              ("K1c", "rej l 3 3 -norm=addscale"),
              ("K1d", "rej g 0.3 0.05 -norm=addscale"),
              ("K1e", "rej w 3 3 -norm=addscale -weight_from_noise"),
              ("K1a", "rej w 3 3 -norm=addscale -rejmaps")]


def phase_stack(seed: int):
    """The staged stack command on aligned float32 frames; returns
    ({variant: launches}, {command: stage seconds})."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.kernels import reject_stack as k1

    frames, size = FRAMES, SIZE
    t = time.perf_counter()
    scene, f32s, _, sigma_n, ray = synth_frames(seed + 7, frames, size,
                                                aligned=True)
    log(f"  synthesized {frames} aligned float32 frames of {size}x{size} "
        f"in {time.perf_counter() - t:.2f}s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stack_")
    launches = dict.fromkeys(k1.launches, 0)
    stages = {}
    try:
        t = time.perf_counter()
        for i, f in enumerate(f32s):
            write_f32_fits(os.path.join(tmp, f"r_light_{i + 1:05d}.fit"), f)
        del f32s
        log(f"  wrote FITS in {time.perf_counter() - t:.2f}s")
        m = 48
        inner = np.s_[m:-m, m:-m]
        failed = []
        for var, cmd in STACK_RUNS:
            words = ["-d", tmp, "stack", "r_light_", *cmd.split()]
            k1.reset_counts()
            t = time.perf_counter()
            session = cli.run(words)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = dict(k1.launches)
            for key, v in counts.items():
                launches[key] += v
            res = session.result
            out = res.image.host()[0]
            err = float(np.abs(out[inner] - scene[inner]).mean())
            rl, rh = res.total_rejected
            stages[cmd] = dict(res.stage_s, wall=wall)
            log(f"  stack r_light_ {cmd}: wall {wall:.2f}s, launches "
                f"{ {k: v for k, v in counts.items() if v} }, interior "
                f"mean |Δ| {err:.5f} (noise {sigma_n}), rejected low/high "
                f"{rl}/{rh}, max {float(out.max()):.4f}, loops stopped at "
                f"their bound {res.capped}")
            log("    stages: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in res.stage_s.items()))
            checks = {
                "interior mean |Δ| < noise/3": err < sigma_n / 3,
                "cosmic rays rejected (rej_high > 0)": rh > 0,
                "result max well below the ray value":
                    float(out.max()) < 0.8 * ray,
                "result finite, expected shape":
                    bool(np.isfinite(out).all())
                    and out.shape == (size, size),
                f"{var} launched": counts[var] > 0,
                "no loop stopped at its bound": res.capped == 0,
                "result file written": os.path.exists(
                    os.path.join(tmp, "r_light_stacked.fit")),
            }
            if "-rejmaps" in cmd:
                checks["rejection maps written"] = all(
                    os.path.exists(os.path.join(tmp, f"rejmap_{s}.fit"))
                    for s in ("low", "high"))
            for name, good in checks.items():
                if not good:
                    log(f"    check {name}: FAILED")
                    failed.append(f"{cmd}: {name}")
        if failed:
            raise RuntimeError(f"stack checks failed: {failed}")
        return launches, stages
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    log(f"chip_smoke start (python {sys.version.split()[0]}, "
        f"cwd {os.getcwd()})")

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "siril_tpu_torch")):
        log("the siril_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs one card")
        return 2

    with Phase("card"):
        kind, card = phase_card()
    with Phase("build"):
        phase_build()
    with Phase("k1a"):
        k1a = phase_k1a(args.seed)
    with Phase("k1"):
        k1v = phase_k1(args.seed)
    with Phase("fusedstack"):
        launches, stages, wall = phase_fusedstack(args.seed)
    with Phase("stack"):
        stack_launches, _ = phase_stack(args.seed)
    src = "siril_tpu_torch/csrc/reject_stack.cu"
    tpu = "siril_tpu/pallas/reject_stack.py"
    kernels = [dict(name="reject_stack (K1a)", launches=launches,
                    replaces=f"{tpu}:763", **k1a)]
    lines = {"K1b": 478, "K1c": 521, "K1d": 586, "K1e": 719}
    for var, *_ in STACK_VARIANTS:
        kernels.append(dict(name=f"reject_stack ({var})",
                            launches=stack_launches[var],
                            replaces=f"{tpu}:{lines[var]}", **k1v[var]))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    report = {"kernels": [
        dict(name=k["name"], route="cuda", source=src,
             replaces=k["replaces"], launches=k["launches"],
             **{key: k[key] for key in keys}, library_ms=None)
        for k in kernels]}
    log(f"chip_smoke done in {time.perf_counter() - T0:.1f}s")
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
