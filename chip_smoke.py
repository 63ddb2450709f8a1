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
              the winsorized σ steps its pixels took, winsorized at
              N=64, P=2^20 (the column kernel), and winsorized at the
              masters' frame count (N=CALIB_FRAMES, P=2^20, both dtypes
              and all three normalizations; then int16 at the masters'
              call size, P=SIZE², without normalization and
              multiplicative), and at the stacks' full calls
              (K1A_CALLS: the OSC stack's, N=OSC_LIGHTS, P=SIZE², int16;
              the Bayer-drizzle stack's, the same in float32 with holes;
              the -upscale stack's, N=4, P=(2·SIZE)², int16; all
              additive+scaling), the plain version on 2^20 pixels spread
              over P;
  k1     — the variants K1b SIGMEDIAN, K1c LINEARFIT, K1d GESDT over the
              same dtypes and normalizations at N=24, P=2^20; K1b, K1c and
              K1d at N=8, 16, 32 (register-path column sizes; K1d also
              over every normalization and with weights); K1e (weights,
              per frame and per pixel) over winsorized, sigma, sigmedian,
              linearfit and GESDT × {float32, int16}, and winsorized with
              per-pixel weights at a tile's size (N=4, P=SIZE²,
              float32); and each of K1b-K1e
              at the stack command's call size (N=FRAMES, P=SIZE²,
              float32, additive+scaling), with its bound and, for K1b and
              K1c, the rounds its pixels ran; for SIGMEDIAN, the pixels
              each version stopped at its round cap;
  k1col  — past 32 frames: every mode at N=33 (P=2^20), 48, 64 (the
              register path at NMAX=48, 64 where the library sends the
              mode there, else the column kernel), 100, 300 and 1000 (the
              column kernel), with weights (past 875 frames a weighted
              mean takes the global-scratch layout) and int16 (winsorized,
              SIGMEDIAN, LINEARFIT), and SIGMEDIAN at N=1000, P=2^14;
              then the column kernel timed at the 100-frame stack
              command's call size (N=STACK100, P=SIZE100², winsorized and
              GESDT) and winsorized at N=128, 300 (P=SIZE²) and 1000
              (P=2^20), each held against the plain version on 2^14
              pixels in runs spread over P, with the bound from the plain
              version's work on them scaled to P;
  warps  — each rung of the FFT warp ladder on 4 frames of SIZE² rendered
              through exact maps of its family (rotation ±0.5°, affine
              scale 0.99-1.01, perspective third-row terms ~1e-6 /px; each
              with a frame turned by ~180°): the gates pick it, it agrees
              with the gather warp within WARP_GATHER_BOUND (held on the
              CPU by tests/test_torch_interp.py), its milliseconds per
              frame beside the gather warp's (CUDA events), and its peak
              device memory within what the fused path reserves;
  4. fusedstack — the main path through the CLI entry point
              (``python -m siril_tpu_torch.cli -d <dir> fusedstack light_``)
              on FRAMES synthetic SIZE×SIZE 16-bit frames, checked against the
              known scene, with the time of each stage;
  fusedstack_homography — ``fusedstack light_ -transf=homography`` on
              FRAMES turned 16-bit SIZE² lights (field rotation up to
              ±0.5°, the second half turned by a further 180°, shifts and
              ray tracks), checked as fusedstack, and the ladder's rung
              taken, not the gather warp;
  stack  — the staged ``stack`` command through the CLI on FRAMES aligned
              float32 SIZE×SIZE frames (``r_light_``, as registration leaves
              them) with SIGMEDIAN, LINEARFIT, GESDT, noise weights, and
              rejection maps (the streamed row-block path), then on
              STACK100 aligned float32 SIZE100×SIZE100 frames (the column
              kernel) with winsorized and GESDT rejection, each checked
              against the known scene and its variant's launches;
  script — the standard preprocessing script through the CLI's -s entry
              (``python -m siril_tpu_torch.cli -d <dir> -s <script>``,
              PREPROCESSING_SCRIPT) on a synthetic night of CALIB_FRAMES
              biases, flats and darks and SCRIPT_LIGHTS 16-bit SIZE×SIZE
              lights
              (bias, dark current with hot pixels, a vignetting flat,
              cosmic-ray tracks, frames turned by up to 0.2° and scaled by
              up to 0.1 %): convert, the masters, calibrate -cc=dark,
              register (homography, lanczos4) and stack, with each
              command's wall, stages and K1 launches; then fusedstack
              -bias= -dark= -flat= -cc=dark with the same masters on
              as many lights that are only shifted; both checked against the
              known scene, its hot pixels and rays; and between them ``stack
              r_pp_light rej 3 3 -norm=addscale -filter-fwhm=90%`` (the
              kept count and the scene) and ``stack r_pp_light sum``;
  osc    — the one-shot-colour script (OSC_SCRIPT) through -s on the
              script phase's raw biases and darks and a colour night of
              CALIB_FRAMES flats (a coloured panel) and OSC_LIGHTS 16-bit
              RGGB SIZE² lights (coloured stars and sky, shifts, ray
              tracks): the masters, calibrate -cfa -equalize_cfa
              -debayer (RCD), register on layer 0, stack -output_norm
              -rgb_equal (K1a once a layer); the result's three layers
              against the scene after one affine fit each, the stars'
              R/G and B/G flux ratios, the hot pixels, the rays; then
              every demosaic method on the card against the CPU on a
              DEMOSAIC_CROP² crop of a light, and timed on a SIZE² one;
  drizzle — in the osc phase's directory, the Bayer-drizzle script
              (OSC_DRIZZLE_SCRIPT) through -s: calibrate -cfa
              -equalize_cfa without demosaicing, register -drizzle on the
              raw mosaic (scale 1, the master flat as the weight plane),
              the stack; each layer against the scene after an affine
              fit (DRIZZLE_SHARE), the star colours, the rays, H; then
              ``stack cfa_light -drizzle -scale=1.0`` (its weight map),
              and on the script phase's pp_light ``stack pp_light
              -drizzle -scale=2 -pixfrac=0.9`` ((2·SIZE)², binned against
              the scene) and ``stack pp_light rej 3 3 -norm=addscale
              -upscale`` on 4 frames selected in the .seq (against the
              same 4 stacked without it); drizzle's ms per frame and
              peak device memory, and every device stage on the card
              against the CPU on a DRIZZLE_CROP² crop;
  astrometry — on the script phase's scene (its stars on the sky
              through a TAN WCS, as a KStars catalogue) and pp_light:
              ``platesolve`` of its stack from hints HINT_OFF off (CRVAL,
              scale and rotation against the truth), ``conesearch``,
              ``healpix``, ``trixel`` and ``show`` counted against the
              truth; ``register pp_light -3stars`` against register's H;
              DISTO_LIGHTS lights rendered through a known SIP
              (DISTO_SIP), ``platesolve -order=3`` of one saved as the
              master, ``register -noout`` and ``seqapplyreg -disto=``,
              bright isolated stars against their undistorted positions;
              the SIP warp's ms per frame beside the gather warp's and
              the card against the CPU on a SIP_CROP² crop;
  formats — FORMATS_LIGHTS of the script phase's raw lights: convert
              -fitseq, convert -ser, link, and rej 3 3 stacks of the
              cube (bit-equal to the regular one's), the SER video
              (SER_MEAN_TOL, SER_FLIPS) and the files; a light as BITPIX
              8, 32 and -64; setcompress rice and gzip2, save, load; the
              C++ Rice coder's ms and bytes; a 4-frame fz sequence; the
              lights as an 8-bit uncompressed AVI, converted and stacked
              (bit-equal to the stack of the same frames as FITS);
  mosaic — 4 SIZE² tiles with MOSAIC_OVERLAP px overlaps of one sky, each
              an exposure through its own TAN projection with its own
              level and gain and a pointing hint in its header, and the
              sky's catalogue: ``seqplatesolve mosaic_`` and
              ``seqapplyreg mosaic_ -framing=max`` (the homographies from
              the WCS solutions, each within MOSAIC_H_TOL px of the true
              map), then on the warped canvas ``stack r_mosaic_ rej 3 3
              -norm=addscale -overlap_norm -feather=64`` (K1e with
              per-pixel weights; the level across each seam; then K1e
              held against its plain version on each of the call's row
              blocks, on the inputs the command gave it: the canvas's
              frames, zero outside each footprint, and the feather
              masks, zero there too) and ``stack r_mosaic_ max
              -maximize`` (the union of the footprints);
  post   — the post-stack colour session through -s on two stacked SIZE²
              RGB fields of one sky (synth_post: a quadratic gradient,
              stars imbalanced by POST_IMBALANCE, coloured by their
              spectra in an xp_sampled .cat or by B−V in a CSV):
              POST_SCRIPT (subsky 2, spcc, autostretch, ght, asinh,
              rmgreen, satu, eqcrop, crop, rotate, binxy, save) and
              PCC_SCRIPT (subsky 2, pcc, bgneutralize, save), with each
              command's seconds and host / device stages; the gradient
              left below POST_NOISE / 3, the gains of spcc and pcc
              within POST_GAIN_TOL of the imbalance, bgneutralize's
              medians equal; then every image op on the card against
              the CPU (POST_CROP², the rotation and the background
              models POST_WARP_CROP²) within the CPU tests' bounds, its
              ms per SIZE² RGB image and the RBF's peak memory, on a
              JSON line of its own.  No K1;
  enhance — in the post phase's directory, the enhancement session
              (ENHANCE_SCRIPT) through -s on its colour-calibrated field:
              makepsf stars, rl, denoise, a star mask blurred and an
              unsharp through it, wavelet / wrecons, epf -guided,
              fmedian, clahe, pm, fftd / ffti, with each command's
              seconds, stages and peak device memory; rl narrowing the
              ENHANCE_STARS brightest isolated unclipped stars by
              RL_NARROWING and keeping their fluxes within FLUX_TOL,
              denoise halving each layer's background noise and keeping
              the fluxes, the masked unsharp bit-equal where the mask is
              0, fftd → ffti and wrecons 1 … 1 returning their inputs;
              then every op of enhance_ops on the card against the CPU
              (ENHANCE_CROP², NL-Bayes and DA3D ENHANCE_DENOISE_CROP²,
              one step of each blind engine), its ms per SIZE² RGB image
              and peak memory (fmedian 5 and 9 too) but for the
              session's own, and denoise -da3d, -sos=1 and the two blind
              engines on an ENHANCE_LAYER² layer, on a JSON line of its
              own.  No K1.
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

# the column kernel's session: 100 aligned float32 frames of 2048×2048
STACK100 = 100
SIZE100 = 2048

# the script phase: Siril's mono preprocessing script (Mono_Preprocessing.
# ssf) with bias-subtracted darks, so that fusedstack can take the same
# masters as -bias= -dark= -flat=
PREPROCESSING_SCRIPT = """requires 1.2.0
cd biases
convert bias -out=../process
cd ../process
stack bias rej 3 3 -nonorm -out=bias_stacked
cd ../flats
convert flat -out=../process
cd ../process
calibrate flat -bias=bias_stacked
stack pp_flat rej 3 3 -norm=mul -out=pp_flat_stacked
cd ../darks
convert dark -out=../process
cd ../process
calibrate dark -bias=bias_stacked
stack pp_dark rej 3 3 -nonorm -out=pp_dark_stacked
cd ../lights
convert light -out=../process
cd ../process
calibrate light -bias=bias_stacked -dark=pp_dark_stacked -flat=pp_flat_stacked -cc=dark
register pp_light
stack r_pp_light rej 3 3 -norm=addscale {stack_flags}-out=result
close
"""

# the osc phase: Siril's one-shot-colour preprocessing script
# (OSC_Preprocessing.ssf) up to its stack, on the script phase's biases and
# darks and a colour night's flats and lights (the reference script then
# mirrors and saves the result, image-op commands not ported yet); 16
# lights at first, cut to 12 to make room for the astrometry phase and to
# 8 for the enhance phase (the checks' tolerances scale with the count)
OSC_LIGHTS = 8
OSC_SCRIPT = """requires 1.2.0
cd biases
convert bias -out=../osc
cd ../osc
stack bias rej 3 3 -nonorm -out=bias_stacked
cd ../osc_flats
convert flat -out=../osc
cd ../osc
calibrate flat -bias=bias_stacked
stack pp_flat rej 3 3 -norm=mul -out=pp_flat_stacked
cd ../darks
convert dark -out=../osc
cd ../osc
stack dark rej 3 3 -nonorm -out=dark_stacked
cd ../osc_lights
convert light -out=../osc
cd ../osc
calibrate light -dark=dark_stacked -flat=pp_flat_stacked -cc=dark -cfa -equalize_cfa -debayer
register pp_light
stack r_pp_light rej 3 3 -norm=addscale -output_norm -rgb_equal -out=result
close
"""

# the drizzle phase: Siril's Bayer-drizzle preprocessing script
# (OSC_Preprocessing_BayerDrizzle.ssf) after its masters, run in the osc
# phase's directory on its converted raw lights and masters: calibrate
# without demosaicing, register on the raw mosaic and drizzle each
# light's CFA sites onto three planes, stack
OSC_DRIZZLE_SCRIPT = """requires 1.2.0
calibrate light -dark=dark_stacked -flat=pp_flat_stacked -cc=dark -cfa -equalize_cfa -prefix=cfa_
register cfa_light -drizzle -scale=1.0 -pixfrac=1.0 -kernel=square -flat=pp_flat_stacked
stack r_cfa_light rej 3 3 -norm=addscale -output_norm -rgb_equal -out=result_drizzle
close
"""

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
#: where the drizzle phase puts its own tensors (the card; a small run of
#: the phase on the CPU sets "cpu")
CARD = "cuda"
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
#: CLASS_*) with their modes; one instantiation per class, weighting,
#: input type and NMAX from 8 up to the largest column the library sends
#: a mode of the class to that path
REGISTER_KERNEL = "register_kernel"
CLASSES = ("window", "winsorized", "sigmedian", "linearfit", "gesdt")
CLASS_MODES = ((0, 1, 2, 3), (5,), (4,), (6,), (7,))
NMAXES = (8, 16, 24, 32, 48, 64)


def register_instantiations() -> int:
    """The register-path instantiations the library's dispatch
    (``siril_reject_stack_register_path``) asks for: an NMAX is built
    where some frame count above the NMAX before it takes the path."""
    from siril_tpu_torch.kernels import reject_stack as k1

    on_path = k1._library().siril_reject_stack_register_path
    return 2 * sum(
        sum(1 for lo, m in zip((0,) + NMAXES, NMAXES)
            if any(on_path(lo + 1, r, w) for r in modes))
        for modes in CLASS_MODES for w in (0, 1))


def _kernel_label(mangled: str) -> str:
    """register_kernel<float, NMAX, weighted, class> or
    column_kernel<float, global> from a mangled name."""
    import re

    m = re.search(rf"({REGISTER_KERNEL}|column_kernel)I([fs])"
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
    if registers != register_instantiations():
        raise RuntimeError(f"ptxas reported {registers} register-path "
                           f"instantiations, not "
                           f"{register_instantiations()}")
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
    with low outliers, so the N−r≤4 guard truncates the high side.  Past
    2^30 values it is made in column chunks (a multiple of 8 pixels each),
    which bounds the temporaries."""
    import torch

    if n * p > (1 << 30):
        out = torch.empty(n, p, device=device)
        step = max(8, (1 << 27) // n // 8 * 8)
        for c0 in range(0, p, step):
            c1 = min(p, c0 + step)
            out[:, c0:c1] = make_stack(gen, n, c1 - c0, device)
        return out

    base = 0.05 + 0.6 * torch.rand(p, generator=gen, device=device)
    x = base + 0.01 * torch.randn(n, p, generator=gen, device=device)
    u = torch.rand(n, p, generator=gen, device=device)
    x = torch.where(u < 0.02, 0.95, x)
    x = torch.where((u >= 0.02) & (u < 0.03), 0.002, x)
    guard = (torch.arange(p, device=device) % 8) == 0
    tail = torch.zeros(n, p, device=device)
    k = min(6, n)
    tail[-k:] = 0.3 + 0.4 * torch.rand(k, p, generator=gen, device=device)
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

    # winsorized at 64 frames: the column kernel
    n64 = 64
    st64 = make_stack(gen, n64, p, dev)
    c64 = 1.0 + 0.02 * torch.randn(n64, generator=gen, device=dev)
    work64 = {}
    r64 = compare_k1(f"winsorized/f32/addscale N={n64} P={p} (column "
                     "kernel)", st64, c64, c64 * 0.1 - 0.1,
                     torch.ones_like(c64), rj.WINSORIZED, ADDITIVE_SCALING,
                     3.0, 3.0, work=work64)
    log_steps(f"N={n64}", work64, p)
    if not r64["ok"]:
        failures.append(f"winsorized N={n64}")
    del st64

    # winsorized at the masters' frame count (the script's bias, flat and
    # dark stacks), on a generator of its own so that the data above stay
    # as they were; then at the masters' call size: 16-bit frames, one
    # block of SIZE² pixels, -nonorm (bias, dark) and -norm=mul (flat)
    g8 = torch.Generator(device=dev)
    g8.manual_seed(seed + 8)
    n8 = CALIB_FRAMES
    st8 = make_stack(g8, n8, p, dev)
    raw8 = (torch.round(st8 * 65535.0) - 32768.0).to(torch.int16)
    sc8 = 1.0 + 0.05 * torch.randn(n8, generator=g8, device=dev)
    off8 = 0.01 * torch.randn(n8, generator=g8, device=dev)
    mul8 = 1.0 + 0.03 * torch.randn(n8, generator=g8, device=dev)
    for dname, data in (("f32", st8), ("i16", raw8)):
        for nname, mode in norms:
            r = compare_k1(f"winsorized/{dname}/{nname} N={n8} P={p}", data,
                           sc8, off8, mul8, rj.WINSORIZED, mode, 3.0, 3.0)
            if not r["ok"]:
                failures.append(f"winsorized/{dname}/{nname} N={n8}")
    del st8, raw8
    pm = SIZE * SIZE
    rawm = (torch.round(make_stack(g8, n8, pm, dev) * 65535.0)
            - 32768.0).to(torch.int16)
    for nname, mode in (("nonorm", NO_NORM), ("mul", MULTIPLICATIVE)):
        r = compare_k1(f"winsorized/i16/{nname} N={n8} P={pm} (the "
                       "masters' call size)", rawm, sc8, off8, mul8,
                       rj.WINSORIZED, mode, 3.0, 3.0)
        if not r["ok"]:
            failures.append(f"masters' call winsorized/i16/{nname}")
    del rawm

    # the stacks' calls at full size, each held against the plain version
    # on 2^20 pixels spread over P (each pixel's result depends on its own
    # column only): the OSC stack's, once a colour layer (16-bit lights);
    # the Bayer-drizzle stack's (float32 drizzled lights with holes); the
    # -upscale stack's (4 16-bit frames of (2·SIZE)²)
    others = []
    for label, n_, p_, dtype, seed_ in K1A_CALLS:
        r = k1a_call(label, n_, p_, dtype, seed + seed_)
        others.append(r)
        if not r["ok"]:
            failures.append(label)
    if failures:
        raise RuntimeError(f"K1a out of tolerance: {failures}")
    full["other_sizes"] = others
    return full


#: K1a at the stacks' full call sizes (label, N, P, dtype, seed offset):
#: winsorized, addscale, one block of P pixels
K1A_CALLS = [
    ("the OSC stack's call, one a colour layer", OSC_LIGHTS, SIZE * SIZE,
     "i16", 16),
    ("the Bayer-drizzle stack's call, one a colour layer", OSC_LIGHTS,
     SIZE * SIZE, "f32", 17),
    ("the -upscale stack's call", 4, 4 * SIZE * SIZE, "i16", 18),
]


def k1a_call(label: str, n: int, p: int, dtype: str, seed: int) -> dict:
    """K1a winsorized/addscale at a stack command's call, on data of its
    own generator (``held_at_call``).  A float32 stack gets a zero (a
    drizzle hole) on one value in 8."""
    import torch

    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = make_stack(g, n, p, dev)
    if dtype == "i16":
        x = (torch.round(x * 65535.0) - 32768.0).to(torch.int16)
    else:
        x = torch.where(torch.rand(n, p, generator=g, device=dev) < 0.125,
                        0.0, x)
    sc = 1.0 + 0.02 * torch.randn(n, generator=g, device=dev)
    r = held_at_call(label, "winsorized/addscale", x, sc, sc * 0.1 - 0.1,
                     torch.ones_like(sc),
                     dict(rtype=rj.WINSORIZED, mode=ADDITIVE_SCALING,
                          siglow=3.0, sighigh=3.0))
    del x
    torch.cuda.empty_cache()
    return r


def held_at_call(label: str, what: str, x, sc, off, mul, kw: dict) -> dict:
    """K1 (``what``: its rejection and normalization) on the (N, P) stack
    ``x`` with the keywords ``kw`` of a call (``weights`` (N, P) or
    (N, 1) among them for K1e): the kernel over all P pixels (CUDA
    events, median of 10), the plain version on 2^20 pixels in
    COLUMN_CHUNKS runs spread over P (each pixel's result depends on its
    own column only), bit-equal; the bound from the plain version's work
    scaled to P."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.stacking import reject_stack_plain

    n, p = x.shape
    dtype = "i16" if x.dtype == torch.int16 else "f32"
    got = k1.reject_mean(x, sc, off, mul, **kw)
    ms = _events_ms(lambda: k1.reject_mean(x, sc, off, mul, **kw), 10)
    idx = spread_slice(p, 1 << 20, COLUMN_CHUNKS, x.device)
    w = kw.get("weights")
    pkw = dict(kw)
    if w is not None and w.shape[1] == p:
        pkw["weights"] = w[:, idx].contiguous()
    work, refs = {}, []
    plain = _events_ms(lambda: refs.append(reject_stack_plain(
        x[:, idx].contiguous(), sc, off, mul,
        work=None if refs else work, **pkw)), 1)
    ref = refs[0]
    nbad = int(((got[1][idx] != ref[1]) | (got[2][idx] != ref[2])).sum())
    err = float((got[0][idx] - ref[0]).abs().max())
    scaled = {key: work.get(key, 0) * p / idx.numel()
              for key in ("flops", "compares")}
    # the stack once, 3 coefficient vectors, 12 B per pixel out, and the
    # weights once
    nbytes = n * p * x.element_size() + 3 * n * 4 + p * 12 + (
        0 if w is None else w.numel() * w.element_size())
    r = dict(label=label, n=n, p=p, dtype=dtype, slice=int(idx.numel()),
             ms=ms, plain_ms=plain, max_abs_err=err,
             **_bound(nbytes, scaled))
    wtxt = ""
    if w is not None:
        # the weights that are 0, over the call and in the compared slice
        r.update(weights="per pixel" if w.shape[1] == p else "per frame",
                 zero_weights=int((w == 0).sum()),
                 zero_weights_compared=int((pkw["weights"] == 0).sum()))
        wtxt = (f", weights {r['weights']} ({r['zero_weights']} of them 0, "
                f"{r['zero_weights_compared']} compared)")
    r["ok"] = nbad == 0 and err == 0.0 and bool(torch.isfinite(got[0]).all())
    log(f"  {what} {dtype} N={n} P={p}{wtxt} ({label}): kernel {ms:.3f} "
        f"ms; on {idx.numel()} pixels in {COLUMN_CHUNKS} runs over P count "
        f"mismatches {nbad}, max|Δmean| {err:.3g}, plain {plain:.1f} ms; "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel = "
        f"{ms / r['bound_ms']:.1f}x the bound")
    del got
    return r


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
    # K1b, K1c and K1d at register-path column sizes NMAX = 8, 16, 32, on
    # data of their own generator; K1d over every normalization and with
    # per-frame and per-pixel weights (K1e over GESDT)
    gen_n = torch.Generator(device=dev)
    gen_n.manual_seed(seed + 2)
    for nn in (8, 16, 32):
        st = make_stack(gen_n, nn, p, dev)
        sraw = (torch.round(st * 65535.0) - 32768.0).to(torch.int16)
        cs, co, cm = coeffs(nn, gen_n)
        for var, label, rtype, sl, sh, _ in STACK_VARIANTS[:3]:
            for dname, data in (("f32", st), ("i16", sraw)):
                for nname, mode in (norms if var == "K1d" else norms[1:2]):
                    tag = f"{var} {label}/{dname}/{nname} N={nn} P={p}"
                    record(var, tag, compare_k1(
                        tag, data, cs, co, cm, rtype, mode, sl, sh,
                        **gesdt_kw(rtype, nn, sl, sh)))
        for wname, w in (("frame", 0.5 + torch.rand(nn, 1, generator=gen_n,
                                                    device=dev)),
                         ("pixel", 0.5 + torch.rand(nn, p, generator=gen_n,
                                                    device=dev))):
            for dname, data in (("f32", st), ("i16", sraw)):
                tag = (f"K1e gesdt/{dname}/addscale weights per {wname} "
                       f"N={nn} P={p}")
                record("K1e", tag, compare_k1(
                    tag, data, cs, co, cm, rj.GESDT, ADDITIVE_SCALING, 0.3,
                    0.05, weights=w, **gesdt_kw(rj.GESDT, nn, 0.3, 0.05)))
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
    # winsorized, float32, additive+scaling, 4 frames with per-pixel
    # weights in (0, 1] over a tile's SIZE² pixels (the mosaic phase
    # holds K1e at the canvas's blocks, on the inputs of the call); on a
    # generator of its own
    g4 = torch.Generator(device=dev)
    g4.manual_seed(seed + 4)
    st4 = make_stack(g4, 4, SIZE * SIZE, dev)
    w4 = 0.01 + 0.99 * torch.rand(4, SIZE * SIZE, generator=g4, device=dev)
    tag = (f"K1e winsorized/f32/addscale weights per pixel N=4 "
           f"P={SIZE * SIZE} (a tile's size)")
    record("K1e", tag, compare_k1(tag, st4, *coeffs(4, g4), rj.WINSORIZED,
                                  ADDITIVE_SCALING, 3.0, 3.0, weights=w4))
    del st4, w4

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


#: the comparisons past 32 frames: frames, pixels, GESDT's outlier
#: fraction (at 1000 frames cut, so that its plain version's walk of one
#: row-order sum a row a step stays short) and the one mode to run, or
#: None for every mode (with weights and int16); the last is SIGMEDIAN's
#: check of the earlier slices at 1000 frames
COLUMN_FRAMES = [(33, 1 << 20, 0.3, None), (48, 1 << 16, 0.3, None),
                 (64, 1 << 16, 0.3, None), (100, 1 << 15, 0.3, None),
                 (300, 1 << 13, 0.3, None), (1000, 1 << 11, 0.02, None),
                 (1000, 1 << 14, 0.02, "sigmedian")]
#: the column kernel's timing sizes: the 100-frame stack command's call
#: (winsorized and GESDT, as the stack phase runs it), then winsorized at
#: 128, 300 and 1000 frames; each held against the plain version on
#: COLUMN_SLICE pixels in COLUMN_CHUNKS runs spread over P, the last
#: ending at P, so that tiles that blocks take after their first are
#: compared too
COLUMN_TIMING = [(STACK100, SIZE100 * SIZE100, "winsorized"),
                 (STACK100, SIZE100 * SIZE100, "gesdt"),
                 (128, SIZE * SIZE, "winsorized"),
                 (300, SIZE * SIZE, "winsorized"),
                 (1000, 1 << 20, "winsorized")]
COLUMN_SLICE = 1 << 14
COLUMN_CHUNKS = 16


def spread_slice(p: int, m: int, chunks: int, device):
    """Indices of ``m`` pixels of ``p`` in ``chunks`` runs of consecutive
    pixels, evenly spaced, the first at 0 and the last ending at ``p``."""
    import torch

    if m >= p:
        return torch.arange(p, device=device)
    run = m // chunks
    starts = torch.linspace(0, p - run, chunks, device=device).long()
    return (starts[:, None] + torch.arange(run, device=device)).reshape(-1)


def phase_k1col(seed: int):
    """K1 past 32 frames against its plain version: the register path up
    to 64 frames, the column kernel (K1col) past it; returns one result
    per timing size of the column kernel (COLUMN_TIMING), each with the
    worst error over all the phase's comparisons."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        MULTIPLICATIVE,
    )
    from siril_tpu_torch.ops.stacking import reject_stack_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    lib = k1._library()
    modes = [("none", rj.NO_REJEC, 3.0, 3.0),
             ("percentile", rj.PERCENTILE, 0.2, 0.1),
             ("sigma", rj.SIGMA, 3.0, 3.0), ("mad", rj.MAD, 3.0, 3.0),
             ("winsorized", rj.WINSORIZED, 3.0, 3.0),
             ("sigmedian", rj.SIGMEDIAN, 3.0, 3.0),
             ("linearfit", rj.LINEARFIT, 3.0, 3.0),
             ("gesdt", rj.GESDT, None, 0.05)]
    worst, failures = 0.0, []

    def layout(n, weighted):
        return "global scratch" if lib.siril_reject_stack_needs_scratch(
            n, rj.WINSORIZED, int(weighted)) else "shared memory"

    def gesdt_kw(rtype, n, frac, sh):
        if rtype != rj.GESDT:
            return {}
        mo = rj.gesdt_max_outliers(n, frac)
        return dict(max_outliers=mo,
                    critical=rj.gesdt_critical_values(n, sh, mo))

    for n, p, frac, only in COLUMN_FRAMES:
        st = make_stack(gen, n, p, dev)
        raw = (torch.round(st * 65535.0) - 32768.0).to(torch.int16)
        sc = 1.0 + 0.05 * torch.randn(n, generator=gen, device=dev)
        off = 0.01 * torch.randn(n, generator=gen, device=dev)
        mu = 1.0 + 0.03 * torch.randn(n, generator=gen, device=dev)
        wf = 0.5 + torch.rand(n, 1, generator=gen, device=dev)
        wp = 0.5 + torch.rand(n, p, generator=gen, device=dev)
        runs = [(label, rtype, sl, sh, "f32", st, ADDITIVE_SCALING, None)
                for label, rtype, sl, sh in modes]
        runs += [("winsorized", rj.WINSORIZED, 3.0, 3.0, "f32", st,
                  ADDITIVE_SCALING, ("frame", wf)),
                 ("gesdt", rj.GESDT, None, 0.05, "f32", st,
                  ADDITIVE_SCALING, ("pixel", wp)),
                 ("winsorized", rj.WINSORIZED, 3.0, 3.0, "i16", raw,
                  MULTIPLICATIVE, None),
                 ("sigmedian", rj.SIGMEDIAN, 3.0, 3.0, "i16", raw,
                  ADDITIVE_SCALING, None),
                 ("linearfit", rj.LINEARFIT, 3.0, 3.0, "i16", raw,
                  ADDITIVE_SCALING, None)]
        if only is not None:
            runs = [r for r in runs[:len(modes)] if r[0] == only]
        for label, rtype, sl, sh, dname, data, mode, wt in runs:
            sl = frac if sl is None else sl
            extra = gesdt_kw(rtype, n, frac, sh)
            wname = "" if wt is None else f" weights per {wt[0]}"
            if wt is not None:
                extra["weights"] = wt[1]
            var = k1.variant(rtype, wt is not None, n)
            where = (layout(n, wt is not None) if var == "K1col"
                     else "registers")
            tag = (f"{var} {label}/{dname}/mode{mode}{wname} N={n} P={p} "
                   f"({where})")
            r = compare_k1(tag, data, sc, off, mu, rtype, mode, sl, sh,
                           **extra)
            worst = max(worst, r["max_abs_err"])
            if not r["ok"]:
                failures.append(tag)
        del st, raw, wp

    # the timing sizes: the kernel over all P pixels, the plain version
    # over a slice spread across them
    results = []
    for n, p, label in COLUMN_TIMING:
        rtype, sl, sh = {m[0]: m[1:] for m in modes}[label]
        sl = 0.3 if sl is None else sl
        st = make_stack(gen, n, p, dev)
        sc = 1.0 + 0.02 * torch.randn(n, generator=gen, device=dev)
        off, one = sc * 0.1 - 0.1, torch.ones_like(sc)
        kw = dict(rtype=rtype, mode=ADDITIVE_SCALING, siglow=sl, sighigh=sh,
                  **gesdt_kw(rtype, n, sl, sh))
        k1.reject_mean(st, sc, off, one, **kw)
        ms = _events_ms(lambda: k1.reject_mean(st, sc, off, one, **kw), 3)
        got = k1.reject_mean(st, sc, off, one, **kw)
        idx = spread_slice(p, COLUMN_SLICE, COLUMN_CHUNKS, dev)
        m = idx.numel()
        part = st[:, idx].contiguous()
        work, refs = {}, []
        plain_ms = _events_ms(lambda: refs.append(reject_stack_plain(
            part, sc, off, one, work=None if refs else work, **kw)), 1)
        ref = refs[0]
        nbad = int(((got[1][idx] != ref[1]) | (got[2][idx] != ref[2])).sum())
        err = float((got[0][idx] - ref[0]).abs().max())
        ok = nbad == 0 and err == 0.0 and bool(torch.isfinite(got[0]).all())
        worst = max(worst, err)
        scaled = {key: work.get(key, 0) * p / m
                  for key in ("flops", "compares")}
        # the stack once, 3 coefficient vectors, 12 B per pixel out; GESDT
        # its λ table
        nbytes = n * p * 4 + 3 * n * 4 + p * 12 + 4 * len(
            kw.get("critical", ()))
        r = dict(ok=ok, ms=ms, plain_ms=plain_ms, n=n, p=p, label=label,
                 slice=m, **_bound(nbytes, scaled))
        log(f"  K1col {label}/f32/addscale N={n} P={p} "
            f"({layout(n, False)}): kernel {ms:.3f} ms; on {m} pixels in "
            f"{COLUMN_CHUNKS} runs over P count mismatches {nbad}, "
            f"max|Δmean| {err:.3g}, rej {int(got[1].sum())}/"
            f"{int(got[2].sum())}, plain {plain_ms:.1f} ms; bound: "
            f"{r['bytes'] / 1e6:.1f} MB → {r['bytes_ms']:.4f} ms, "
            f"{r['ops'] / 1e9:.2f} G operations (the slice's, scaled) → "
            f"{r['ops_ms']:.4f} ms; kernel = {ms / r['bound_ms']:.1f}x the "
            f"bound ({r['bound_by']})"
            + ("" if ok else "  <-- DIFFERS FROM THE PLAIN VERSION"))
        log_steps(f"N={n} (slice)", work, m)
        if not ok:
            failures.append(f"K1col timing {label} N={n}")
        results.append(r)
        del st, got, part
    if failures:
        raise RuntimeError(f"K1col out of tolerance: {failures}")
    for r in results:
        r["max_abs_err"] = worst
    return results


def _star_field(rng, size: int, nstars: int):
    """Positions and amplitudes of ``nstars`` Gaussian stars."""
    m = min(40, size // 8)
    sx = rng.uniform(m, size - m, nstars)
    sy = rng.uniform(m, size - m, nstars)
    amp = 0.5 * rng.pareto(1.5, nstars) * 0.02 + 0.02
    return sx, sy, __import__("numpy").minimum(amp, 0.55)


def _render(size: int, sky: float, cx, cy, amp, psf_s: float = 1.3):
    """The sky plus the stars centred at (cx, cy) (pixel i covers
    [i, i+1)), each rendered on a 13×13 patch."""
    import numpy as np

    img = np.full((size, size), sky, np.float32)
    r = 6
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    px = np.floor(cx).astype(np.int64)[:, None, None] + ox[None]
    py = np.floor(cy).astype(np.int64)[:, None, None] + oy[None]
    d2 = (px + 0.5 - cx[:, None, None]) ** 2 + \
        (py + 0.5 - cy[:, None, None]) ** 2
    val = amp[:, None, None] * np.exp(-d2 / (2 * psf_s ** 2))
    inb = (px >= 0) & (px < size) & (py >= 0) & (py < size)
    np.add.at(img, (py[inb], px[inb]), val[inb].astype(np.float32))
    return img


def synth_frames(seed: int, n: int, size: int, aligned: bool = False):
    """A scene of Gaussian stars on a sky background, and ``n`` frames of
    it shifted by integer + sub-pixel offsets, with noise and cosmic rays.
    Returns (scene, frames u16 list, shifts, noise σ, ray value).  With
    ``aligned`` the frames are not shifted (as registration leaves them)
    and are float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sky, sigma_n, ray = 0.1, 0.01, 1.0
    sx, sy, amp = _star_field(rng, size, 4000)

    def render(dx, dy):
        return _render(size, sky, sx + dx, sy + dy, amp)

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


def _ray_tracks(rng, f, n: int, value: float):
    """``n`` straight tracks of 3-5 pixels at ``value`` in frame ``f``;
    returns their pixels (ys, xs)."""
    import numpy as np

    size = f.shape[0]
    steps = np.array([(0, 1), (1, 0), (1, 1), (1, -1)])
    y0 = rng.integers(5, size - 5, n)
    x0 = rng.integers(5, size - 5, n)
    d = steps[rng.integers(0, 4, n)]
    length = rng.integers(3, 6, n)
    ys, xs = [], []
    for i in range(5):
        on = i < length
        ys.append(y0[on] + i * d[on, 0])
        xs.append(x0[on] + i * d[on, 1])
        f[ys[-1], xs[-1]] = value
    return np.concatenate(ys), np.concatenate(xs)


def synth_session(root: str, seed: int, size: int, lights: int,
                  calib: int, nstars: int, gain: float = 1.0,
                  shifted_dir: str = "") -> dict:
    """A night's raw 16-bit frames for the preprocessing script, written
    under ``root``: ``calib`` biases (a level with a column pattern),
    flats (bias + a vignetting field) and darks (bias + dark current with
    hot pixels), and ``lights`` lights of the scene of ``synth_frames``
    seen through the vignetting, each with bias, dark current, noise and
    a cosmic-ray track of 3-5 pixels per 40,000 pixels (a single-pixel hit
    fits as a star brighter than any, and the triangle match takes the
    brightest; a track per 4,000 pixels, as ``synth_frames`` has hits,
    would fill the 2000 candidates register fits at 4096²).  Frame 0 is
    the reference; the others are shifted by up
    to ±12.5 px, turned by up to 0.2° and scaled by up to 0.1 % about the
    centre.  With ``shifted_dir``, a second set of as many lights, only
    shifted, goes there (for fusedstack, which registers by shifts).
    ``gain`` brightens the stars (a small field has few bright ones).
    Returns what the result should show:
    the scene as calibration leaves it (× the flat's mean), the noise,
    the ray value, the hot pixels and, for each set, the reference
    frame's ray pixels (where the result is in its geometry)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sky, sigma_n, ray, read_n = 0.1, 0.01, 1.0, 0.002
    sx, sy, amp = _star_field(rng, size, nstars)
    amp = np.minimum(amp * gain, 0.55)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2.0
    vig = 1.0 - 0.3 * ((xx + 0.5 - c) ** 2 + (yy + 0.5 - c) ** 2) / \
        (2 * c * c)
    bias = (0.03 + 0.001 * np.sin(xx * (2 * np.pi / 64))).astype(np.float32)
    dark = np.full((size, size), 0.005, np.float32)
    nhot = max(size * size // 50000, 8)
    hy, hx = rng.integers(2, size - 2, nhot), rng.integers(2, size - 2, nhot)
    dark[hy, hx] = rng.uniform(0.1, 0.4, nhot)

    def noise(s):
        return s * rng.standard_normal((size, size), dtype=np.float32)

    def put(sub, name, f):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        write_later(write_float_u16, os.path.join(root, sub, name), f)

    for i in range(calib):
        put("biases", f"bias_{i + 1:05d}.fit", bias + noise(read_n))
        put("flats", f"flat_{i + 1:05d}.fit",
            bias + 0.5 * vig + noise(read_n))
        put("darks", f"dark_{i + 1:05d}.fit", bias + dark + noise(read_n))
    transforms, rays = [], {}
    for sub, rotate in (("lights", True), (shifted_dir, False)):
        for k in range(lights if sub else 0):
            th = s = dx = dy = 0.0
            if k:
                dx, dy = (float(rng.integers(-12, 13)
                                + rng.uniform(-0.5, 0.5)) for _ in range(2))
                if rotate:
                    th = float(np.deg2rad(rng.uniform(-0.2, 0.2)))
                    s = float(rng.uniform(-1e-3, 1e-3))
            if rotate:
                transforms.append((th, 1.0 + s, dx, dy))
            ct, st = (1.0 + s) * np.cos(th), (1.0 + s) * np.sin(th)
            cx = ct * (sx - c) - st * (sy - c) + c + dx
            cy = st * (sx - c) + ct * (sy - c) + c + dy
            f = bias + dark + vig * _render(size, sky, cx, cy, amp) + \
                noise(sigma_n)
            hit = _ray_tracks(rng, f, max(size * size // 40000, 4), ray)
            if k == 0:
                rays[sub] = hit
            put(sub, f"light_{k + 1:05d}.fit", f)
    scene = _render(size, sky, sx, sy, amp) * np.float32(vig.mean())
    writes_done()
    return dict(scene=scene, sigma_n=sigma_n, ray=ray, hot=(hy, hx),
                transforms=transforms, rays=rays, bias=bias, dark=dark,
                sx=sx, sy=sy, amp=amp)


#: the OSC night's per-site response of the flat panel (R, G, B): a
#: coloured flat, which -equalize_cfa takes out of the master flat
OSC_PANEL = (0.8, 1.0, 0.6)
#: the OSC night's sky level in R, G, B
OSC_SKY = (0.10, 0.12, 0.08)
#: the OSC night's star σ, px: a colour sensor samples red and blue on
#: every other pixel, so a star of the mono nights' 1.3 px is demosaiced
#: into a blocky, non-round red or blue profile
OSC_PSF = 2.0


def _render_cfa(sky_cfa, cx, cy, amp_rgb):
    """An RGGB mosaic of stars of σ OSC_PSF on ``sky_cfa`` (the sky's
    mosaic): each pixel takes the star amplitudes of its site's colour
    (site (y % 2) + (x % 2): 0 R, 1 G, 2 B)."""
    import numpy as np

    size = sky_cfa.shape[0]
    img = sky_cfa.copy()
    r = 6
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    px = np.floor(cx).astype(np.int64)[:, None, None] + ox[None]
    py = np.floor(cy).astype(np.int64)[:, None, None] + oy[None]
    d2 = (px + 0.5 - cx[:, None, None]) ** 2 + \
        (py + 0.5 - cy[:, None, None]) ** 2
    a = np.take_along_axis(amp_rgb[:, None, None, :],
                           ((py % 2) + (px % 2))[..., None], axis=3)[..., 0]
    val = a * np.exp(-d2 / (2 * OSC_PSF ** 2))
    inb = (px >= 0) & (px < size) & (py >= 0) & (py < size)
    np.add.at(img, (py[inb], px[inb]), val[inb].astype(np.float32))
    return img


def synth_osc(root: str, seed: int, size: int, lights: int, flats: int,
              nstars: int, bias, dark, gain: float = 1.0) -> dict:
    """A one-shot-colour night beside a mono night's raw biases and darks
    (a colour sensor's bias and dark have no colour, so ``bias`` and
    ``dark`` are that night's): ``flats`` flats (bias + the vignetting
    through the panel's colour OSC_PANEL) under ``osc_flats/`` and
    ``lights`` 16-bit RGGB lights under ``osc_lights/`` of a field of
    ``nstars`` stars, each with its own colour (R/G and B/G drawn in
    [0.5, 1.5]), on the coloured sky OSC_SKY, seen through the same
    vignetting, with bias, dark current and noise as ``synth_session``'s
    and a ray track of 3-5 px per 4,000,000 px (4 at 4096²: the
    demosaic spreads a track into a round blob on every layer, brighter
    than any star, and register's triangle match takes the brightest
    detections; with the mono night's one per 40,000 px every light's
    brightest detections were tracks and no match held); frame 0 is the
    reference, the others shifted by up to ±12.5 px.  Returns the scene per colour as calibration leaves
    it ((3, size, size), × the flat's mean), the star positions and
    colours, the noise, the reference frame's rays, each
    light's shift and the reference frame's mosaic without noise,
    vignetting or calibration frames ("clean")."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sigma_n, ray, read_n = 0.01, 1.0, 0.002
    sx, sy, amp = _star_field(rng, size, nstars)
    amp = np.minimum(amp * gain, 0.45)
    colour = np.stack([rng.uniform(0.5, 1.5, nstars), np.ones(nstars),
                       rng.uniform(0.5, 1.5, nstars)], axis=1)
    amp_rgb = (amp[:, None] * colour).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2.0
    vig = 1.0 - 0.3 * ((xx + 0.5 - c) ** 2 + (yy + 0.5 - c) ** 2) / \
        (2 * c * c)
    site = ((yy.astype(np.int64) % 2) + (xx.astype(np.int64) % 2))
    panel = np.asarray(OSC_PANEL, np.float32)[site]
    sky_cfa = np.asarray(OSC_SKY, np.float32)[site]
    del yy, xx, site

    def noise(s):
        return s * rng.standard_normal((size, size), dtype=np.float32)

    def put(sub, name, f):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        write_later(write_float_u16, os.path.join(root, sub, name), f,
                    bayer="RGGB")

    for i in range(flats):
        put("osc_flats", f"flat_{i + 1:05d}.fit",
            bias + 0.5 * vig * panel + noise(read_n))
    del panel
    rays, shifts = None, []
    for k in range(lights):
        dx = dy = 0.0
        if k:
            dx, dy = (float(rng.integers(-12, 13) + rng.uniform(-0.5, 0.5))
                      for _ in range(2))
        shifts.append((dx, dy))
        f = bias + dark + vig * _render_cfa(sky_cfa, sx + dx, sy + dy,
                                            amp_rgb) + noise(sigma_n)
        hit = _ray_tracks(rng, f, max(size * size // 4_000_000, 4), ray)
        if k == 0:
            rays = hit
        put("osc_lights", f"light_{k + 1:05d}.fit", f)
    scene = np.stack([_render(size, OSC_SKY[ch], sx, sy, amp_rgb[:, ch],
                              OSC_PSF) for ch in range(3)]) * \
        np.float32(vig.mean())
    writes_done()
    return dict(scene=scene, sx=sx, sy=sy, amp=amp_rgb, sigma_n=sigma_n,
                rays=rays, shifts=shifts,
                clean=_render_cfa(sky_cfa, sx, sy, amp_rgb))


#: the synthesized frames' files are written on WRITERS threads while the
#: next frame renders (numpy's conversions and the file writes release
#: the GIL), at most WRITES_IN_FLIGHT frames waiting; the data are the
#: same as when written in turn
WRITERS = 4
WRITES_IN_FLIGHT = 6
_WRITES: list = []
_WRITER_POOL: list = []


def write_later(fn, *args, **kw) -> None:
    """``fn(*args, **kw)`` on a writer thread; its arrays must not change
    after the call.  ``writes_done`` waits for it."""
    import concurrent.futures as cf

    if not _WRITER_POOL:
        _WRITER_POOL.append(cf.ThreadPoolExecutor(max_workers=WRITERS))
    while len(_WRITES) >= WRITES_IN_FLIGHT:
        _WRITES.pop(0).result()
    _WRITES.append(_WRITER_POOL[0].submit(fn, *args, **kw))


def writes_done() -> None:
    """Wait for every ``write_later`` (raising the first failure)."""
    while _WRITES:
        _WRITES.pop(0).result()


def write_float_u16(path: str, f, **kw) -> None:
    """``write_u16_fits`` of a float frame, clipped to [0, 1] and rounded
    to 16 bits."""
    import numpy as np

    write_u16_fits(path, np.rint(np.clip(f, 0, 1) * 65535.0).astype(
        np.uint16), **kw)


def write_u16_fits(path: str, u16, bayer: str = "", extra=()) -> None:
    """Minimal 16-bit FITS (BZERO 32768, bottom-up rows); ``bayer`` adds
    a BAYERPAT card (a one-shot-colour camera's raw frame), ``extra`` more
    header cards (80-column strings)."""
    import numpy as np

    h, w = u16.shape
    cards = ["SIMPLE  =                    T", "BITPIX  =                   16",
             "NAXIS   =                    2",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}",
             "BZERO   =              32768.0", "BSCALE  =                  1.0",
             "EXPTIME =                 60.0"]
    if bayer:
        cards.append(f"BAYERPAT= '{bayer}'")
    cards += list(extra) + ["END"]
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


def similar_map(scale, deg, dx, dy, g1=0.0, g2=0.0, size=(SIZE, SIZE)):
    """Frame → reference homography of an (H, W) ``size`` frame: scale
    and turn by ``deg`` about the centre, shift by (dx, dy), third row
    (g1, g2)."""
    import numpy as np

    c = np.array([(size[1] - 1) / 2.0, (size[0] - 1) / 2.0])
    th = np.deg2rad(deg)
    A = scale * np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
    Hm = np.eye(3)
    Hm[:2, :2] = A
    Hm[:2, 2] = c - A @ c + [dx, dy]
    Hm[2, :2] = [g1, g2]
    return Hm


#: the ladder's families for the warps phase: the rung each must take
#: and its frames' maps (scale, degrees, dx, dy, g1, g2), the reference
#: first and a frame turned by ~180° (a meridian flip) last; third-row
#: terms of ~1e-6 /px give the perspective split D = 8 at 4096²
WARP_FAMILIES = [
    ("rotation", [(1, 0, 0, 0), (1, 0.5, 3.3, -2.7), (1, -0.5, -5.1, 4.2),
                  (1, 179.6, 2.2, 1.4)]),
    ("affine", [(1, 0, 0, 0), (1.01, 0.3, 3.3, -2.7),
                (0.99, -0.2, -5.1, 4.2), (1.005, 179.6, 2.2, 1.4)]),
    ("perspective", [(1, 0, 0, 0), (1.002, 0.3, 3.3, -2.7, 1e-6, -0.8e-6),
                     (0.998, -0.2, -5.1, 4.2, -0.9e-6, 1e-6),
                     (1.001, 179.6, 2.2, 1.4, 0.7e-6, 0.6e-6)]),
]
#: each rung against the gather warp (lanczos4 with its clamp) on the
#: interior where both are non-zero: the most mean |Δ| on the warps
#: phase's frames (noise σ 0.01), held at a small size on the CPU by
#: tests/test_torch_interp.py and at SIZE² on the card; the rungs
#: interpolate with exact sinc, the gather warp with lanczos4
WARP_GATHER_BOUND = 2e-3


def warp_family_frames(seed: int, size: int, maps, nstars: int):
    """Frames rendered at the maps' star positions (the scene seen through
    each frame→reference map, inverted), float32 with noise σ 0.01, as
    an (N, 1, size, size) array, and the maps as homographies."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sx, sy, amp = _star_field(rng, size, nstars)
    Hs = np.stack([similar_map(*m, size=(size, size)) for m in maps])
    frames = np.empty((len(maps), 1, size, size), np.float32)
    for k, Hm in enumerate(Hs):
        v = np.linalg.inv(Hm) @ np.stack([sx, sy, np.ones_like(sx)])
        frames[k, 0] = _render(size, 0.1, v[0] / v[2], v[1] / v[2], amp)
        frames[k, 0] += 0.01 * rng.standard_normal((size, size),
                                                   dtype=np.float32)
    return frames, Hs


def rung_vs_gather(frames, Hs, rung: str, margin: int):
    """The rung ``pick_rung`` chooses for ``Hs`` and its output, the
    gather warp's, and the mean |Δ| between them on the interior where
    both are non-zero (tensors on the frames' device)."""
    import torch

    from siril_tpu_torch.ops import interp
    from siril_tpu_torch.pipeline import pick_rung

    size = tuple(frames.shape[-2:])
    name, params = pick_rung(Hs, size, interp.INTERP_LANCZOS4)
    warp = {"rotation": interp.warp_rotation_batch,
            "affine": interp.warp_affine_batch,
            "perspective": interp.warp_perspective_batch}.get(name)
    out = warp(frames, params) if warp else None
    ref = interp.warp_homography_batch(frames, Hs, size)
    if out is None:
        return name, params, None, ref, float("nan")
    inner = torch.zeros(size, dtype=torch.bool, device=frames.device)
    inner[margin:-margin, margin:-margin] = True
    both = (out != 0) & (ref != 0) & inner
    err = float((out - ref).abs()[both].mean())
    return name, params, out, ref, err


def phase_warps(seed: int):
    """Each rung of the FFT warp ladder at SIZE² on the card: the gate
    picks it, it runs, it agrees with the gather warp within
    WARP_GATHER_BOUND, and its time per frame beside the gather warp's;
    its peak device memory beyond the frames within what the fused path
    reserves for the ladder.  Returns {rung: numbers}."""
    import torch

    from siril_tpu_torch.ops import interp
    from siril_tpu_torch.pipeline import BLOCK_BYTES, FusedArgs

    dev = torch.device("cuda")
    results, failed = {}, []
    for i, (family, maps) in enumerate(WARP_FAMILIES):
        t = time.perf_counter()
        host, Hs = warp_family_frames(seed + 20 + i, SIZE, maps, 4000)
        frames = torch.from_numpy(host).to(dev)
        del host
        log(f"  {family}: synthesized {len(maps)} frames of {SIZE}x{SIZE} "
            f"in {time.perf_counter() - t:.2f}s")
        name, params, out, ref, err = rung_vs_gather(frames, Hs, family, 64)
        del out, ref
        n = frames.shape[0]
        fn = {"rotation": interp.warp_rotation_batch,
              "affine": interp.warp_affine_batch,
              "perspective": interp.warp_perspective_batch}[family]
        peak = float("nan")
        if name == family:
            # the rung's own peak beyond the frames (its output included)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(frames, params)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        ms = _events_ms(lambda: fn(frames, params), 3) / n \
            if name == family else float("nan")
        gather_ms = _events_ms(lambda: interp.warp_homography_batch(
            frames, Hs, (SIZE, SIZE)), 1) / n
        # what the fused path reserves beside the stack: a frame chunk in
        # and out of the warp, the stream block, the ladder's transients
        reserve = 3 * FusedArgs().frame_chunk * SIZE * SIZE * 4 + \
            interp.ladder_transient_bytes(1, SIZE, SIZE)
        extra = f", D = {params[4]}" if family == "perspective" and \
            name == family else ""
        flips = int(params[3 if name == "rotation" else 2].sum()) \
            if name == family else 0
        log(f"  {family}: rung {name}{extra}, flipped frames {flips}; "
            f"{ms:.2f} ms a frame (gather warp {gather_ms:.2f} ms, "
            f"{gather_ms / ms:.1f}x); interior mean |Δ| against the gather "
            f"warp {err:.3g} (bound {WARP_GATHER_BOUND}); peak device "
            f"memory beyond the {n} frames {peak / 2**20:.0f} MiB (the fused "
            f"path reserves {reserve / 2**20:.0f} MiB with its "
            f"{BLOCK_BYTES >> 20} MiB stream block)")
        checks = {f"the gates pick {family}": name == family,
                  "within the bound of the gather warp":
                      err <= WARP_GATHER_BOUND,
                  "one flipped frame": flips == 1,
                  "peak within the fused path's reserve": peak <= reserve}
        for k, ok in checks.items():
            if not ok:
                log(f"  check {family}: {k}: FAILED")
                failed.append(f"{family}: {k}")
        results[family] = dict(rung=name, ms=ms, gather_ms=gather_ms,
                               err=err, peak_mib=peak / 2**20,
                               **({"D": params[4]} if extra else {}))
        del frames
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"warps checks failed: {failed}")
    return results


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
            write_later(write_u16_fits,
                        os.path.join(tmp, f"light_{i + 1:05d}.fit"), u)
        writes_done()
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


def synth_turned(root: str, seed: int, size: int, n: int, nstars: int = 4000,
                 gain: float = 1.0):
    """A night of field rotation with a meridian flip, for fusedstack
    -transf=homography: ``n`` 16-bit lights of the scene of
    ``synth_frames`` turned by up to ±0.5° about the centre, the second
    half by a further 180°, shifted by up to ±12.5 px, each with noise σ
    0.01 and a cosmic-ray track of 3-5 pixels per 400,000 pixels, written
    under ``root`` (the fused path's detection fits its 500 brightest
    candidates, which the script phase's track per 40,000 pixels fills at
    4096²).  Frame 1 is the reference.  Returns (scene, noise σ,
    ray value, the reference frame's ray pixels, the frames' maps)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sky, sigma_n, ray = 0.1, 0.01, 1.0
    sx, sy, amp = _star_field(rng, size, nstars)
    amp = np.minimum(amp * gain, 0.55)
    maps, rays = [], None
    for k in range(n):
        deg = dx = dy = 0.0
        if k:
            deg = float(rng.uniform(-0.5, 0.5)) + (180.0 if k >= n // 2
                                                   else 0.0)
            dx, dy = (float(rng.integers(-12, 13) + rng.uniform(-0.5, 0.5))
                      for _ in range(2))
        Hm = similar_map(1.0, deg, dx, dy, size=(size, size))
        maps.append(Hm)
        v = np.linalg.inv(Hm) @ np.stack([sx, sy, np.ones_like(sx)])
        f = _render(size, sky, v[0] / v[2], v[1] / v[2], amp)
        f += sigma_n * rng.standard_normal((size, size), dtype=np.float32)
        hit = _ray_tracks(rng, f, max(size * size // 400000, 4), ray)
        if k == 0:
            rays = hit
        write_later(write_float_u16,
                    os.path.join(root, f"light_{k + 1:05d}.fit"), f)
    scene = _render(size, sky, sx, sy, amp)
    writes_done()
    return scene, sigma_n, ray, rays, np.stack(maps)


def spy_rungs(calls: dict):
    """Wrap the port's warp functions so that each call of a rung counts
    in ``calls``; returns a function that puts them back."""
    from siril_tpu_torch.ops import interp

    names = {"translation": "warp_translation_batch",
             "rotation": "warp_rotation_batch",
             "affine": "warp_affine_batch",
             "perspective": "warp_perspective_batch",
             "gather": "warp_homography_batch"}
    real = {k: getattr(interp, v) for k, v in names.items()}

    def wrap(key):
        def run(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return real[key](*a, **kw)
        return run

    for k, v in names.items():
        setattr(interp, v, wrap(k))

    def restore():
        for k, v in names.items():
            setattr(interp, v, real[k])

    return restore


def phase_fusedstack_homography(seed: int):
    """fusedstack -transf=homography through the CLI on FRAMES turned
    16-bit SIZE² lights (field rotation, a meridian flip): checked as the
    fusedstack phase, and the ladder's rung taken, not the gather warp.
    Returns (K1a launches, stages, wall, rung)."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.kernels import reject_stack as k1

    tmp = tempfile.mkdtemp(prefix="chip_smoke_turned_")
    try:
        t = time.perf_counter()
        scene, sigma_n, ray, (ry, rx), maps = synth_turned(
            tmp, seed + 31, SIZE, FRAMES)
        log(f"  synthesized and wrote {FRAMES} turned 16-bit lights of "
            f"{SIZE}x{SIZE} (frames {FRAMES // 2 + 1}-{FRAMES} flipped) in "
            f"{time.perf_counter() - t:.2f}s")
        rungs = {}
        restore = spy_rungs(rungs)
        try:
            k1.reset_counts()
            t = time.perf_counter()
            session = cli.run(["-d", tmp, "fusedstack", "light_",
                               "-transf=homography"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = sum(k1.launches.values())
        finally:
            restore()
        res = session.result
        for stage, s in res.stage_s.items():
            log(f"  stage {stage:<10} {s:8.3f} s")
        rung = ",".join(sorted(rungs))
        reg = session.sequence.reg(0)
        c = np.array([[0, 0, 1], [SIZE - 1, 0, 1], [0, SIZE - 1, 1],
                      [SIZE - 1, SIZE - 1, 1.0]])
        qa = np.einsum("nij,cj->nci", reg.H, c)
        qb = np.einsum("nij,cj->nci", maps, c)
        corner = float(np.abs(qa[..., :2] / qa[..., 2:]
                              - qb[..., :2] / qb[..., 2:]).max())
        log(f"  fusedstack -transf=homography wall {wall:.2f}s, K1a "
            f"launches {launches}, warp rung {rung} ({rungs}); fitted H "
            f"within {corner:.3f} px of the truth at the corners")
        out = res.image.host()[0]
        rows = (256 << 20) // (FRAMES * SIZE * 4)
        want_blocks = -(-SIZE // rows)
        m = 48
        inner = np.s_[m:-m, m:-m]
        err = float(np.abs(out[inner] - scene[inner]).mean())
        # the reference frame's rays on the sky of the interior (near the
        # edges the turned and flipped frames leave a column too few
        # values to reject from)
        bgv = float(np.median(scene))
        sky = (np.abs(scene[ry, rx] - bgv) < 1e-3) & (ry >= m) & \
            (ry < SIZE - m) & (rx >= m) & (rx < SIZE - m)
        ray_err = float(np.abs(out[ry, rx] - scene[ry, rx])[sky].max())
        rl, rh = res.total_rejected
        checks = {
            "all frames registered": int(reg.valid.sum()) == FRAMES,
            f"K1a launches == {want_blocks} row blocks":
                launches == want_blocks,
            "interior mean |Δ| < noise/3": err < sigma_n / 3,
            "cosmic rays rejected (rej_high > 0, |Δ| < 0.02 at the "
            "reference frame's rays)": rh > 0 and ray_err < 0.02,
            "no loop stopped at its bound": res.capped == 0,
            "a rung of the ladder warped, not the gather warp":
                bool(rungs) and "gather" not in rungs
                and "translation" not in rungs,
            "result finite, expected shape":
                bool(np.isfinite(out).all()) and out.shape == (SIZE, SIZE),
            "result file written":
                os.path.exists(os.path.join(tmp, "light_fused.fit")),
        }
        log(f"  interior mean |Δ| vs scene {err:.5f} (noise {sigma_n}), "
            f"rejected low/high {rl}/{rh}, the reference frame's ray pixels "
            f"on the interior's sky {int(sky.sum())}, max |Δ| there "
            f"{ray_err:.5f}, "
            f"max {float(out.max()):.4f}")
        for name, good in checks.items():
            log(f"  check {name}: {'ok' if good else 'FAILED'}")
        if not all(checks.values()):
            raise RuntimeError("fusedstack -transf=homography checks failed")
        return launches, res.stage_s, wall, rung
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: calibration frames of each kind in the script phase (a user shoots
#: 20-50; PERF.md §4 states the cut)
CALIB_FRAMES = 8
#: the script phase's lights (a night has tens to hundreds; cut from 24 to
#: 12 to make room for the drizzle and formats phases, PERF.md §4)
SCRIPT_LIGHTS = 12


def _log_rows(session, rows):
    for e in session.command_log:
        if e["seconds"] < 1e-3 and not e["launches"]:
            continue
        rows[e["command"]] = dict(seconds=e["seconds"],
                                  launches=e["launches"], stages=e["stages"])
        log(f"  {e['command']}: {e['seconds']:.3f}s, K1 launches "
            f"{e['launches'] or 0}")
        if e["stages"]:
            log("    stages: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in e["stages"].items()))


def _scene_checks(name, out, made, rays, session_result, launches, extra):
    """The result against the known scene, its hot pixels and the
    reference frame's ray pixels ``rays`` (a ray of one frame in 24 left
    in would add 0.04 there); returns the failed checks.  The star peaks
    are logged as a ratio to the scene: the staged stack normalizes the
    warped frames, whose noise the interpolation lowered, so it scales
    their stars up."""
    import numpy as np

    scene, sigma_n = made["scene"], made["sigma_n"]
    m = 48
    inner = np.s_[m:-m, m:-m]
    err = float(np.abs(out[inner] - scene[inner]).mean())
    bgv = float(np.median(scene[inner]))

    def on_sky(ys, xs):
        keep = np.abs(scene[ys, xs] - bgv) < 1e-3
        return ys[keep], xs[keep]

    hy, hx = on_sky(*made["hot"])
    ry, rx = on_sky(*rays)
    hot_err = float(np.abs(out[hy, hx] - scene[hy, hx]).max())
    ray_err = float(np.abs(out[ry, rx] - scene[ry, rx]).max())
    peaks = np.argsort(scene[inner], axis=None)[-50:]
    ratio = float(np.median((out[inner].ravel()[peaks] - bgv)
                            / (scene[inner].ravel()[peaks] - bgv)))
    rl, rh = session_result.total_rejected
    log(f"  {name}: interior mean |Δ| vs scene {err:.5f} (noise "
        f"{sigma_n}), rejected low/high {rl}/{rh}, interior max "
        f"{float(out[inner].max()):.4f} (scene "
        f"{float(scene[inner].max()):.4f}; the 50 brightest star pixels "
        f"at {ratio:.3f} × the scene's height above the sky), hot pixels "
        f"on the sky {len(hy)} of {len(made['hot'][0])}, max |Δ| there "
        f"{hot_err:.5f}; the reference frame's ray pixels on the sky "
        f"{len(ry)}, max |Δ| there {ray_err:.5f}")
    checks = {
        "interior mean |Δ| < noise/3": err < sigma_n / 3,
        "no hot pixel of the dark left (|Δ| < 0.02 on the sky)":
            hot_err < 0.02,
        "cosmic rays rejected (rej_high > 0, |Δ| < 0.02 at the "
        "reference frame's rays)": rh > 0 and ray_err < 0.02,
        "result finite, expected shape":
            bool(np.isfinite(out).all()) and out.shape == scene.shape,
        "no loop stopped at its bound": session_result.capped == 0,
        "K1 launched": sum(launches.values()) > 0,
        **extra}
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        log(f"  check {name}: {k}: FAILED")
    return failed, err


def phase_script(seed: int, osc_root: str, tmp: str):
    """The standard preprocessing script through the port's -s entry on a
    synthetic night at full width in ``tmp``, then fusedstack with the
    same masters.  The night's raw biases and darks then move to
    ``osc_root`` for the osc phase; its raw lights and its calibrated,
    registered ``pp_light`` stay in ``tmp`` for the drizzle and formats
    phases.  Returns ({path: {variant: launches}}, {command: row}, walls,
    the night's bias, dark, hot pixels, scene and noise)."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.kernels import reject_stack as k1

    lights = SCRIPT_LIGHTS
    t = time.perf_counter()
    made = synth_session(tmp, seed + 11, SIZE, lights, CALIB_FRAMES,
                         4000, shifted_dir="fused")
    log(f"  synthesized {CALIB_FRAMES} biases, flats, darks and 2 × "
        f"{lights} lights of {SIZE}x{SIZE} (16-bit) in "
        f"{time.perf_counter() - t:.2f}s")
    script = os.path.join(tmp, "preprocessing.ssf")
    with open(script, "w") as f:
        f.write(PREPROCESSING_SCRIPT.format(stack_flags=""))
    k1.reset_counts()
    t = time.perf_counter()
    session = cli.run(["-d", tmp, "-s", script])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(k1.launches)
    rows = {}
    _log_rows(session, rows)
    proc = os.path.join(tmp, "process")
    res = session.result
    out = read_fits(os.path.join(proc, "result.fit")).host()[0]
    r_pp = sorted(f for f in os.listdir(proc)
                  if f.startswith("r_pp_light_") and f.endswith(".fit"))
    bits = read_fits(os.path.join(proc, r_pp[0])).orig_bitdepth
    pp = read_fits(os.path.join(proc, "pp_light_00001.fit")).host()[0]
    hy, hx = made["hot"]
    on_sky = np.abs(made["scene"][hy, hx] - float(np.median(
        made["scene"]))) < 1e-3
    pp_hot = float(np.abs(pp[hy, hx] - made["scene"][hy, hx])[
        on_sky].max())
    m = 48
    y, x = np.unravel_index(int(np.argmax(out[m:-m, m:-m])),
                            (out.shape[0] - 2 * m, out.shape[1] - 2 * m))
    y, x = y + m, x + m
    vals = [float(read_fits(os.path.join(proc, f)).host()[0][y, x])
            for f in r_pp]
    log(f"  interior maximum {float(out[y, x]):.4f} at (y={y}, x={x}), "
        f"scene {float(made['scene'][y, x]):.4f}; the registered frames "
        f"there: {', '.join(f'{v:.3f}' for v in vals)}")
    stacks = [c for c in rows if c.startswith("stack ")]
    log(f"  script wall {wall:.2f}s; r_pp_ frames {len(r_pp)} at "
        f"bitpix {bits}; reference frame's hot pixels on the sky after "
        f"calibration max |Δ| {pp_hot:.5f}")
    failed, err = _scene_checks(
        "script", out, made, made["rays"]["lights"], res, launches, {
        f"all {lights} frames registered": len(r_pp) == lights,
        "every stack command launched K1":
            all(sum(rows[c]["launches"].values()) > 0 for c in stacks),
        "calibrated reference frame: no hot pixel (|Δ| < 5σ)":
            pp_hot < 5 * made["sigma_n"],
        "result file written": os.path.exists(
            os.path.join(proc, "result.fit"))})
    # the registered lights again: the best 90 % by FWHM, and a sum
    k1.reset_counts()
    t = time.perf_counter()
    filt = cli.run(["-d", proc, "stack", "r_pp_light", "rej", "3", "3",
                    "-norm=addscale", "-filter-fwhm=90%",
                    "-out=filtered"])
    torch.cuda.synchronize()
    filt_wall = time.perf_counter() - t
    filt_launch = dict(k1.launches)
    kept = filt.result.image.keywords.stackcnt
    log(f"  stack r_pp_light rej 3 3 -norm=addscale -filter-fwhm=90%: "
        f"wall {filt_wall:.2f}s, frames kept {kept} of {lights}, K1 "
        f"launches { {k: v for k, v in filt_launch.items() if v} }")
    log("    stages: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in filt.result.stage_s.items()))
    failed += _scene_checks(
        "filtered stack", filt.result.image.host()[0], made,
        made["rays"]["lights"], filt.result, filt_launch, {
            f"{round(0.9 * lights)} frames kept":
                kept == round(0.9 * lights)})[0]
    t = time.perf_counter()
    summed = cli.run(["-d", proc, "stack", "r_pp_light", "sum",
                      "-out=summed"])
    torch.cuda.synchronize()
    sum_wall = time.perf_counter() - t
    sout = summed.result.image.host()[0][m:-m, m:-m]
    scene = made["scene"][m:-m, m:-m]
    # on the stars (≥ 0.02 above the sky): the sky holds the noise and
    # the rays the sum keeps
    on = scene - float(np.median(scene)) >= 0.02
    corr = float(np.corrcoef(sout[on], scene[on])[0, 1])
    log(f"  stack r_pp_light sum: wall {sum_wall:.2f}s, max "
        f"{float(sout.max()):.4f}, correlation with the scene on its "
        f"{int(on.sum())} star pixels of the interior {corr:.4f}")
    log("    stages: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in summed.result.stage_s.items()))
    for name, good in {
            "sum finite": bool(np.isfinite(sout).all()),
            "sum peaks at 1":
                float(summed.result.image.host().max()) == 1.0,
            "sum's stars in place (correlation with the scene > 0.95)":
                corr > 0.95}.items():
        if not good:
            log(f"  check sum: {name}: FAILED")
            failed.append(f"sum: {name}")
    rows["stack r_pp_light rej 3 3 -norm=addscale -filter-fwhm=90%"] = \
        dict(seconds=filt_wall, launches=filt_launch,
             stages=filt.result.stage_s)
    rows["stack r_pp_light sum"] = dict(seconds=sum_wall, launches={},
                                        stages=summed.result.stage_s)
    # the same masters through fusedstack's calibration flags, on the
    # shift-only lights (fusedstack registers by shifts); the masters,
    # the registered pp_light and the result stay
    for f in os.listdir(proc):
        if not (f.endswith("_stacked.fit") or f.startswith("pp_light_")
                or f == "result.fit"):
            os.unlink(os.path.join(proc, f))
    k1.reset_counts()
    t = time.perf_counter()
    fused = cli.run(["-d", os.path.join(tmp, "fused"), "fusedstack",
                     "light_", "-bias=../process/bias_stacked",
                     "-dark=../process/pp_dark_stacked",
                     "-flat=../process/pp_flat_stacked", "-cc=dark"])
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t
    flaunch = dict(k1.launches)
    for stage, sec in fused.result.stage_s.items():
        log(f"  fusedstack stage {stage:<10} {sec:8.3f} s")
    log(f"  calibrated fusedstack wall {fwall:.2f}s, K1 launches "
        f"{ {k: v for k, v in flaunch.items() if v} }")
    fout = fused.result.image.host()[0]
    ffailed, ferr = _scene_checks(
        "calibrated fusedstack", fout, made, made["rays"]["fused"],
        fused.result, flaunch, {
            "all frames registered":
                int(fused.sequence.reg(0).valid.sum()) == lights,
            "result max well below the ray value":
                float(fout.max()) < 0.8 * made["ray"]})
    if failed or ffailed:
        raise RuntimeError(f"script checks failed: {failed + ffailed}")
    for sub in ("biases", "darks"):
        shutil.move(os.path.join(tmp, sub), os.path.join(osc_root, sub))
    shutil.rmtree(os.path.join(tmp, "fused"))
    return ({"script": launches, "fusedstack calibrated": flaunch,
             "stack -filter-fwhm=90%": filt_launch},
            rows, dict(script=wall, fused=fwall, script_err=err,
                       fused_err=ferr,
                       fused_stages=fused.result.stage_s),
            {k: made[k] for k in ("bias", "dark", "hot", "scene",
                                  "sigma_n", "transforms", "sx", "sy",
                                  "amp")})


#: the osc phase compares every demosaic method (X-Trans with a standard
#: 6×6 pattern on the same pixels) cuda against cpu on a crop of a light
DEMOSAIC_CROP = 1024
#: the flux ratio tolerances, on the median over bright isolated stars of
#: measured R/G (B/G) over a reference ratio: against the same demosaic
#: of the reference frame's mosaic without noise or calibration, within
#: 3 % (noise, the flat and the stack are all that differ); against the
#: stars' true colours, within 10 % (measured on noiseless 1024² mosaics
#: of σ 2 px stars: RCD, the reference's re-derivation, reads R/G and B/G
#: 5.2 % low, bilinear 0.5-0.8 %).  Without -equalize_cfa the flat's
#: colour would move the ratios by 20-40 %.
OSC_RATIO_TOL = 0.03
OSC_TRUE_RATIO_TOL = 0.10


def _star_fluxes(img, xs, ys):
    """Per star, per layer: the sum over a 13² box (3 σ of OSC_PSF) of
    ``img`` (C, H, W) minus the median of the box's edge, × the box's
    pixel count."""
    import numpy as np

    half = 6
    out = np.empty((len(xs), img.shape[0]))
    for i, (x, y) in enumerate(zip(xs, ys)):
        box = img[:, y - half:y + half + 1, x - half:x + half + 1]
        edge = np.concatenate([box[:, 0], box[:, -1], box[:, 1:-1, 0],
                               box[:, 1:-1, -1]], axis=1)
        out[i] = box.sum(axis=(1, 2)) - np.median(edge, axis=1) * box[0].size
    return out


def _bright_isolated(made, size: int):
    """Indices of the 60 brightest stars (green amplitude) at least 64 px
    inside the frame with no other star within 14 px (beyond the flux
    box)."""
    import numpy as np
    from scipy.spatial import cKDTree

    sx, sy = made["sx"], made["sy"]
    pts = np.stack([sx, sy], axis=1)
    d, _ = cKDTree(pts).query(pts, k=2)
    ok = (d[:, 1] > 14.0) & (sx > 64) & (sx < size - 64) & (sy > 64) & \
        (sy < size - 64)
    idx = np.nonzero(ok)[0]
    return idx[np.argsort(made["amp"][idx, 1])[::-1][:60]]


def _star_ratios(img, made, idx):
    """(len(idx), 2) R/G and B/G flux ratios of the stars ``idx``."""
    import numpy as np

    f = _star_fluxes(img, np.floor(made["sx"][idx]).astype(int),
                     np.floor(made["sy"][idx]).astype(int))
    return np.stack([f[:, 0] / f[:, 1], f[:, 2] / f[:, 1]], axis=1)


def _ratio_check(name, got, want, gains=(1.0, 1.0, 1.0)):
    """Median over the stars of measured R/G and B/G (``got``) over the
    reference ratios ``want`` × gains[c]/gains[1]; returns the two
    medians."""
    import numpy as np

    q = got / (want * np.array([gains[0], gains[2]]) / gains[1])
    meds = [float(np.median(q[:, k])) for k in (0, 1)]
    spread = [float(np.percentile(q[:, k], 84) - np.percentile(q[:, k], 16))
              for k in (0, 1)]
    log(f"  {name}: over {len(q)} bright isolated stars, R/G median "
        f"{meds[0]:.4f} (16-84 % spread {spread[0]:.4f}), B/G {meds[1]:.4f} "
        f"({spread[1]:.4f})")
    return meds


def phase_osc(seed: int, root: str, night: dict):
    """The one-shot-colour script through the port's -s entry at full
    width, on the script phase's biases and darks (in ``root``) and a
    rendered colour night; then every demosaic method on the card against
    the CPU on a crop of a light, and each timed on a full light.
    Returns ({variant: launches}, {command: row}, walls, {method: ms})."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import demosaic as dm
    from siril_tpu_torch.ops.xtrans import XTRANS_PATTERNS

    t = time.perf_counter()
    made = synth_osc(root, seed + 21, SIZE, OSC_LIGHTS, CALIB_FRAMES, 4000,
                     night["bias"], night["dark"])
    log(f"  synthesized {CALIB_FRAMES} flats and {OSC_LIGHTS} 16-bit RGGB "
        f"lights of {SIZE}x{SIZE} in {time.perf_counter() - t:.2f}s (the "
        f"biases and darks are the script phase's)")
    script = os.path.join(root, "osc.ssf")
    with open(script, "w") as f:
        f.write(OSC_SCRIPT)
    k1.reset_counts()
    t = time.perf_counter()
    session = cli.run(["-d", root, "-s", script])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(k1.launches)
    rows = {}
    _log_rows(session, rows)
    proc = os.path.join(root, "osc")
    out = read_fits(os.path.join(proc, "result.fit")).host()
    pp = read_fits(os.path.join(proc, "pp_light_00001.fit")).host()
    r_pp = sorted(f for f in os.listdir(proc)
                  if f.startswith("r_pp_light_") and f.endswith(".fit"))
    # registration on layer 0: each light's H against its true shift, at
    # the frame's corners
    from siril_tpu_torch.io.seqfile import read_seqfile

    reg = read_seqfile(os.path.join(proc, "pp_light_.seq")).reg(0)
    corners = np.array([[0, 0, 1], [SIZE, 0, 1], [0, SIZE, 1],
                        [SIZE, SIZE, 1.0]])
    reg_err = []
    for k, (dx, dy) in enumerate(made["shifts"]):
        q = corners @ reg.H[k].T
        reg_err.append(float(np.abs(q[:, :2] / q[:, 2:] - corners[:, :2]
                                    + np.array([dx, dy])).max()))
    log(f"  register: stars a frame {reg.number_of_stars.tolist()}; H "
        f"against the true shifts at the corners, px: "
        f"{', '.join(f'{e:.3f}' for e in reg_err)}")
    scene, sigma_n = made["scene"], made["sigma_n"]
    m = 48
    inner = np.s_[m:-m, m:-m]
    # per layer, the affine map of the scene onto the result
    fits, errs, sky_errs = [], [], []
    for c in range(3):
        s_, o_ = scene[c][inner].ravel(), out[c][inner].ravel()
        a, b = np.polyfit(s_, o_, 1)
        fits.append((a, b))
        d = np.abs(o_ - (a * s_ + b)) / a
        errs.append(float(d.mean()))
        sky_errs.append(float(d[np.abs(s_ - np.median(s_)) < 1e-3].mean()))
    # hot pixels of the dark on the sky, in scene units
    hy, hx = night["hot"]
    sky = np.abs(scene[1][hy, hx] - float(np.median(scene[1]))) < 1e-3
    hy, hx = hy[sky], hx[sky]
    hot_err = max((float(np.abs((out[c][hy, hx] - fits[c][1]) / fits[c][0]
                                - scene[c][hy, hx]).max())
                   for c in range(3)), default=np.inf)
    ry, rx = made["rays"]
    on = np.abs(scene[1][ry, rx] - float(np.median(scene[1]))) < 1e-3
    ry, rx = ry[on], rx[on]
    ray_err = max(float(np.abs((out[c][ry, rx] - fits[c][1]) / fits[c][0]
                               - scene[c][ry, rx]).max()) for c in range(3))
    pp_hot = float(np.abs(pp[:, hy, hx] - scene[:, hy, hx]).max(
        initial=np.inf if len(hy) == 0 else 0.0))
    # star colours: on the calibrated reference frame, and on the result
    # with the stack's -rgb_equal gains (the scale estimators of the
    # reference frame's layers; -output_norm is one map for all layers)
    idx = _bright_isolated(made, SIZE)
    true = made["amp"][idx][:, [0, 2]] / made["amp"][idx][:, 1:2]
    clean = _star_ratios(dm.debayer(torch.from_numpy(made["clean"]).cuda(),
                                    "RGGB").cpu().numpy(), made, idx)
    # each frame's layer c is scaled by sca[0, ref] / sca[c, k] (the
    # reference frame's layer 0 over its own scale estimator), so the
    # result's layer by their mean over the frames
    seq = session.sequence
    ref = seq.get_reference()
    sel = seq.selected_indices()
    gains = tuple(float(np.mean([seq.get_frame_stats(0, ref).scale
                                 / seq.get_frame_stats(c, int(k)).scale
                                 for k in sel])) for c in range(3))
    meds = {}
    for name, img, g in (("pp_light_00001 (calibrated, debayered)", pp,
                          (1.0, 1.0, 1.0)),
                         ("result (-rgb_equal gains " + ", ".join(
                             f"{v:.4f}" for v in gains) + ")", out, gains)):
        got = _star_ratios(img, made, idx)
        meds[name.split()[0]] = (
            _ratio_check(f"{name} against the clean mosaic's RCD", got,
                         clean, g),
            _ratio_check(f"{name} against the true colours", got, true, g))
    res = session.result
    lights_cmd = [c for c in rows if c.startswith("stack r_pp_light")][0]
    lights_launch = rows[lights_cmd]["launches"]
    log(f"  OSC script wall {wall:.2f}s; r_pp_ frames {len(r_pp)}; per layer "
        f"(R, G, B) interior mean |Δ| vs the scene after an affine fit "
        f"{', '.join(f'{e:.5f}' for e in errs)} (on the sky "
        f"{', '.join(f'{e:.5f}' for e in sky_errs)}; noise {sigma_n}); hot "
        f"pixels on the sky {len(hy)}, max |Δ| there {hot_err:.5f} (result) "
        f"{pp_hot:.5f} (pp_light_00001); the reference frame's {len(ry)} "
        f"ray pixels on the sky, max |Δ| {ray_err:.5f}; rejected low/high "
        f"{res.total_rejected[0]}/{res.total_rejected[1]}")
    checks = {
        "result: 3 layers of SIZE²": out.shape == (3, SIZE, SIZE),
        "result finite": bool(np.isfinite(out).all()),
        f"all {OSC_LIGHTS} lights registered": len(r_pp) == OSC_LIGHTS,
        "every H within 0.5 px of the true shift at the corners":
            max(reg_err) < 0.5,
        "interior mean |Δ| < noise/3 on every layer":
            max(errs) < sigma_n / 3,
        "no hot pixel of the dark left (|Δ| < 0.02)": hot_err < 0.02,
        "calibrated reference frame: no hot pixel (|Δ| < 5σ)":
            pp_hot < 5 * sigma_n,
        **{f"{what} flux ratios within {tol:.0%} of the {ref_}'s": max(
            abs(q - 1.0) for q in meds[what][k]) < tol
           for what in meds for k, ref_, tol in (
               (0, "clean mosaic's RCD", OSC_RATIO_TOL),
               (1, "true colours", OSC_TRUE_RATIO_TOL))},
        "cosmic rays rejected (rej_high > 0, |Δ| < 0.05 at the reference "
        "frame's rays)": res.total_rejected[1] > 0 and ray_err < 0.05,
        "no loop stopped at its bound": res.capped == 0,
        "K1a launched once a layer by the lights' stack, once by each "
        "master": lights_launch == {"K1a": 3} and launches.get("K1a") == 6}
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        log(f"  check osc: {k}: FAILED")

    # every demosaic method: cuda against cpu on a crop, then timed
    light = read_fits(os.path.join(root, "osc_lights", "light_00001.fit"))
    pat = light.keywords.bayer_pattern
    full = torch.from_numpy(light.host()[0]).cuda()
    crop = full[:DEMOSAIC_CROP, :DEMOSAIC_CROP]
    timings, worst = {}, 0.0

    def run(method, x):
        if method == "xtrans":
            return dm.debayer(x, XTRANS_PATTERNS[0])
        return dm.debayer(x, pat, dm.METHOD_NAMES[method])

    for method in dm.METHOD_NAMES:
        got = run(method, crop).cpu()
        want = run(method, crop.cpu())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        run(method, full)
        ms = _events_ms(lambda: run(method, full), 3)
        timings[method] = dict(ms=ms, cuda_vs_cpu=err)
        log(f"  debayer {method}: cuda vs cpu on a {DEMOSAIC_CROP}² crop max "
            f"|Δ| {err:.3g}; {ms:.3f} ms per {SIZE}² frame (CUDA events, "
            f"median of 3)")
        if not (err <= 1e-6 and bool(torch.isfinite(got).all())):
            failed.append(f"debayer {method} cuda vs cpu")
    if failed:
        raise RuntimeError(f"osc checks failed: {failed}")
    return launches, rows, dict(osc=wall, errs=errs), timings, made


#: the drizzle phase's tolerances, stated before its first run on the
#: card.  Bayer drizzle (scale 1, pixfrac 1) gives each output pixel of a
#: colour plane the samples of that colour its footprint overlaps: a
#: quarter of the input pixels for R and B, half for G.  Over N lights a
#: plane's sky then averages ~N·share samples, and the mean |Δ| of such a
#: mean is 0.8·σ/√(N·share); the tolerance is that with 25 % margin.
DRIZZLE_SHARE = (0.25, 0.5, 0.25)
DRIZZLE_MARGIN = 1.25
#: star colours after Bayer drizzle against the true ones: drizzle
#: interpolates nothing, so within 5 % (RCD reads R/G and B/G of σ 2 px
#: stars 5.2 % low, PERF.md §5)
DRIZZLE_TRUE_RATIO_TOL = 0.05
#: ``stack pp_light -drizzle -scale=2 -pixfrac=0.9`` binned 2×2 against
#: the mono scene: the interior's mean |Δ| below σ/2 (12 lights leave
#: 0.8σ/√12 = 0.23σ on the sky; the drop, 0.9 px, and the output pixel
#: blur the stars)
DRIZZLE2_TOL = 0.5
#: ``stack … -upscale`` binned 2×2 against the same 4 frames stacked
#: without it, on average over the interior: the binning undoes the
#: lanczos4 resample's geometry, but the resample smooths each frame's
#: noise (0.5σ left in a 4-frame mean) and the stars' peaks, so within
#: σ/4 (0.175σ measured at 512² on the CPU)
UPSCALE_TOL = 0.25
#: the card's drizzle against the CPU's on a DRIZZLE_CROP² crop: another
#: sin / exp and a division by a scalar through its reciprocal
DRIZZLE_CROP = 512
DRIZZLE_CPU_TOL = 2e-6


def _affine_errs(out, scene, m=48):
    """Per layer, the mean |Δ| of ``out`` against the least-squares affine
    map of ``scene`` on the interior, and on the interior's sky, in scene
    units; with each layer's (a, b)."""
    import numpy as np

    inner = np.s_[m:-m, m:-m]
    errs, sky_errs, fits = [], [], []
    for c in range(out.shape[0]):
        s_, o_ = scene[c][inner].ravel(), out[c][inner].ravel()
        a, b = np.polyfit(s_, o_, 1)
        fits.append((a, b))
        d = np.abs(o_ - (a * s_ + b)) / a
        errs.append(float(d.mean()))
        sky_errs.append(float(d[np.abs(s_ - np.median(s_)) < 1e-3].mean()))
    return errs, sky_errs, fits


def _timed_cli(rows, d, *words):
    """One CLI command in ``d``: its wall, K1 launches and stages into
    ``rows``; returns the session and its row."""
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.kernels import reject_stack as k1

    k1.reset_counts()
    t = time.perf_counter()
    session = cli.run(["-d", d, *words])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in k1.launches.items() if v}
    cmd = " ".join(words)
    rows[cmd] = dict(seconds=wall, launches=launches,
                     stages=dict(session.stages))
    log(f"  {cmd}: wall {wall:.3f}s, K1 launches {launches or 0}")
    if session.stages:
        log("    stages: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in session.stages.items()))
    return session, rows[cmd]


def _remove(d, prefix):
    for f in os.listdir(d):
        if f.startswith(prefix):
            os.unlink(os.path.join(d, f))


def phase_drizzle(seed: int, root: str, script_dir: str, night: dict,
                  osc: dict):
    """Drizzle at full width.  In the osc phase's directory, on its raw
    RGGB lights and masters: the Bayer-drizzle script through -s
    (OSC_DRIZZLE_SCRIPT), its result against the colour scene per layer,
    the star colours, the rays and H; then ``stack cfa_light -drizzle
    -scale=1.0`` (the chunked CFA path; its weight map).  On the script
    phase's calibrated, registered ``pp_light``: ``stack pp_light
    -drizzle -scale=2 -pixfrac=0.9`` onto a (2·SIZE)² grid, binned 2×2
    against the mono scene, and ``stack pp_light rej 3 3 -norm=addscale
    -upscale`` on 4 frames selected in the .seq.  Then drizzle's ms per
    frame (CUDA events) and peak device memory beyond the frames at scale
    1 (CFA) and 2 (mono), and each device stage on the card against the
    CPU on a DRIZZLE_CROP² crop.  Returns ({path: K1 launches},
    {command: row}, timings)."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import FitsReader, read_fits
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import drizzle as drz
    from siril_tpu_torch.ops.geometry import resample

    proc = os.path.join(root, "osc")
    # the OSC script's debayered sequences are checked: room on the disk
    _remove(proc, "r_pp_light_")
    _remove(proc, "pp_light_")
    rows, failed, timings = {}, [], {}
    script = os.path.join(root, "osc_drizzle.ssf")
    with open(script, "w") as f:
        f.write(OSC_DRIZZLE_SCRIPT)
    k1.reset_counts()
    t = time.perf_counter()
    session = cli.run(["-d", proc, "-s", script])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"Bayer-drizzle script": dict(k1.launches)}
    _log_rows(session, rows)
    out = read_fits(os.path.join(proc, "result_drizzle.fit")).host()
    r_cfa = sorted(f for f in os.listdir(proc)
                   if f.startswith("r_cfa_light_") and f.endswith(".fit"))
    first = read_fits(os.path.join(proc, r_cfa[0]))
    reg = read_seqfile(os.path.join(proc, "cfa_light_.seq")).reg(0)
    corners = np.array([[0, 0, 1], [SIZE, 0, 1], [0, SIZE, 1],
                        [SIZE, SIZE, 1.0]])
    reg_err = []
    for k, (dx, dy) in enumerate(osc["shifts"]):
        q = corners @ reg.H[k].T
        reg_err.append(float(np.abs(q[:, :2] / q[:, 2:] - corners[:, :2]
                                    + np.array([dx, dy])).max()))
    log(f"  register -drizzle on the raw mosaic: stars a frame "
        f"{reg.number_of_stars.tolist()}; H against the true shifts at the "
        f"corners, px: {', '.join(f'{e:.3f}' for e in reg_err)}")
    scene, sigma_n = osc["scene"], osc["sigma_n"]
    errs, sky_errs, fits = _affine_errs(out, scene)
    tols = [DRIZZLE_MARGIN * 0.8 * sigma_n / np.sqrt(OSC_LIGHTS * sh)
            for sh in DRIZZLE_SHARE]
    ry, rx = osc["rays"]
    on = np.abs(scene[1][ry, rx] - float(np.median(scene[1]))) < 1e-3
    ry, rx = ry[on], rx[on]
    ray_err = max(float(np.abs((out[c][ry, rx] - fits[c][1]) / fits[c][0]
                               - scene[c][ry, rx]).max()) for c in range(3))
    idx = _bright_isolated(osc, SIZE)
    true = osc["amp"][idx][:, [0, 2]] / osc["amp"][idx][:, 1:2]
    seq = session.sequence
    ref = seq.get_reference()
    sel = seq.selected_indices()
    gains = tuple(float(np.mean([seq.get_frame_stats(0, ref).scale
                                 / seq.get_frame_stats(c, int(k)).scale
                                 for k in sel])) for c in range(3))
    meds = _ratio_check("Bayer-drizzle result (-rgb_equal gains "
                        + ", ".join(f"{v:.4f}" for v in gains)
                        + ") against the true colours",
                        _star_ratios(out, osc, idx), true, gains)
    res = session.result
    log(f"  Bayer-drizzle script wall {wall:.2f}s; r_cfa_ frames "
        f"{len(r_cfa)} of {first.nchans} float32 layers; per layer (R, G, "
        f"B) interior mean |Δ| vs the scene after an affine fit "
        f"{', '.join(f'{e:.5f}' for e in errs)}, on the sky "
        f"{', '.join(f'{e:.5f}' for e in sky_errs)} (tolerance "
        f"{', '.join(f'{e:.5f}' for e in tols)}; noise {sigma_n}); the "
        f"reference frame's {len(ry)} ray pixels on the sky, max |Δ| "
        f"{ray_err:.5f}; rejected low/high {res.total_rejected[0]}/"
        f"{res.total_rejected[1]}")
    checks = {
        "result: 3 layers of SIZE², finite": out.shape == (3, SIZE, SIZE)
        and bool(np.isfinite(out).all()),
        f"all {OSC_LIGHTS} lights drizzled, 3 float32 layers each":
            len(r_cfa) == OSC_LIGHTS and first.nchans == 3
            and first.orig_bitdepth == -32,
        "every H within 0.5 px of the true shift at the corners":
            max(reg_err) < 0.5,
        "each layer's sky within 0.8σ/√(N·share) × 1.25 of the scene":
            all(e < t_ for e, t_ in zip(sky_errs, tols)),
        f"star colours within {DRIZZLE_TRUE_RATIO_TOL:.0%} of the true "
        "ones": max(abs(q - 1.0) for q in meds) < DRIZZLE_TRUE_RATIO_TOL,
        "cosmic rays rejected (rej_high > 0, |Δ| < 0.05 at the reference "
        "frame's rays)": res.total_rejected[1] > 0 and ray_err < 0.05,
        "no loop stopped at its bound": res.capped == 0,
        "K1a launched once a layer": launches["Bayer-drizzle script"] ==
            {**{k: 0 for k in k1.launches}, "K1a": 3}}
    _remove(proc, "r_cfa_light_")

    # the chunked CFA path: the weight map of every plane covers the
    # interior
    real, seen = drz.drizzle_sequence, []

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    drz.drizzle_sequence = spy
    try:
        s, _ = _timed_cli(rows, proc, "stack", "cfa_light", "-drizzle",
                          "-scale=1.0", "-out=drizzle_cfa")
    finally:
        drz.drizzle_sequence = real
    img, wmap = seen[0]
    m = 48
    w_in = wmap.host()[:, m:-m, m:-m]
    cerrs, csky, _ = _affine_errs(img.host(), scene)
    log(f"  stack cfa_light -drizzle: weight map on the interior min "
        f"{', '.join(f'{float(w.min()):.4f}' for w in w_in)} (R, G, B), "
        f"mean {', '.join(f'{float(w.mean()):.4f}' for w in w_in)}; "
        f"against the scene after an affine fit, on the sky "
        f"{', '.join(f'{e:.5f}' for e in csky)}")
    checks["stack -drizzle (CFA): weight above 0 on every interior pixel "
           "of each plane"] = bool((w_in > 0).all())
    checks["stack -drizzle (CFA): 3 finite layers of SIZE²"] = \
        s.image.data.shape == (3, SIZE, SIZE) and \
        bool(np.isfinite(img.host()).all())
    del img, wmap, w_in, seen

    # mono, scale 2, onto a (2·SIZE)² grid
    sproc = os.path.join(script_dir, "process")
    s, _ = _timed_cli(rows, sproc, "stack", "pp_light", "-drizzle",
                      "-scale=2", "-pixfrac=0.9", "-out=drizzle_x2")
    big = s.image.host()[0]
    binned = big.reshape(SIZE, 2, SIZE, 2).mean(axis=(1, 3))
    mscene, msig = night["scene"], night["sigma_n"]
    inner = np.s_[m:-m, m:-m]
    d2 = np.abs(binned[inner] - mscene[inner])
    sky2 = np.abs(mscene[inner] - float(np.median(mscene[inner]))) < 1e-3
    log(f"  stack pp_light -drizzle -scale=2 -pixfrac=0.9: {big.shape}, "
        f"binned 2×2 against the scene: interior mean |Δ| "
        f"{float(d2.mean()):.5f}, on the sky {float(d2[sky2].mean()):.5f} "
        f"(tolerance {DRIZZLE2_TOL * msig:.5f})")
    checks["stack -drizzle -scale=2: (2·SIZE)², finite"] = \
        big.shape == (2 * SIZE, 2 * SIZE) and bool(np.isfinite(big).all())
    checks["stack -drizzle -scale=2: binned interior within σ/2"] = \
        float(d2.mean()) < DRIZZLE2_TOL * msig
    del big, binned, d2, s

    # -upscale on 4 selected frames (the selection in the .seq)
    seqf = os.path.join(sproc, "pp_light_.seq")
    sq = read_seqfile(seqf)
    sq.incl[:] = False
    sq.incl[:4] = True
    sq.save()
    s, row = _timed_cli(rows, sproc, "stack", "pp_light", "rej", "3", "3",
                        "-norm=addscale", "-upscale", "-out=upscaled")
    up = s.image.host()[0]
    up_launch = row["launches"]
    launches["stack pp_light -upscale (4 frames)"] = up_launch
    s4, row = _timed_cli(rows, sproc, "stack", "pp_light", "rej", "3", "3",
                         "-norm=addscale", "-out=plain4")
    launches["stack pp_light (the same 4 frames)"] = row["launches"]
    plain4 = s4.image.host()[0]
    dup = np.abs(up.reshape(SIZE, 2, SIZE, 2).mean(axis=(1, 3))[inner]
                 - plain4[inner])
    log(f"  -upscale: {up.shape} from {s4.result.image.keywords.stackcnt} "
        f"frames, K1a launches {up_launch.get('K1a')}; binned 2×2 against "
        f"the same frames stacked without it: interior mean |Δ| "
        f"{float(dup.mean()):.6f} (tolerance {UPSCALE_TOL * msig:.5f}), "
        f"max {float(dup.max()):.5f}")
    checks["-upscale: (2·SIZE)², finite, 4 frames, K1a once"] = \
        up.shape == (2 * SIZE, 2 * SIZE) and \
        bool(np.isfinite(up).all()) and up_launch.get("K1a") == 1 and \
        s4.result.image.keywords.stackcnt == 4
    checks["-upscale: binned within σ/4 of the plain stack"] = \
        float(dup.mean()) < UPSCALE_TOL * msig
    del up, plain4, dup, s, s4
    _remove(sproc, "upscaled_pp_light_")

    # ms per frame (CUDA events) and peak device memory beyond the frames
    dev = torch.device(CARD)
    cfa_raw = torch.from_numpy(FitsReader(os.path.join(
        proc, "light_00002.fit")).raw_topdown("<i2")[None]).to(dev)
    mono_raw = torch.from_numpy(FitsReader(os.path.join(
        sproc, "pp_light_00002.fit")).raw_topdown("<i2")[None]).to(dev)
    Hm = read_seqfile(seqf).reg(0).H[1:2]
    for name, frames, shape, args, H, pat in (
            ("scale 1, CFA → 3 planes", cfa_raw, (3, SIZE, SIZE),
             drz.DrizzleArgs(scale=1.0, pixfrac=1.0, use_bayer=True),
             reg.H[1:2], "RGGB"),
            ("scale 2, pixfrac 0.9, mono", mono_raw,
             (1, 2 * SIZE, 2 * SIZE),
             drz.DrizzleArgs(scale=2.0, pixfrac=0.9), Hm, None)):
        acc = drz.DrizzleAccumulator(shape, args, dev)
        acc.add_frames(frames, H, pattern=pat)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = _events_ms(lambda: acc.add_frames(frames, H, pattern=pat), 3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        timings[name] = dict(ms=ms, peak_mib=peak)
        log(f"  drizzle {name}: {ms:.3f} ms a {SIZE}² frame (CUDA events, "
            f"median of 3), peak device memory beyond the frame and the "
            f"accumulator {peak:.0f} MiB")
        del acc
    # each device stage on the card against the CPU on a crop
    c = DRIZZLE_CROP
    for name, frames, args, H, pat in (
            ("drizzle scale 1 CFA", cfa_raw[..., :c, :c],
             drz.DrizzleArgs(scale=1.0, pixfrac=1.0, use_bayer=True),
             reg.H[1:2], "RGGB"),
            ("drizzle scale 2 mono", mono_raw[..., :c, :c],
             drz.DrizzleArgs(scale=2.0, pixfrac=0.9), Hm, None)):
        outs = []
        for d in (CARD, "cpu"):
            acc = drz.DrizzleAccumulator(
                (3 if pat else 1, int(c * args.scale), int(c * args.scale)),
                args, d)
            acc.add_frames(frames.to(d).contiguous(), H, pattern=pat)
            outs.append([x.host() for x in acc.finalize()])
        err = max(float(np.abs(a - b).max()) for a, b in zip(*outs))
        timings[name + " cuda vs cpu"] = err
        log(f"  {name}: cuda vs cpu on a {c}² crop, output and weight map "
            f"max |Δ| {err:.3g}")
        checks[f"{name}: cuda vs cpu within {DRIZZLE_CPU_TOL:g}"] = \
            err <= DRIZZLE_CPU_TOL
    crop = SirilImage(data=(mono_raw[0, :, :c, :c].float().cpu().numpy()
                            + 32768.0) / 65535.0)
    a, b = (resample(crop, 2 * c, 2 * c, device=d).host()
            for d in (CARD, "cpu"))
    err = float(np.abs(a - b).max())
    timings["upscale resample cuda vs cpu"] = err
    log(f"  -upscale's resample ×2: cuda vs cpu on a {c}² crop max |Δ| "
        f"{err:.3g}")
    checks[f"resample ×2: cuda vs cpu within {DRIZZLE_CPU_TOL:g}"] = \
        err <= DRIZZLE_CPU_TOL
    del cfa_raw, mono_raw
    torch.cuda.empty_cache()
    for k, ok in checks.items():
        if not ok:
            log(f"  check drizzle: {k}: FAILED")
            failed.append(k)
    if failed:
        raise RuntimeError(f"drizzle checks failed: {failed}")
    timings["script"] = wall
    return launches, rows, timings


#: the astrometry phase: the script night's field on the sky, a TAN
#: projection at 1.0″/px turned 0.3°, centred near M42 (the catalogue is
#: the rendered stars, their magnitudes from their amplitudes)
SKY_CENTRE = (83.82, -5.39)
SKY_SCALE = 1.0
SKY_TURN = 0.3
#: the focal length and pixel size that give SKY_SCALE (-focal=,
#: -pixelsize=, FOCALLEN, XPIXSZ)
FOCAL_MM = 800.0
PIXEL_UM = FOCAL_MM * SKY_SCALE / 206.265
#: the plate-solve hints: this far off the truth in RA and Dec (arcmin),
#: a mount's pointing error
HINT_OFF = (7.0, -6.0)
#: the -disto lights' known SIP distortion, in the FITS frame about the
#: centre (u, v = ±2048 px at the edges): second-order pairs without a
#: mean (u² − v², uv) and a third-order pair orthogonal to u over the
#: frame, so that the solver's linear fit is nearly unbiased; B[2, 0] and
#: B[0, 2] are not radial (ROADMAP §3).  A few px in the field (3.5 px
#: at its corners): the solver fits the linear terms first and the SIP
#: terms to what is left, and what it misses grows with the distortion
#: (scripts/disto_residual.py reads it at 0.4, 1 and 1.2 × these terms;
#: DISTO_TOL is set from those readings, PERF.md §6)
DISTO_SIP = {("A", 2, 0): 4.5e-7, ("A", 0, 2): -4.5e-7,
             ("A", 3, 0): 1.125e-10, ("A", 1, 2): -2.025e-10,
             ("B", 2, 0): 5.25e-7, ("B", 0, 2): -5.25e-7,
             ("B", 1, 1): 3.75e-7}
DISTO_LIGHTS = 4
#: register -3stars: the follow box (px); the picked stars at most
#: THREESTAR_REACH px from the centre (a turn of 0.2°, a 0.1 % scale and a
#: 12.5 px shift keep them 7 px inside the box), the brightest fit one in
#: each third of the frame around its centre; each H within THREESTAR_TOL
#: px of register's at the corners.  The follow's centroid (7×7,
#: flux-weighted, the noise clipped at zero) is good to 0.03-0.05 px rms
#: on stars of amplitude 0.3-0.55 over σ 0.01, and three such stars put
#: the corners 0.10-0.26 px off the true map (CPU, 4096², three fields;
#: PERF.md §6)
THREESTAR_BOX = 64
THREESTAR_REACH = 2700
THREESTAR_TOL = 0.35
#: the DISTO_STARS brightest isolated stars of the corrected frames (their
#: centroids good to ~0.02 px) within DISTO_TOL px of their undistorted
#: positions and DISTO_MEAN_TOL on average, and the 60 brightest isolated
#: ones at least DISTO_BEFORE px off somewhere before correction.  Read
#: by scripts/disto_residual.py on three fields at DISTO_SIP (one H100):
#: 0.447 / 0.211 / 0.259 px at most after, 0.133 / 0.088 / 0.099 on
#: average, 2.65 / 2.88 / 3.00 px before (at 0.4 × DISTO_SIP, 1.4 px:
#: 0.198 / 0.116 / 0.119 px after)
DISTO_STARS = 20
DISTO_TOL = 0.5
DISTO_MEAN_TOL = 0.2
DISTO_BEFORE = 2.5
#: the SIP warp's card-against-CPU crop, and its bound (the gather warp's,
#: tests/test_torch_cuda.py): everywhere without the clamp; with it, but
#: on at most SIP_CLAMP_FLIPS of the pixels, where a last-bit difference
#: in the lanczos sum turns the clamp's test out < 0.98·guide and its 3×3
#: dilation takes the bilinear guide (one such spot on a star field's
#: 1024² crop: 1.85e-3, measured on one H100); such a pixel must hold,
#: within the bound, the CPU's other value (its lanczos sum or guide)
SIP_CROP = 1024
SIP_CPU_TOL = 2e-6
SIP_CLAMP_FLIPS = 1e-4


def sky_wcs(size: int, centre=SKY_CENTRE):
    """The scene's TAN WCS (render coordinates: a star at x covers pixel
    floor(x), as the star finder reports it)."""
    import numpy as np

    from siril_tpu_torch.ops.wcs import WCS

    th = np.radians(SKY_TURN)
    s = SKY_SCALE / 3600.0
    return WCS(crpix=(size / 2.0 + 0.5, size / 2.0 + 0.5), crval=centre,
               cd=np.array([[-s * np.cos(th), s * np.sin(th)],
                            [s * np.sin(th), s * np.cos(th)]]),
               height=size)


def star_mags(amp):
    """Catalogue magnitudes of rendered amplitudes (0.55 → 10)."""
    import numpy as np

    return 10.0 - 2.5 * np.log10(np.asarray(amp) / 0.55)


def hint_cards(w, size: int, rng):
    """OBJCTRA / OBJCTDEC up to 7′ off the frame's centre under ``w`` in
    each, and the optics (FOCALLEN, XPIXSZ), as header cards."""
    import numpy as np

    from siril_tpu_torch.ops.wcs import format_dec, format_ra

    ra, dec = w.pix2world(np.array([size / 2.0]), np.array([size / 2.0]))
    off = rng.uniform(-7.0, 7.0, 2) / 60.0           # ≤ 9.9′ together
    return [f"OBJCTRA = '{format_ra(float(ra[0]) + off[0])}'",
            f"OBJCTDEC= '{format_dec(float(dec[0]) + off[1])}'",
            f"FOCALLEN= {FOCAL_MM:>20}", f"XPIXSZ  = {PIXEL_UM:>20}"]


def _isolated(sx, sy, amp, size: int, n: int = 60, margin: int = 64,
              near: float = 14.0):
    """Indices of the ``n`` brightest stars at least ``margin`` px inside
    the frame with no other star within ``near`` px."""
    import numpy as np
    from scipy.spatial import cKDTree

    pts = np.stack([sx, sy], axis=1)
    d, _ = cKDTree(pts).query(pts, k=2)
    ok = (d[:, 1] > near) & (sx > margin) & (sx < size - margin) & \
        (sy > margin) & (sy < size - margin)
    idx = np.nonzero(ok)[0]
    return idx[np.argsort(np.asarray(amp)[idx])[::-1][:n]]


def _centroids(img, xs, ys, r: int = 5, sigma: float = 1.3):
    """Windowed centroids (render coordinates) of the stars near (xs, ys)
    in ``img``: the flux above the (2r+1)² box's border median under a
    Gaussian window of the stars' σ, iterated x ← x + 2·Σwf·(X − x)/Σwf
    (unbiased for a round Gaussian star, and nearly as precise as a fit;
    a plain flux-weighted centroid with the noise clipped at zero is
    pulled towards its box's centre by ~0.1 px)."""
    import numpy as np

    out = np.zeros((len(xs), 2))
    for k, (x, y) in enumerate(zip(xs, ys)):
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        box = img[y0 - r:y0 + r + 1, x0 - r:x0 + r + 1].astype(np.float64)
        edge = np.concatenate([box[0], box[-1], box[1:-1, 0],
                               box[1:-1, -1]])
        f = box - np.median(edge)
        yy, xx = np.mgrid[y0 - r:y0 + r + 1, x0 - r:x0 + r + 1] + 0.5
        for _ in range(8):
            w = f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                           / (2 * sigma ** 2))
            sw = w.sum()
            x, y = (x + 2.0 * (w * (xx - x)).sum() / sw,
                    y + 2.0 * (w * (yy - y)).sum() / sw)
        out[k] = x, y
    return out


def _run(rows, session, *words):
    """One command of the port's table on ``session`` (the entry the
    script runner calls): its wall and stages into ``rows``; returns
    what the command returns."""
    import torch

    from siril_tpu_torch.cli.commands import COMMANDS

    session.stages = {}
    t = time.perf_counter()
    value = COMMANDS[words[0].lower()].fn(session, list(words[1:]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    cmd = " ".join(words)
    rows[cmd] = dict(seconds=wall, launches={}, stages=dict(session.stages))
    log(f"  {cmd}: wall {wall:.3f}s")
    if session.stages:
        log("    stages: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in session.stages.items()))
    return value


def _corner_offsets(Ha, Hb, size: int):
    """Max distance at the frame's corners between two homographies."""
    import numpy as np

    box = np.array([[0, 0, 1], [size, 0, 1], [0, size, 1], [size, size, 1]],
                   float)
    qa, qb = box @ np.asarray(Ha).T, box @ np.asarray(Hb).T
    return float(np.abs(qa[:, :2] / qa[:, 2:] - qb[:, :2] / qb[:, 2:]).max())


def disto_lights(dist: str, sky, ra, dec, amp, rng, scale: float = 1.0):
    """DISTO_LIGHTS 16-bit lights of the stars (``ra``, ``dec``, ``amp``)
    as ``dist/dist_0000k.fit``: each through the TAN WCS ``sky`` moved by
    a shift of up to ±12 px (none for the first) and the SIP DISTO_SIP ×
    ``scale`` in its own frame, on a sky of 0.1 with noise σ 0.01, a
    pointing hint and the optics in its header.  Returns each light's
    star positions."""
    import numpy as np

    from siril_tpu_torch.ops.wcs import WCS

    A = np.zeros((4, 4))
    B = np.zeros((4, 4))
    for (m, p, q), v in DISTO_SIP.items():
        (A if m == "A" else B)[p, q] = v * scale
    shifts = [(0.0, 0.0)] + [tuple(rng.uniform(-12.0, 12.0, 2))
                             for _ in range(DISTO_LIGHTS - 1)]
    observed = []
    for k, (dx, dy) in enumerate(shifts):
        lin = sky.shifted(dx, dy)
        c = lin.pix2world(np.array([SIZE / 2.0 - 0.5]),
                          np.array([SIZE / 2.0 - 0.5]))
        true_k = WCS(crpix=sky.crpix, crval=(float(c[0][0]),
                                            float(c[1][0])),
                     cd=sky.cd, height=SIZE, sip_a=A, sip_b=B)
        ox, oy = true_k.world2pix(ra, dec)
        observed.append((ox, oy))
        f = _render(SIZE, 0.1, ox, oy, amp) + \
            0.01 * rng.standard_normal((SIZE, SIZE), dtype=np.float32)
        write_later(write_float_u16,
                    os.path.join(dist, f"dist_{k + 1:05d}.fit"), f,
                    extra=hint_cards(true_k, SIZE, rng))
    writes_done()
    return observed


def disto_correct(rows, dist: str, catalog: str, ra, dec, amp,
                  observed) -> dict:
    """The -disto route on ``disto_lights``' output, through the port's
    commands: ``platesolve -order=3`` of the first light against
    ``catalog`` (a path from ``dist``), ``save master``, ``disto``,
    ``register dist_ -noout`` and ``seqapplyreg dist_ -disto=master``.
    Returns the master's WCS, its distortion (max, mean px), the last
    command's row, and the distances of stars from their undistorted
    places under the master's linear part: before (the 60 brightest
    isolated stars of the first light where the SIP put them) and after
    (the DISTO_STARS brightest, centroided in each corrected frame)."""
    import numpy as np

    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.wcs import WCS

    ds = cli.run(["-d", dist, "load", "dist_00001"])
    _run(rows, ds, "platesolve", f"-catalog={catalog}", "-order=3")
    _run(rows, ds, "save", "master")
    dmax, dmean = _run(rows, ds, "disto")
    mw = ds.image.wcs
    log(f"  master: SIP order {mw.sip_a.shape[0] - 1}, distortion max "
        f"{dmax:.2f} px, mean {dmean:.2f}")
    _timed_cli(rows, dist, "register", "dist_", "-noout")
    _, row = _timed_cli(rows, dist, "seqapplyreg", "dist_", "-disto=master")
    lin = WCS(crpix=mw.crpix, crval=mw.crval, cd=mw.cd, height=SIZE)
    wx, wy = lin.world2pix(ra, dec)
    iso = _isolated(wx, wy, amp, SIZE)
    top = iso[:DISTO_STARS]
    after = []
    for k in range(DISTO_LIGHTS):
        out = read_fits(os.path.join(dist, f"r_dist_{k + 1:05d}.fit")
                        ).host()[0]
        got = _centroids(out, wx[top], wy[top])
        after.append(np.hypot(got[:, 0] - wx[top], got[:, 1] - wy[top]))
    before = np.hypot(observed[0][0][iso] - wx[iso],
                      observed[0][1][iso] - wy[iso])
    ea = np.concatenate(after)
    log(f"  -disto: the {len(iso)} brightest isolated stars off their "
        f"undistorted positions by max {float(before.max()):.2f} px (mean "
        f"{float(before.mean()):.2f}) before; the {len(top)} brightest × "
        f"{DISTO_LIGHTS} frames after: max "
        + ", ".join(f"{float(e.max()):.3f}" for e in after)
        + f" a frame (mean {float(ea.mean()):.3f})")
    return dict(master=mw, dmax=dmax, dmean=dmean, row=row, before=before,
                after=after)


def phase_astrometry(seed: int, script_dir: str, night: dict):
    """Plate solving and the astrometric routes at full width, on the
    script phase's scene (its stars on the sky through ``sky_wcs``, the
    catalogue written as a KStars binary) and its calibrated
    ``pp_light``:
      a. ``load result`` (the night's stack, in the reference light's
         geometry) and ``platesolve`` from hints HINT_OFF off; CRVAL,
         scale and rotation against the truth; then ``conesearch``,
         ``healpix``, ``trixel`` and ``show`` counted against the
         catalogue and the truth.  A single calibrated light carries ~420
         ray tracks at one a 40,000 px, brighter than any star, and the
         solver fits only its 400 brightest peaks: on ``pp_light_00001``
         it finds no star (ROADMAP §3);
      b. ``register pp_light -3stars`` with three bright isolated stars
         of the reference frame: each H against the one ``register``
         wrote, at the frame's corners;
      c. DISTO_LIGHTS lights rendered through DISTO_SIP with shifts;
         ``platesolve -order=3`` of the first, saved as the master;
         ``register dist_ -noout`` and ``seqapplyreg dist_ -disto=``;
         bright isolated stars of the output against their undistorted
         positions; the SIP warp's ms per frame (CUDA events) beside the
         gather warp's, and the card against the CPU on a SIP_CROP² crop.
    Returns ({command: row}, timings)."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.astrometry.healpix import (
        image_footprint_pixels,
        image_footprint_trixels,
    )
    from siril_tpu_torch.astrometry.kstars_local import (
        write_kstars_catalogue,
    )
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.ops import interp
    from siril_tpu_torch.ops.wcs import sip_frame

    rng = np.random.default_rng(seed + 61)
    proc = os.path.join(script_dir, "process")
    sky = sky_wcs(SIZE)
    sx, sy, amp = night["sx"], night["sy"], night["amp"]
    ra, dec = sky.pix2world(sx, sy)
    mag = star_mags(amp)
    cat = os.path.join(proc, "field_tycho.dat")
    t = time.perf_counter()
    write_kstars_catalogue(cat, ra, dec, mag)
    log(f"  the scene's {len(sx)} stars as a KStars catalogue in "
        f"{time.perf_counter() - t:.2f}s")
    rows, checks, timings = {}, {}, {}

    # a. plate solve of the night's stack, and the field's commands
    hra = SKY_CENTRE[0] + HINT_OFF[0] / 60.0
    hdec = SKY_CENTRE[1] + HINT_OFF[1] / 60.0
    session = cli.run(["-d", proc, "load", "result"])
    solve = ["platesolve", f"{hra}", f"{hdec}", "-catalog=field_tycho.dat",
             f"-focal={FOCAL_MM}", f"-pixelsize={PIXEL_UM}"]
    _run(rows, session, *solve)
    timings["platesolve"] = rows[" ".join(solve)]
    w = session.image.wcs
    tra, tdec = sky.pix2world(np.array([w.crpix[0] - 1.0]),
                              np.array([SIZE - w.crpix[1]]))
    d_crval = 3600.0 * float(np.hypot(
        (w.crval[0] - tra[0]) * np.cos(np.radians(tdec[0])),
        w.crval[1] - tdec[0]))
    d_scale = w.pixel_scale_arcsec / sky.pixel_scale_arcsec - 1.0
    d_rot = (w.rotation_deg - sky.rotation_deg + 180.0) % 360.0 - 180.0
    log(f"  solved: CRVAL {d_crval:.3f}″ from the truth, scale "
        f"{w.pixel_scale_arcsec:.6f}″/px ({d_scale:+.2e}), rotation "
        f"{w.rotation_deg:.4f}° ({d_rot:+.4f}° off)")
    checks["platesolve: CRVAL within 0.5″"] = d_crval < 0.5
    checks["platesolve: scale within 0.1 %"] = abs(d_scale) < 1e-3
    checks["platesolve: rotation within 0.01°"] = abs(d_rot) < 0.01
    n_in = _run(rows, session, "conesearch", "99",
                "-catalog=field_tycho.dat")
    # the command's cone has a radius of ⅔ of the field's width, short of
    # its corners (the JAX package's rule): count the truth the same way
    px, py = sky.world2pix(ra, dec)
    cra, cdec = w.pix2world(np.array([SIZE / 2.0]), np.array([SIZE / 2.0]))
    sep = np.hypot((np.mod(ra - cra[0] + 180.0, 360.0) - 180.0)
                   * np.cos(np.radians(cdec[0])), dec - cdec[0])
    radius = w.pixel_scale_arcsec * SIZE / 3600.0 / 1.5
    inside = (px >= 0) & (px < SIZE) & (py >= 0) & (py < SIZE)
    want = inside & (sep <= radius)
    edge = want & ((px < 1) | (px >= SIZE - 1) | (py < 1) |
                   (py >= SIZE - 1) | (sep > radius - 1.0 / 3600.0))
    log(f"  conesearch: {n_in} catalogue stars in the field and the cone, "
        f"{int(want.sum())} by the truth ({int(edge.sum())} within 1 px of "
        f"the border or the cone; {int(inside.sum())} in the whole field)")
    checks["conesearch counts the stars in the field"] = \
        abs(n_in - int(want.sum())) <= int(edge.sum())
    pix = _run(rows, session, "healpix")
    trix = _run(rows, session, "trixel")
    want_pix = image_footprint_pixels(sky, SIZE, SIZE, 256)
    want_trix = image_footprint_trixels(sky, SIZE, SIZE, 3)
    log(f"  healpix: {len(pix)} order-8 pixels ({len(want_pix)} by the "
        f"truth); trixel: {len(trix)} level-3 trixels ({len(want_trix)})")
    # a sample within a fraction of a pixel of a cell's border may cross
    checks["healpix and trixel: the truth's footprint (± one cell)"] = \
        len(set(pix) ^ set(want_pix)) <= 1 and \
        len(set(trix) ^ set(want_trix)) <= 1
    anns = _run(rows, session, "show")
    mx, my = sky.world2pix(np.array([83.8221]), np.array([-5.3911]))
    m42 = [a for a in anns if a.name == "M42"]
    log(f"  show: {[a.name for a in anns]}; M42 at "
        f"{[(round(a.x, 2), round(a.y, 2)) for a in m42]} (truth "
        f"{float(mx[0]):.2f}, {float(my[0]):.2f})")
    checks["show: M42 within 1 px of the truth"] = len(m42) == 1 and \
        np.hypot(m42[0].x - mx[0], m42[0].y - my[0]) < 1.0

    # b. the 3-star registration of pp_light against register's: three
    # bright stars with no other star in their follow box, whose box
    # holds no ray in any selected frame (a ray track outshines every
    # star; a user picks the stars on the reference frame and drops a
    # lost one)
    seqf = os.path.join(proc, "pp_light_.seq")
    before = read_seqfile(seqf)
    H_reg, sel = before.reg(0).H.copy(), before.selected_indices()
    half = THREESTAR_BOX // 2
    reach = np.hypot(sx - SIZE / 2.0, sy - SIZE / 2.0) < THREESTAR_REACH
    cand = [i for i in _isolated(sx, sy, amp, SIZE, n=200, near=1.5 * half)
            if reach[i]]
    c = SIZE / 2.0
    for k in sel:
        th, sc, dx, dy = night["transforms"][k]
        frame = read_fits(os.path.join(
            proc, f"pp_light_{k + 1:05d}.fit")).host()[0]
        keep = []
        for i in cand:
            fx = sc * (np.cos(th) * (sx[i] - c) - np.sin(th) * (sy[i] - c)) \
                + c + dx
            fy = sc * (np.sin(th) * (sx[i] - c) + np.cos(th) * (sy[i] - c)) \
                + c + dy
            # the follow's box: about the star's place on the reference
            x0 = int(round(sx[i] - 0.5)) - half
            y0 = int(round(sy[i] - 0.5)) - half
            box = frame[y0:y0 + 2 * half + 1, x0:x0 + 2 * half + 1]
            py_, px_ = np.unravel_index(int(box.argmax()), box.shape)
            if np.hypot(x0 + px_ + 0.5 - fx, y0 + py_ + 0.5 - fy) < 2.0:
                keep.append(i)
        cand = keep
    pts = np.stack([sx[cand], sy[cand]], axis=1)
    third = np.floor((np.arctan2(pts[:, 1] - c, pts[:, 0] - c) + np.pi)
                     / (2 * np.pi / 3)).astype(int) % 3
    if set(third) != {0, 1, 2}:
        raise RuntimeError("-3stars: no fit star in a third of the frame")
    pick = [int(np.nonzero(third == k)[0][0]) for k in range(3)]
    words = ["register", "pp_light", "-3stars",
             f"-boxsize={THREESTAR_BOX}"] + [
        f"-star{n + 1}={pts[i][0]:.2f},{pts[i][1]:.2f}"
        for n, i in enumerate(pick)]
    _, row = _timed_cli(rows, proc, *words)
    timings["3stars"] = dict(row, frames=len(sel))
    after = read_seqfile(seqf).reg(0)
    offs = [_corner_offsets(after.H[i], H_reg[i], SIZE) for i in sel]
    log(f"  -3stars on {len(sel)} frames ({row['seconds'] / len(sel):.3f}s "
        f"a frame): H against register's at the corners "
        f"{', '.join(f'{v:.3f}' for v in offs)} px")
    checks[f"-3stars: every frame registered, H within {THREESTAR_TOL} "
           "px of register's"] = bool(after.valid[sel].all()) and \
        max(offs) < THREESTAR_TOL

    # c. the distortion master and -disto
    dist = os.path.join(script_dir, "disto")
    os.makedirs(dist)
    t = time.perf_counter()
    observed = disto_lights(dist, sky, ra, dec, amp, rng)
    ux, uy = sky.world2pix(ra, dec)
    shift_all = np.hypot(observed[0][0] - ux, observed[0][1] - uy)
    log(f"  rendered {DISTO_LIGHTS} lights through the SIP in "
        f"{time.perf_counter() - t:.2f}s; displacement of the stars in the "
        f"field max {float(shift_all[inside].max()):.2f} px")
    dc = disto_correct(rows, dist, "../process/field_tycho.dat", ra, dec,
                       amp, observed)
    timings["disto"] = dc["row"]
    mw = dc["master"]
    ea, eb = np.concatenate(dc["after"]), dc["before"]
    checks[f"-disto: within {DISTO_TOL} px after ({DISTO_MEAN_TOL} on "
           f"average), ≥ {DISTO_BEFORE} px before"] = \
        float(ea.max()) < DISTO_TOL and float(ea.mean()) < DISTO_MEAN_TOL \
        and float(eb.max()) >= DISTO_BEFORE
    # the SIP warp a frame, beside the gather warp; card against CPU
    dev = torch.device(CARD)
    frame = torch.from_numpy(read_fits(os.path.join(
        dist, "dist_00002.fit")).host()).to(dev)
    H2 = read_seqfile(os.path.join(dist, "dist_.seq")).reg(0).H[1]
    sf = sip_frame(mw.crpix, mw.height)
    sip_ms = _events_ms(lambda: interp.warp_homography_sip(
        frame, H2, mw.sip_a, mw.sip_b, sf, (SIZE, SIZE), invert=True), 3)
    gather_ms = _events_ms(lambda: interp.warp_homography(
        frame, H2, (SIZE, SIZE)), 3)
    crop = frame[:, :SIP_CROP, :SIP_CROP]

    def sip(x, **kw):
        return interp.warp_homography_sip(
            x, H2, mw.sip_a, mw.sip_b, sf, (SIP_CROP, SIP_CROP),
            invert=True, **kw).cpu()
    # the clamp puts one of two values in a pixel: the lanczos sum or the
    # bilinear guide; a flip takes the other one
    cpu_lanczos, cpu_guide = (sip(crop.cpu(), clamp=False, **kw) for kw in (
        {}, dict(method=interp.INTERP_BILINEAR)))
    on_card = sip(crop)
    cpu_err = float((sip(crop, clamp=False) - cpu_lanczos).abs().max())
    d = (on_card - sip(crop.cpu())).abs()
    clamp_err, flips = float(d.max()), int((d > SIP_CPU_TOL).sum())
    flip_err = float(torch.minimum((on_card - cpu_lanczos).abs(),
                                   (on_card - cpu_guide).abs()).max())
    timings["sip_warp"] = dict(ms=sip_ms, gather_ms=gather_ms,
                               cpu_err=cpu_err, clamp_err=clamp_err,
                               clamp_flips=flips, flip_err=flip_err)
    log(f"  SIP warp (order 3, inverted): {sip_ms:.2f} ms a {SIZE}² frame "
        f"(CUDA events, median of 3; the gather warp {gather_ms:.2f} ms); "
        f"card against CPU on a {SIP_CROP}² crop: max |Δ| {cpu_err:.3g} "
        f"without the clamp; with it {clamp_err:.3g}, {flips} pixels over "
        f"{SIP_CPU_TOL:g}, each within {flip_err:.3g} of the CPU's lanczos "
        f"sum or bilinear guide")
    checks[f"SIP warp: card within {SIP_CPU_TOL:g} of the CPU (with the "
           f"clamp but on at most {SIP_CLAMP_FLIPS:g} of the pixels, each "
           "within it of the CPU's other value)"] = \
        cpu_err <= SIP_CPU_TOL and flip_err <= SIP_CPU_TOL and \
        flips <= SIP_CLAMP_FLIPS * SIP_CROP ** 2
    del frame, crop, on_card, cpu_lanczos, cpu_guide, d
    shutil.rmtree(dist)
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        log(f"  check astrometry: {k}: FAILED")
    if failed:
        raise RuntimeError(f"astrometry checks failed: {failed}")
    return rows, timings


#: the formats phase: the script phase's first FORMATS_LIGHTS raw lights
#: (8 until the astrometry phase came: cut to make room, PERF.md §4)
FORMATS_LIGHTS = 4
#: the SER sequence's stack against the regular one's: the SER frames are
#: decoded as u16 / 65535 on the host and take the streamed path, the
#: FITS ones as (x + 32768) · (1/65535) on the card on the resident path
#: (one float32 ulp apart), so a pixel here and there flips a rejection:
#: mean |Δ| below 1e-6, and at most one pixel in 1e5 off by more than
#: 1e-5 (one in 262144 measured at 512² on the CPU)
SER_MEAN_TOL = 1e-6
SER_FLIPS = 1e-5


def phase_formats(seed: int, script_dir: str):
    """FITS formats and sequence kinds at full width on the script
    phase's raw 16-bit lights, linked into a directory of their own:
    ``link``, ``convert -fitseq``, ``convert -ser`` and ``rej 3 3``
    stacks of the regular, cube and SER sequences; a light written and
    read as BITPIX 8, 32 and -64; ``setcompress`` rice and gzip2, save and
    load; the C++ Rice coder's ms per frame and its bytes against the
    Python coder's; a 4-frame fz sequence stacked; the lights as an 8-bit
    grey uncompressed AVI (``AviWriter``), ``convert`` and stacked,
    against the same 8-bit frames written as FITS.  Returns ({path: K1
    launches}, {command: row}, timings)."""
    import numpy as np

    from siril_tpu_torch import native
    from siril_tpu_torch.core.image import DOUBLE_IMG
    from siril_tpu_torch.io import fits_compress as fc
    from siril_tpu_torch.io.fits_io import read_fits, write_fits

    fmt = os.path.join(script_dir, "formats")
    os.makedirs(fmt)
    lights = os.path.join(script_dir, "lights")
    for k in range(1, FORMATS_LIGHTS + 1):
        os.symlink(os.path.join(lights, f"light_{k:05d}.fit"),
                   os.path.join(fmt, f"raw_{k:05d}.fit"))
    rows, checks, timings, launches = {}, {}, {}, {}
    # the cube and the video first: convert takes every FITS file of the
    # directory but its own outputs, and link's would be among them
    _timed_cli(rows, fmt, "convert", "light", "-fitseq", "-out=cube")
    _timed_cli(rows, fmt, "convert", "light", "-ser", "-out=ser")
    _timed_cli(rows, fmt, "link", "light")
    results = {}
    for kind, d in (("regular", fmt), ("cube", os.path.join(fmt, "cube")),
                    ("SER", os.path.join(fmt, "ser"))):
        s, row = _timed_cli(rows, d, "stack", "light_", "rej", "3", "3",
                            "-norm=addscale", "-out=result")
        rows[f"stack light_ rej 3 3 -norm=addscale ({kind})"] = rows.pop(
            "stack light_ rej 3 3 -norm=addscale -out=result")
        launches[f"formats: stack of the {kind} sequence"] = row["launches"]
        results[kind] = (s.image.host(), s.result, s.sequence.seq_type)
    reg_out, cube_out, ser_out = (results[k][0] for k in
                                  ("regular", "cube", "SER"))
    dser = np.abs(ser_out - reg_out)
    log(f"  sequence types {[results[k][2] for k in results]}; cube "
        f"result against the regular one: max |Δ| "
        f"{float(np.abs(cube_out - reg_out).max()):.3g}; SER: mean |Δ| "
        f"{float(dser.mean()):.3g}, max {float(dser.max()):.3g}, pixels "
        f"over 1e-5 {int((dser > 1e-5).sum())}")
    checks["cube stack bit-equal to the regular one"] = \
        bool((cube_out == reg_out).all())
    checks[f"SER stack within mean {SER_MEAN_TOL:g}, at most "
           f"{SER_FLIPS:g} of the pixels off by 1e-5"] = \
        float(dser.mean()) < SER_MEAN_TOL and \
        int((dser > 1e-5).sum()) <= SER_FLIPS * dser.size
    checks["results finite, SIZE²"] = all(
        r[0].shape == (1, SIZE, SIZE) and bool(np.isfinite(r[0]).all())
        for r in results.values())
    for d in ("cube", "ser"):
        shutil.rmtree(os.path.join(fmt, d))
    del results, cube_out, ser_out, dser

    # BITPIX 8 (the port's writer), 32 and -64 (numpy), -64 saved as -32
    light = read_fits(os.path.join(fmt, "raw_00001.fit"))
    x = light.host()
    p8 = os.path.join(fmt, "b8.fit")
    write_fits(light, p8, bitdepth=8)
    u16 = np.rint(x[0] * 65535.0).astype(np.int64)
    _write_fits_raw(os.path.join(fmt, "b32.fit"),
                    (u16 * 65537 - 2 ** 31).astype(">i4"), 32,
                    bzero=2147483648.0)
    _write_fits_raw(os.path.join(fmt, "b64.fit"), x[0].astype(">f8"), -64)
    write_fits(light, os.path.join(fmt, "d64.fit"), bitdepth=DOUBLE_IMG)
    for name, step in (("b8", 1 / 255), ("b32", 2.0 ** -24), ("b64", 0.0),
                       ("d64", 0.0)):
        back = read_fits(os.path.join(fmt, name + ".fit"))
        err = float(np.abs(back.host() - x).max())
        log(f"  {name}: BITPIX read back {back.orig_bitdepth}, max |Δ| "
            f"{err:.3g} (half a quantization step {step / 2:.3g})")
        checks[f"{name} within half its step"] = err <= step / 2 + 1e-7

    # setcompress + save + load of a 16-bit light
    with open(os.path.join(fmt, "compress.ssf"), "w") as f:
        f.write("load raw_00001\nsetcompress 1 -type=rice\nsave c_rice\n"
                "setcompress 1 -type=gzip2\nsave c_gzip2\nsetcompress 0\n"
                "close\n")
    from siril_tpu_torch import cli

    s = cli.run(["-d", fmt, "-s", os.path.join(fmt, "compress.ssf")])
    _log_rows(s, rows)
    for kind in ("rice", "gzip2"):
        p = os.path.join(fmt, f"c_{kind}.fit")
        back = read_fits(p)
        # the 16-bit values (a compressed tile decodes through float64, a
        # plain one through float32: one float32 ulp apart)
        same = bool((np.rint(back.host()[0] * 65535.0) == u16).all()) and \
            back.orig_bitdepth == 20
        log(f"  setcompress {kind}: {os.path.getsize(p) / 2 ** 20:.1f} MiB "
            f"against {os.path.getsize(os.path.join(lights, 'light_00001.fit')) / 2 ** 20:.1f}"
            f" MiB raw; loaded back bit-equal: {same}")
        checks[f"setcompress {kind}: save and load bit-equal"] = same

    # the C++ Rice coder: ms a frame, and its bytes against Python's
    rows_i16 = (u16 - 32768).astype(np.int16)
    native.lib()
    enc, dec = [], []
    for _ in range(3):
        t = time.perf_counter()
        heap, offs, lens = native.rice_encode_tiles_i16(rows_i16)
        enc.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        back = native.rice_decode_tiles_i16(heap, offs, lens, SIZE)
        dec.append((time.perf_counter() - t) * 1e3)
    same_py = all(heap[offs[k]:offs[k] + lens[k]] ==
                  fc.rice_encode(rows_i16[k].astype(np.int64), 2)
                  for k in range(64))
    timings["rice"] = dict(encode_ms=sorted(enc)[1],
                           decode_ms=sorted(dec)[1], bytes=len(heap))
    log(f"  C++ Rice coder, one {SIZE}² 16-bit frame on the host (median "
        f"of 3): encode {sorted(enc)[1]:.1f} ms, decode {sorted(dec)[1]:.1f}"
        f" ms, {len(heap) / 2 ** 20:.1f} MiB; the first 64 rows' streams "
        f"equal to the Python coder's: {same_py}")
    checks["C++ Rice: decoded equal, streams equal to Python's"] = \
        same_py and bool((back == rows_i16).all())

    # a 4-frame fz sequence, stacked, against the same frames uncompressed
    # (the regular sequence's stack)
    for k in range(1, 5):
        img = read_fits(os.path.join(fmt, f"raw_{k:05d}.fit"))
        write_fits(img, os.path.join(fmt, f"fz_{k:05d}.fit.fz"),
                   compression="rice")
    fz, row = _timed_cli(rows, fmt, "stack", "fz_", "rej", "3", "3",
                         "-norm=addscale", "-out=fz_result")
    launches["formats: stack of the fz sequence"] = row["launches"]
    dfz = float(np.abs(fz.image.host() - reg_out).max())
    log(f"  fz sequence ({fz.sequence.fz=}) stacked against the same 4 "
        f"frames uncompressed: max |Δ| {dfz:.3g}")
    checks["fz stack within 2e-6 of the uncompressed one"] = \
        fz.sequence.fz and dfz <= 2e-6
    del fz

    # the lights as an 8-bit grey uncompressed AVI, converted and stacked,
    # against the same frames written as float32 FITS of the AVI decoder's
    # values (u8 / 255: a BITPIX 8 file reads as u8 · (1/255), which
    # differs from the division in 126 of the 256 values)
    from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
    from siril_tpu_torch.io.avi import AviWriter, to_u8

    vid = os.path.join(fmt, "video")
    twin = os.path.join(fmt, "twin")
    os.makedirs(vid)
    os.makedirs(twin)
    t = time.perf_counter()
    wr = AviWriter(os.path.join(vid, "night.avi"), SIZE, SIZE, color=False)
    for k in range(1, FORMATS_LIGHTS + 1):
        img = read_fits(os.path.join(fmt, f"raw_{k:05d}.fit"))
        wr.add_frame(img)
        u8 = to_u8(img)
        write_fits(SirilImage(data=u8.astype(np.float32) / 255.0),
                   os.path.join(twin, f"twin_{k:05d}.fit"),
                   bitdepth=FLOAT_IMG)
    wr.close()
    timings["avi_write"] = time.perf_counter() - t
    log(f"  wrote {FORMATS_LIGHTS} lights as an 8-bit AVI "
        f"({os.path.getsize(os.path.join(vid, 'night.avi')) / 2 ** 20:.1f} "
        f"MiB) and as FITS in {timings['avi_write']:.2f}s")
    _timed_cli(rows, vid, "convert", "night")
    avi_s, row = _timed_cli(rows, vid, "stack", "night_", "rej", "3", "3",
                            "-norm=addscale", "-out=result")
    launches["formats: stack of the converted AVI"] = row["launches"]
    twin_s, row = _timed_cli(rows, twin, "stack", "twin_", "rej", "3", "3",
                             "-norm=addscale", "-out=result")
    launches["formats: stack of the AVI's FITS twin"] = row["launches"]
    same = bool((avi_s.image.host() == twin_s.image.host()).all())
    log(f"  AVI: {avi_s.sequence.number} frames converted; its stack "
        f"bit-equal to the FITS twin's: {same}")
    checks["AVI stack bit-equal to its FITS twin's"] = same and \
        avi_s.sequence.number == FORMATS_LIGHTS
    del avi_s, twin_s, reg_out
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        log(f"  check formats: {k}: FAILED")
    if failed:
        raise RuntimeError(f"formats checks failed: {failed}")
    return launches, rows, timings


def _write_fits_raw(path: str, data, bitpix: int, bzero: float = 0.0):
    """A one-HDU FITS file of the stored values ``data`` (H, W), already
    in the big-endian dtype of ``bitpix``, rows bottom-up."""
    import numpy as np

    h, w = data.shape
    cards = ["SIMPLE  =                    T", f"BITPIX  = {bitpix:>20}",
             "NAXIS   =                    2", f"NAXIS1  = {w:>20}",
             f"NAXIS2  = {h:>20}"]
    if bzero:
        cards += [f"BZERO   = {bzero:>20}", "BSCALE  =                  1.0"]
    cards.append("END")
    hdr = "".join(c.ljust(80) for c in cards).encode("ascii")
    hdr += b" " * ((-len(hdr)) % 2880)
    body = np.ascontiguousarray(data[::-1]).tobytes()
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(b"\0" * ((-len(body)) % 2880))


#: the mosaic phase: 2 × 2 tiles of SIZE² with MOSAIC_OVERLAP px overlaps
#: cut from one sky, each with its own sky level and gain (tile 1, the
#: reference, first)
MOSAIC_OVERLAP = 1024
MOSAIC_LEVELS = [(0.10, 1.00), (0.13, 0.92), (0.08, 1.07), (0.115, 0.96)]
#: each plate-solved H within this many px of the true tile-to-reference
#: map at the tile's corners
MOSAIC_H_TOL = 0.1


def synth_mosaic(root: str, seed: int, size: int, overlap: int,
                 nstars: int = 4000):
    """The mosaic's tiles as 16-bit files ``mosaic_0000k.fit`` under
    ``root``: stars on the sky (``nstars`` per size² of the canvas, placed
    through one TAN WCS for the whole canvas, ``sky_wcs``), and each tile
    an exposure of its own: a TAN projection about its centre (the
    canvas's sky there, the canvas's scale and turn), its level + gain ×
    stars + noise σ 0.01, a pointing hint and the optics in its header
    (``hint_cards``).  Two tangent planes map onto each other by a
    homography, so each tile's true map onto tile 1 is the one its WCS
    gives (a few px from a shift by the corner offset).  The stars are
    the binary Gaia catalogue ``sky.cat``.  Returns (the stars' RA, Dec,
    amplitudes, the tiles' WCS, the tiles' corners on the canvas, noise
    σ)."""
    import numpy as np

    from siril_tpu_torch.astrometry.gaia_local import write_gaia_astro
    from siril_tpu_torch.ops.wcs import WCS

    rng = np.random.default_rng(seed)
    step = size - overlap
    full = size + step
    sx, sy, amp = _star_field(rng, full, int(nstars * (full / size) ** 2))
    canvas = sky_wcs(full)
    ra, dec = canvas.pix2world(sx, sy)
    write_gaia_astro(os.path.join(root, "sky.cat"), ra, dec, star_mags(amp))
    corners = [(0, 0), (step, 0), (0, step), (step, step)]
    tiles = []
    for k, ((x0, y0), (level, gain)) in enumerate(zip(corners,
                                                      MOSAIC_LEVELS)):
        c = canvas.pix2world(np.array([x0 + size / 2.0 - 0.5]),
                             np.array([y0 + size / 2.0 - 0.5]))
        tile = WCS(crpix=(size / 2.0 + 0.5, size / 2.0 + 0.5),
                   crval=(float(c[0][0]), float(c[1][0])), cd=canvas.cd,
                   height=size)
        tiles.append(tile)
        tx, ty = tile.world2pix(ra, dec)
        inb = (tx > -8) & (tx < size + 8) & (ty > -8) & (ty < size + 8)
        f = level + gain * _render(size, 0.0, tx[inb], ty[inb], amp[inb]) \
            + 0.01 * rng.standard_normal((size, size), dtype=np.float32)
        write_later(write_float_u16,
                    os.path.join(root, f"mosaic_{k + 1:05d}.fit"), f,
                    extra=hint_cards(tile, size, rng))
    writes_done()
    return ra, dec, amp, tiles, corners, 0.01


def _seam_step(out, want, x=None, y=None, near: int = 32, far: int = 96,
               edge: int = 256):
    """Median of out − want on the far side of a seam at column ``x`` (or
    row ``y``) minus the median on the near side, strips of far − near px
    at ``near`` px from it, away from the other seam and the edges."""
    import numpy as np

    d = out - want
    if x is not None:
        a = d[edge:x - edge, x - far:x - near]
        b = d[edge:x - edge, x + near:x + far]
    else:
        a = d[y - far:y - near, edge:y - edge]
        b = d[y + near:y + far, edge:y - edge]
    return float(np.median(b) - np.median(a))


def _footprints(Hs, T, size: int, out_h: int, out_w: int):
    """Masks of the canvas pixels whose source lies a pixel inside some
    tile (``inside``) and a pixel outside every tile (``outside``) under
    the maps T·H, computed on the card a band of rows at a time."""
    import numpy as np
    import torch

    dev = torch.device(CARD)
    inv = [torch.tensor(np.linalg.inv(T @ H), dtype=torch.float64,
                        device=dev) for H in Hs]
    inside = np.zeros((out_h, out_w), bool)
    outside = np.zeros((out_h, out_w), bool)
    xs = torch.arange(out_w, dtype=torch.float64, device=dev)[None]
    for y0 in range(0, out_h, 512):
        ys = torch.arange(y0, min(out_h, y0 + 512), dtype=torch.float64,
                          device=dev)[:, None]
        ins = torch.zeros((ys.shape[0], out_w), dtype=torch.bool,
                          device=dev)
        near = torch.zeros_like(ins)
        for m in inv:
            d = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
            u = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / d
            v = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / d
            ins |= (u >= 1) & (u <= size - 2) & (v >= 1) & (v <= size - 2)
            near |= (u > -1) & (u < size) & (v > -1) & (v < size)
        inside[y0:y0 + ys.shape[0]] = ins.cpu().numpy()
        outside[y0:y0 + ys.shape[0]] = (~near).cpu().numpy()
    return inside, outside


def phase_mosaic(seed: int, size: int = SIZE,
                 overlap: int = MOSAIC_OVERLAP):
    """A 2 × 2 mosaic through the CLI by the reference's route:
    ``seqplatesolve mosaic_ -catalog=sky.cat`` (each tile from its header
    hint; each solved centre seeds the next), ``seqapplyreg mosaic_
    -framing=max`` (no registration data: the homographies from the WCS
    solutions, each tile warped onto the canvas), checked against the
    known corner offsets; then on the warped canvas ``stack r_mosaic_ rej
    3 3 -norm=addscale -overlap_norm -feather=64`` (K1e with per-pixel
    weights), checked for a step in level across each seam, and ``stack
    r_mosaic_ max -maximize``, checked for the union of the footprints.
    Returns ({command: {variant: launches}}, {command: row}, how the tiles
    were registered, K1e held at the feathered stack's calls)."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.stacking import plan_blocks
    from siril_tpu_torch.registration.astrometric import (
        fit_homography_from_wcs,
        register_astrometric,
    )
    from siril_tpu_torch.registration.global_reg import (
        FRAMING_MAX,
        compute_framing,
    )
    from siril_tpu_torch.utils.devmem import MEMORY_RATIO

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mosaic_")
    try:
        t = time.perf_counter()
        ra, dec, amp, tiles, corners, sigma_n = synth_mosaic(
            tmp, seed + 41, size, overlap)
        step = size - overlap
        log(f"  synthesized 4 tiles of {size}x{size} (16-bit), {overlap} px "
            f"overlaps, each through its own TAN projection, and the "
            f"catalogue of their {len(ra)} stars, in "
            f"{time.perf_counter() - t:.2f}s")
        rows, failed = {}, []
        _timed_cli(rows, tmp, "seqplatesolve", "mosaic_", "-catalog=sky.cat")
        solved = [read_fits(os.path.join(tmp, f"mosaic_{k + 1:05d}.fit")).wcs
                  for k in range(4)]
        _timed_cli(rows, tmp, "seqapplyreg", "mosaic_", "-framing=max")
        # the homographies the command derived (the .seq keeps 6 digits),
        # against the true maps of the tiles' own projections
        seq = Sequence.scan("mosaic_", tmp)
        register_astrometric(seq)
        reg = seq.reg(0)
        true_H = [fit_homography_from_wcs(w, tiles[0], size, size)
                  for w in tiles]
        offs = [_corner_offsets(reg.H[k], true_H[k], size) for k in range(4)]
        shift = [_corner_offsets(true_H[k], np.array(
            [[1, 0, x0], [0, 1, y0], [0, 0, 1.0]]), size)
            for k, (x0, y0) in enumerate(corners)]
        how = "plate solve"
        log(f"  tiles solved {sum(w is not None for w in solved)} of 4; "
            f"registered by {how}: each H against the true map at the "
            f"tile's corners {', '.join(f'{v:.4f}' for v in offs)} px (the "
            f"true maps {', '.join(f'{v:.2f}' for v in shift)} px from "
            f"shifts by the corner offsets)")
        out_w, out_h, T = compute_framing(seq, 0, FRAMING_MAX)
        for name, good in {
                "4 of 4 tiles plate-solved": all(w is not None
                                                 for w in solved),
                f"each H within {MOSAIC_H_TOL} px of the true map":
                    bool(reg.valid.all()) and max(offs) < MOSAIC_H_TOL,
                f"the canvas {out_w}x{out_h}": read_fits(os.path.join(
                    tmp, "r_mosaic_00004.fit")).host().shape ==
                    (1, out_h, out_w)}.items():
            if not good:
                log(f"    check {name}: FAILED")
                failed.append(name)
        # the sky as tile 1 sees it, on the canvas
        wx, wy = tiles[0].world2pix(ra, dec)
        n = max(out_w, out_h)
        stars = _render(n, 0.0, wx + T[0, 2], wy + T[1, 2], amp)[:out_h,
                                                                 :out_w]
        del wx, wy
        runs, held = {}, []
        for cmd in ("rej 3 3 -norm=addscale -overlap_norm -feather=64",
                    "max -maximize"):
            # the inputs of each K1 call the command makes (the wrapper
            # it calls counts the launch)
            calls, reject_mean = [], k1.reject_mean

            def spy(*a, **kw):
                calls.append((a, kw))
                return reject_mean(*a, **kw)
            k1.reset_counts()
            k1.reject_mean = spy
            t = time.perf_counter()
            try:
                s = cli.run(["-d", tmp, "stack", "r_mosaic_", *cmd.split(),
                             "-out=mosaic_result"])
                torch.cuda.synchronize()
            finally:
                k1.reject_mean = reject_mean
            rows[f"stack r_mosaic_ {cmd}"] = dict(
                seconds=time.perf_counter() - t, stages=s.result.stage_s)
            runs[cmd] = dict(k1.launches)
            out = s.result.image.host()[0]
            log(f"  stack r_mosaic_ {cmd}: wall "
                f"{rows[f'stack r_mosaic_ {cmd}']['seconds']:.2f}s, "
                f"launches { {k: v for k, v in runs[cmd].items() if v} }, "
                f"canvas {out.shape}")
            log("    stages: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in s.result.stage_s.items()))
            if cmd.startswith("rej"):
                level, gain = MOSAIC_LEVELS[0]
                want = level + gain * stars
                steps = (_seam_step(out, want, x=step),
                         _seam_step(out, want, y=step))
                m = 48
                err = float(np.abs(out - want)[m:-m, m:-m].mean())
                log(f"    level step across the seam at x = {step}: "
                    f"{steps[0]:.2e}, at y = {step}: {steps[1]:.2e} (noise "
                    f"{sigma_n}); interior mean |Δ| against tile 1's level "
                    f"and gain {err:.5f}")
                # the streamed stack's row blocks (the budget the stack
                # command sets: 2048 MB × MEMORY_RATIO)
                rows_per = plan_blocks(out_h, out_w, 4, max(int(
                    2048 * min(MEMORY_RATIO, 4.0)), 128))
                blocks = -(-out_h // rows_per)
                log(f"    K1e launches {runs[cmd]['K1e']}: one a block of "
                    f"{rows_per} rows")
                # K1e against its plain version at the call's own shapes
                # and inputs (these launches come after the count)
                held += [held_at_call(
                    f"the plate-solved mosaic's feathered stack, row block "
                    f"{b + 1} of {len(calls)}", "winsorized/addscale", *a,
                    kw) for b, (a, kw) in enumerate(calls)]
                calls.clear()
                torch.cuda.empty_cache()
                checks = {
                    "K1e launched once a row block (per-pixel weights)":
                        runs[cmd]["K1e"] == blocks and
                        sum(runs[cmd].values()) == blocks,
                    "K1e bit-equal to its plain version on every block, "
                    "weights of 0 among the compared pixels":
                        len(held) == blocks and all(
                            h["ok"] and h["weights"] == "per pixel" and
                            h["zero_weights_compared"] > 0 for h in held),
                    "each seam's step below the noise / 5":
                        max(abs(v) for v in steps) < sigma_n / 5,
                    "interior mean |Δ| < noise": err < sigma_n,
                    "no loop stopped at its bound": s.result.capped == 0}
            else:
                inside, outside = _footprints(reg.H, T, size, out_h, out_w)
                log(f"    covered {int(inside.sum())} px, uncovered "
                    f"{int(outside.sum())} px of the canvas")
                checks = {
                    "the canvas is the union of the footprints (> 0 a px "
                    "inside them, 0 a px outside)":
                        out.shape == (out_h, out_w) and
                        bool((out[inside] > 0).all()) and
                        bool((out[outside] == 0).all()),
                    "no kernel launched": sum(runs[cmd].values()) == 0}
            checks["result finite"] = bool(np.isfinite(out).all())
            for name, good in checks.items():
                if not good:
                    log(f"    check {name}: FAILED")
                    failed.append(f"{cmd}: {name}")
        if failed:
            raise RuntimeError(f"mosaic checks failed: {failed}")
        return runs, rows, how, held
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the stack commands of the stack phase and the variant each must launch
#: the post-stack colour session (phase post): a stacked RGB field at
#: POST_SKY with a quadratic gradient of POST_GRADIENT of the sky across
#: the field, noise POST_NOISE (a stack's), POST_STARS stars of PSF σ
#: POST_PSF px, and a channel imbalance POST_IMBALANCE that spcc and pcc
#: must undo within POST_GAIN_TOL (tests/test_xp_spectra.py:229); after
#: ``subsky 2`` the gradient left (the range of 16 × 16 tile medians) is
#: below POST_NOISE / 3
POST_SKY = 0.1
POST_GRADIENT = 0.2
POST_NOISE = 0.003
POST_STARS = 800
POST_PSF = 1.5
POST_IMBALANCE = (1.5, 1.0, 0.7)
POST_GAIN_TOL = 0.08
POST_TILES = 16
#: the card-against-CPU crop of every elementwise op, the smaller one of
#: the rotation and the background models (their CPU side is the phase's
#: longest part), and the timing reps
POST_CROP = 1024
POST_WARP_CROP = 512
POST_REPS = 5
#: the SPCC field's session: the catalogue is an xp_sampled .cat (the
#: stars' spectra); eqcrop keeps the sky rectangle of pixels EQCROP_BOX
#: (x0, y0, x1, y1 as fractions of the side)
POST_SCRIPT = """requires 1.2.0
load post_spcc
subsky 2
save post_sky
spcc -catalog=post_xp.cat -limitmag=20
save post_cal
autostretch -linked
ght -D=2 -B=1 -SP=0.25 -HP=0.95 -human
asinh 5
rmgreen
satu 0.4 1
eqcrop {ra1} {dec1} {ra2} {dec2}
crop 8 8 {cw} {ch}
rotate 7.5
binxy 2
save post_final
"""
EQCROP_BOX = (0.0625, 0.0625, 0.9375, 0.9375)
#: the PCC field's session (the same stars coloured by their B−V, the
#: catalogue a CSV with a bv column)
PCC_SCRIPT = """requires 1.2.0
load post_pcc
subsky 2
save pcc_sky
pcc -catalog={catalog} -limitmag=20
save pcc_cal
bgneutralize
save pcc_final
"""
#: the GHT stretch types held on the card against the CPU and timed
#: (post_ops): (label, stretch type, B)
POST_GHT = [("linear", 0, 0.0), ("normal", 1, 2.0), ("normal B=-1", 1, -1.0),
            ("inverse", 2, 2.0), ("asinh", 3, 0.0), ("invasinh", 4, 0.0)]


def post_ops():
    """[(label, fn(x), bound)] of the elementwise device ops that the post
    phase holds against the CPU and times per SIZE² RGB image: the
    stretches, the GHT family in every colour model, the colour ops, the
    binning and the pcc / spcc apply, each with the bound of the CPU tests
    against the JAX package."""
    import torch

    from siril_tpu_torch.astrometry.pcc import gains_tensor
    from siril_tpu_torch.ops import colors as col
    from siril_tpu_torch.ops import geometry as geo
    from siril_tpu_torch.ops import stretch as st

    ops = [("mtf", lambda x: st.mtf(x, 0.1, 0.08, 1.0), 2e-6),
           ("invmtf", lambda x: torch.clamp(st.mtf_pseudoinverse(
               x, st.MTFParams(0.08, 0.1, 1.0)), 0.0, 1.0), 2e-6)]
    for label, stype, B in POST_GHT:
        p = st.GHTParams(B=B, D=3.0, LP=0.02, SP=0.12, HP=0.9, BP=0.05,
                         stretchtype=stype)
        ops.append((f"ght {label}", lambda x, p=p: st.ght_colour(x, p),
                    1e-5))
    for label, model in (("human", st.COL_HUMANLUM),
                         ("even", st.COL_EVENLUM), ("sat", st.COL_SAT)):
        p = st.GHTParams(B=2.0, D=3.0, SP=0.12, payne_colourstretchmodel=model)
        ops.append((f"ght normal -{label}",
                    lambda x, p=p: st.ght_colour(x, p), 1e-5))
    m = [1.1, -0.05, -0.05, -0.1, 1.2, -0.1, 0.0, -0.1, 1.1]
    ops += [("asinh", lambda x: st.asinh_tensor(x, 20.0, 0.01), 2e-6),
            ("scnr", lambda x: col.scnr_tensor(x), 2e-6),
            ("satu", lambda x: col.saturation_tensor(x, 0.5, 0.11), 1e-5),
            ("ccm", lambda x: col.ccm_tensor(x, m, 2.2), 2e-6),
            ("neg", lambda x: 1.0 - x, 0.0),
            ("binxy 2", lambda x: geo.bin_tensor(x, 2), 1.2e-7),
            ("pcc/spcc apply", lambda x: gains_tensor(
                x, [0.66, 1.0, 1.42], [0.01, 0.0, -0.02]), 0.0)]
    return ops


def synth_post(root: str, seed: int, size: int, nstars: int = POST_STARS):
    """The post phase's two stacked RGB fields (float32 FITS with the
    scene's TAN WCS, ``sky_wcs``) and their catalogues: ``post_spcc`` (each
    star's colour its spectrum through the built-in R, G, B curves, the
    spectra in the xp_sampled ``post_xp.cat``) and ``post_pcc`` (the same
    stars, sky and noise, each star's colour ``bv_to_rgb`` of its B−V, in
    ``post_bv.csv`` and ``post_bv.npz``), both × POST_IMBALANCE.  Written
    on the writer threads.  Returns the truth."""
    import numpy as np

    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.gaia_local import write_gaia_xpsamp
    from siril_tpu_torch.astrometry.pcc import bv_to_rgb
    from siril_tpu_torch.astrometry.spcc import WL, ResponseLibrary
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import write_fits

    rng = np.random.default_rng(seed)
    m = 48
    sx = rng.uniform(m, size - m, nstars)
    sy = rng.uniform(m, size - m, nstars)
    amp = np.minimum(0.05 + 0.02 * rng.pareto(1.5, nstars), 0.5)
    w = sky_wcs(size)
    ra, dec = w.pix2world(sx, sy)
    # spectra: flat SEDs with red / blue slopes, and their G-relative
    # colours through the generic camera
    slope = rng.uniform(-0.5, 0.5, nstars)
    flux = np.clip(1e-16 * (1.0 + slope[:, None] * ((WL - 650.0) / 350.0)),
                   1e-18, None)
    lib = ResponseLibrary()
    qe = lib.get("generic_qe").resampled()
    photon = flux * WL[None, :]
    true = np.stack([np.trapezoid(photon * lib.get(f).resampled() * qe, WL,
                                  axis=1) for f in ("R", "G", "B")])
    spcc_col = true / true[1]
    bv = rng.uniform(0.0, 1.2, nstars)
    pcc_col = np.stack([bv_to_rgb(b) for b in bv], axis=1)
    imb = np.asarray(POST_IMBALANCE)
    yy = (np.arange(size, dtype=np.float32) / size - 0.45)[:, None]
    xx = (np.arange(size, dtype=np.float32) / size - 0.6)[None, :]
    # quadratic, POST_GRADIENT of the sky from its lowest to its highest
    q = xx * xx + 0.6 * yy * yy + 0.4 * xx * yy
    q = (q - q.min()) / (q.max() - q.min())
    made = dict(sx=sx, sy=sy, amp=amp, ra=ra, dec=dec, size=size)
    for name, col in (("post_spcc", spcc_col), ("post_pcc", pcc_col)):
        crng = np.random.default_rng(seed + 1)      # the same noise
        data = np.empty((3, size, size), np.float32)
        for c in range(3):
            sky = POST_SKY * (1.0 + POST_GRADIENT * q) * (0.9 + 0.1 * c)
            data[c] = _render(size, 0.0, sx, sy, amp * col[c] * imb[c],
                              POST_PSF) + sky
            data[c] += crng.standard_normal((size, size), np.float32) \
                * np.float32(POST_NOISE)
        img = SirilImage(data=np.clip(data, 0.0, 1.0), wcs=w)
        write_later(write_fits, img, os.path.join(root, name + ".fit"),
                    bitdepth=-32)
        made[name] = img.data
    mag = star_mags(amp)
    write_gaia_xpsamp(os.path.join(root, "post_xp.cat"), ra, dec, mag, flux)
    with open(os.path.join(root, "post_bv.csv"), "w") as f:
        f.write("ra,dec,mag,bv\n")
        for row in zip(ra, dec, mag, bv):
            f.write("%r,%r,%r,%r\n" % tuple(float(v) for v in row))
    Catalog(ra=ra, dec=dec, mag=mag, bv=bv).save(
        os.path.join(root, "post_bv.npz"))
    b = EQCROP_BOX
    (ra1, ra2), (dec1, dec2) = w.pix2world(np.array([b[0], b[2]]) * size,
                                           np.array([b[1], b[3]]) * size)
    cw = int(round((b[2] - b[0]) * size)) - 16
    made["crop_side"] = cw
    made["script"] = POST_SCRIPT.format(ra1=repr(float(ra1)),
                                        dec1=repr(float(dec1)),
                                        ra2=repr(float(ra2)),
                                        dec2=repr(float(dec2)), cw=cw, ch=cw)
    return made


def tile_medians(layer, tiles: int = 0):
    """The medians of a tiles × tiles grid (POST_TILES) over every 2nd
    pixel of the layer in each direction (at 4096², 16384 a tile: the
    noise's share of a median ≈ 3e-5, a thirtieth of σ/3)."""
    import numpy as np

    tiles = tiles or POST_TILES
    layer = layer[::2, ::2]
    h, w = layer.shape
    th, tw = h // tiles, w // tiles
    t = layer[:th * tiles, :tw * tiles].reshape(tiles, th, tiles, tw)
    return np.median(t.transpose(0, 2, 1, 3).reshape(tiles, tiles, -1),
                     axis=-1)


def post_gains(before, after, made, n: int = 200):
    """The G-relative gains that took ``before`` to ``after``: on the n
    brightest stars at least 64 px inside, each channel's peak above the
    layer's median after over before, the median over the stars."""
    import numpy as np

    size = made["size"]
    sx, sy, amp = made["sx"], made["sy"], made["amp"]
    ok = (sx > 64) & (sx < size - 64) & (sy > 64) & (sy < size - 64)
    idx = np.nonzero(ok)[0]
    idx = idx[np.argsort(amp[idx])[::-1][:n]]
    xi, yi = np.floor(sx[idx]).astype(int), np.floor(sy[idx]).astype(int)
    k = []
    for c in range(3):
        # the sky level from every 4th pixel in each direction
        pin = before[c, yi, xi] - np.median(before[c, ::4, ::4])
        pout = after[c, yi, xi] - np.median(after[c, ::4, ::4])
        k.append(float(np.median(pout / pin)))
    return np.array(k) / k[1]


def post_vs_cpu(image, crop_size: int, warp_crop: int, reps: int):
    """Every device op of post_ops on the card against the CPU on the
    centre crop_size² of ``image`` (3, S, S) (the rotation and the
    background models on the centre warp_crop²), and its ms on the whole
    image (CUDA events, median of ``reps``); the RBF's peak device memory.
    Returns rows."""
    import numpy as np
    import torch

    from siril_tpu_torch.ops import background as bg
    from siril_tpu_torch.ops import geometry as geo
    from siril_tpu_torch.ops.interp import INTERP_LANCZOS4

    def centre(c):
        c0 = (S - c) // 2
        return np.ascontiguousarray(image[:, c0:c0 + c, c0:c0 + c])

    rows = []
    S = image.shape[-1]
    full = torch.from_numpy(image).cuda()
    crop = centre(crop_size)
    xc, xh = torch.from_numpy(crop).cuda(), torch.from_numpy(crop)
    for label, fn, bound in post_ops():
        got = fn(xc).cpu().numpy()
        want = fn(xh).numpy()
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        ms = _events_ms(lambda: fn(full), reps)
        rows.append(dict(op=label, max_abs_err=err, bound=bound, ms=ms))
        log(f"    {label}: card vs cpu max|Δ| {err:.3g} (bound {bound:g}), "
            f"{ms:.3f} ms per {S}² RGB image")
        if not err <= bound:
            raise SystemExit(f"post: {label} on the card is {err} from the "
                             f"CPU (bound {bound})")
    # the rotate command's warp (lanczos4 with its clamp): a last-bit
    # difference may flip the clamp's test on a few pixels (the SIP warp's
    # SIP_CLAMP_FLIPS); the warp without the clamp is within 2e-6
    small = centre(warp_crop)
    for clamp in (False, True):
        got = geo.rotate_tensor(torch.from_numpy(small).cuda(), 7.5,
                                INTERP_LANCZOS4, True, clamp).cpu()
        want = geo.rotate_tensor(torch.from_numpy(small), 7.5,
                                 INTERP_LANCZOS4, True, clamp)
        off = (got - want).abs() > 2e-6
        flips = float(off.float().mean())
        ms = _events_ms(lambda: geo.rotate_tensor(
            full, 7.5, INTERP_LANCZOS4, True, clamp), max(reps - 2, 1))
        label = f"rotate 7.5° (lanczos4, {'clamp' if clamp else 'no clamp'})"
        rows.append(dict(op=label, max_abs_err=float(
            (got - want).abs().max()), flips=flips, bound=2e-6, ms=ms))
        log(f"    {label}: card vs cpu max|Δ| "
            f"{float((got - want).abs().max()):.3g}, {int(off.sum())} px "
            f"past 2e-6 ({flips:.2g} of the crop, allowed "
            f"{SIP_CLAMP_FLIPS if clamp else 0:g}), {ms:.3f} ms per {S}² "
            "RGB image")
        if flips > (SIP_CLAMP_FLIPS if clamp else 0.0):
            raise SystemExit(f"post: {label} is off the CPU on {flips} of "
                             "the crop")
    # the background models: fit on the host, evaluated on each device
    samples = bg.generate_samples(small[1], 20, 1.0)
    fsamples = bg.generate_samples(image[1], 20, 1.0)
    for label, fn in (("subsky poly 2 model", lambda s, shp, d:
                       bg.compute_background_poly(s, shp, 2, d)),
                      ("subsky RBF model", lambda s, shp, d:
                       bg.compute_background_rbf(s, shp, 0.5, d))):
        shape = (warp_crop, warp_crop)
        got = fn(samples, shape, "cuda").cpu().numpy()
        want = fn(samples, shape, "cpu").numpy()
        err = float(np.max(np.abs(got - want)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _events_ms(lambda: fn(fsamples, (S, S), "cuda"), reps)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        rows.append(dict(op=label, max_abs_err=err, bound=1e-5, ms=ms,
                         peak_mib=peak))
        log(f"    {label}: card vs cpu max|Δ| {err:.3g} (bound 1e-5), "
            f"{ms:.3f} ms a {S}² layer, peak {peak:.0f} MiB beyond "
            f"the image ({sum(s.valid for s in fsamples)} samples)")
        if not err <= 1e-5:
            raise SystemExit(f"post: {label} on the card is {err} from the "
                             "CPU")
    del full
    torch.cuda.empty_cache()
    return rows


def phase_post(seed: int, tmp: str, size: int = SIZE):
    """The post-stack colour session through the CLI's -s entry on two
    stacked SIZE² RGB fields (synth_post): POST_SCRIPT (subsky 2, spcc on
    an xp_sampled catalogue, autostretch, ght, asinh, rmgreen, satu,
    eqcrop, crop, rotate, binxy, save) and PCC_SCRIPT (subsky 2, pcc on a
    CSV with B−V, bgneutralize, save); the gradient left after subsky, the
    gains of spcc and pcc against the imbalance, bgneutralize's medians,
    the final image's shape; then every device op on the card against
    the CPU on a POST_CROP² crop (the rotation and the background models
    on a POST_WARP_CROP² one), and its ms per SIZE² RGB image.  The
    fields stay in ``tmp`` for the enhance phase.  Returns (rows of the
    commands, rows of the ops, the truth of synth_post)."""
    import numpy as np

    from siril_tpu_torch import cli
    from siril_tpu_torch.astrometry.pcc import layer_median
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.statistics import per_layer

    t = time.perf_counter()
    made = synth_post(tmp, seed + 53, size, POST_STARS)
    writes_done()
    log(f"  rendered two {size}² RGB fields of {POST_STARS} stars and "
        f"their catalogues in {time.perf_counter() - t:.2f}s")
    with open(os.path.join(tmp, "post.ssf"), "w") as f:
        f.write(made["script"])
    with open(os.path.join(tmp, "pcc.ssf"), "w") as f:
        f.write(PCC_SCRIPT.format(catalog="post_bv.csv"))
    rows = {}
    for script in ("post.ssf", "pcc.ssf"):
        t = time.perf_counter()
        session = cli.run(["-d", tmp, "-s", os.path.join(tmp, script)])
        log(f"  {script}: {time.perf_counter() - t:.2f}s")
        for row in session.command_log:
            rows[f"{script}: {row['command']}"] = row
            log(f"    {row['command']}: {row['seconds']:.3f}s" + (
                " (" + ", ".join(f"{k} {v:.3f}s" for k, v in
                                 row["stages"].items()) + ")"
                if row["stages"] else ""))
    files = {n: read_fits(os.path.join(tmp, n + ".fit")).data
             for n in ("post_sky", "post_cal", "pcc_sky", "pcc_cal",
                       "pcc_final", "post_final")}
    sd = POST_NOISE
    for name, src in (("post_sky", "post_spcc"), ("pcc_sky", "post_pcc")):
        for c in range(3):
            before = np.ptp(tile_medians(made[src][c]))
            after = np.ptp(tile_medians(files[name][c]))
            log(f"  {name} layer {c}: gradient {before:.5f} → "
                f"{after:.6f} (bound {sd / 3:.5f})")
            if not after < sd / 3:
                raise SystemExit(f"post: subsky left {after} in {name}")
    for label, a, b in (("spcc", "post_sky", "post_cal"),
                        ("pcc", "pcc_sky", "pcc_cal")):
        g = post_gains(files[a], files[b], made)
        want = 1.0 / np.asarray(POST_IMBALANCE)
        err = np.abs(g / want - 1.0)
        log(f"  {label}: gains R/G {g[0]:.4f} B/G {g[2]:.4f} against "
            f"{want[0]:.4f} / {want[2]:.4f} (off {err[0]:.4f}, "
            f"{err[2]:.4f}; bound {POST_GAIN_TOL})")
        if not err.max() <= POST_GAIN_TOL:
            raise SystemExit(f"post: {label} gains {g} off {want}")
    meds = per_layer(layer_median, files["pcc_final"])
    log(f"  bgneutralize: medians {meds}")
    if np.ptp(meds) > 1e-5:
        raise SystemExit(f"post: bgneutralize left medians {meds}")
    # eqcrop's box, 8 px off each side, turned in place, binned by 2
    # (the lanczos warp may ring a little past 1, as in the reference)
    fin = files["post_final"]
    side = made["crop_side"] // 2
    if fin.shape != (3, side, side) or not np.isfinite(fin).all():
        raise SystemExit(f"post: the final image is {fin.shape}, "
                         f"[{fin.min()}, {fin.max()}]")
    log(f"  final image {fin.shape}, median {np.median(fin):.4f}")
    ops = post_vs_cpu(files["post_sky"], min(POST_CROP, size),
                      min(POST_WARP_CROP, size), POST_REPS)
    log("post: " + json.dumps(dict(commands={
        k: dict(seconds=v["seconds"], stages=v["stages"])
        for k, v in rows.items()}, ops=ops)))
    for name in ("post_spcc", "post_pcc"):
        del made[name]
    return rows, ops, made


#: the enhancement session on the post phase's colour-calibrated field
#: (post_cal: 4096² RGB, POST_STARS stars of σ POST_PSF, noise
#: POST_NOISE), in the order a user works on a linear stack; the saves
#: are the checks' inputs
ENHANCE_SCRIPT = """requires 1.2.0
load post_cal
makepsf stars
rl
save enh_rl
denoise
save enh_dn
mask_from_stars
mask_blur 2
unsharp 1.5 1.6
save enh_us
clear_mask
wavelet 5
wrecons 1.3 1.2 1 1 1
epf -guided
fmedian 3 1
clahe 2 8
pm "$T * 0.9 + 0.01"
save enh_pm
fftd fmod fphase
ffti fmod fphase
save enh_final
"""
#: the checks: the ENHANCE_STARS brightest isolated stars; rl narrows
#: their median FWHM by RL_NARROWING at least, rl and denoise keep their
#: fluxes within FLUX_TOL, denoise halves each layer's background noise
ENHANCE_STARS = 200
RL_NARROWING = 0.15
FLUX_TOL = 0.05
#: the card-against-CPU crops (the pointwise and convolution ops; the
#: denoisers, whose CPU side is the phase's slowest part), the layer on
#: which denoise -da3d, -sos=1 and the blind engines are timed, and the
#: timing reps
ENHANCE_CROP = 256
ENHANCE_DENOISE_CROP = 128
ENHANCE_LAYER = 1024
ENHANCE_REPS = 3
#: the ops whose full-size figure is their command's wall in the session
#: (not run again at SIZE²)
IN_SESSION = ("rl 20", "epf -guided", "fmedian 3", "clahe 2 8",
              "wavelet 5 + wrecons")


def enhance_ops():
    """[(label, fn(x), bound)] of the enhancement session's device ops on
    a (3, S, S) tensor, each with its card-against-CPU bound: 0 for a
    selection or exact float64 arithmetic, 1e-6 for float32 convolutions
    and pointwise ops (one rounding of an exp, an FMA the card contracts),
    1e-5 for the FFT ops and rgradient's gather at coordinates from
    atan2 / sin / cos."""
    import numpy as np
    import torch

    from siril_tpu_torch.ops import arithmetic as ar
    from siril_tpu_torch.ops import curves as cu
    from siril_tpu_torch.ops import deconvolution as dc
    from siril_tpu_torch.ops import filters as ft
    from siril_tpu_torch.ops import wavelets as wv
    from siril_tpu_torch.ops.pixelmath import evaluate

    psf = dc.make_psf(dc.PSF_GAUSSIAN, 15, 3.5)
    lut = cu.build_curve_lut([(0.0, 0.0), (0.2, 0.35), (0.7, 0.8),
                              (1.0, 1.0)])

    def fft_coefs(x):
        modn, phase, _ = ft.fftd_tensor(x)
        return torch.view_as_real(torch.polar(modn, 2 * np.pi * phase))

    def fft_round(x):
        modn, phase, mx = ft.fftd_tensor(x)
        return ft.ffti_tensor(modn, phase, mx.reshape(-1).cpu().numpy())

    return [
        ("gauss 1.5", lambda x: ft.gaussian_blur_chw(x, 1.5), 1e-6),
        ("unsharp 1.5 1.6", lambda x: torch.clamp(
            1.6 * x - 0.6 * ft.gaussian_blur_chw(x, 1.5), 0.0, 1.0), 1e-6),
        ("ddp 0.05 0.3 1.2", lambda x: ft.ddp_tensor(x, 0.05, 0.3, 1.2),
         1e-6),
        ("fmedian 3", lambda x: ft.median_blocks(x, 3), 0.0),
        ("fmedian 5", lambda x: ft.median_blocks(x, 5), 0.0),
        ("epf (bilateral d=5)", lambda x: ft.bilateral_tensor(x, x), 1e-6),
        ("epf -guided", lambda x: ft.guided_tensor(x, x, 8, 0.01), 1e-6),
        ("clahe 2 8", lambda x: ft.clahe_tensor(x, 2.0, 8), 0.0),
        ("wavelet 5 + wrecons", lambda x: torch.clamp(
            wv.atrous_reconstruct(wv.atrous_decompose(x, 5),
                                  [1.3, 1.2, 1.0, 1.0, 1.0]), 0.0, 1.0),
         1e-6),
        ("seqatrous 4 (wavelet denoise)",
         lambda x: wv.wavelet_denoise_tensor(x, 4), 1e-6),
        ("unpurple", lambda x: ft.unpurple_tensor(x, 0.05, 0.8), 0.0),
        ("rgradient", lambda x: ft.rgradient_tensor(
            x, x.shape[-1] / 2 + 0.5, x.shape[-2] / 2, 3.0, 5.0), 1e-5),
        ("fftd (coefficients)", fft_coefs, 1e-5),
        ("fftd + ffti", fft_round, 1e-5),
        ("rl 20", lambda x: dc.richardson_lucy_tensor(x, psf, 20), 1e-5),
        ("wiener", lambda x: dc.wiener_tensor(x, psf), 1e-5),
        ("sb 10", lambda x: dc.split_bregman_tensor(x, psf), 1e-5),
        ("pm $T * 0.9 + 0.01", lambda x: torch.clamp(
            evaluate("T * 0.9 + 0.01", {"T": x}), 0.0, 1.0), 1e-6),
        ("pm iif(T > median(T), sqrt(T), T ^ 2)", lambda x: evaluate(
            "iif(T > median(T), sqrt(T), T ^ 2)", {"T": x}), 1e-6),
        ("idiv (clip16)", lambda x: ar.imoper(x, x.flip(-1), ar.OPER_DIV,
                                              clip16=True), 0.0),
        ("fmul 1.3", lambda x: ar.soper(x, 1.3, ar.OPER_MUL), 0.0),
        ("curve (cubic)", lambda x: cu.apply_lut(x, lut), 0.0),
    ]


def _isolated_bright(made, size: int, n: int):
    """Indices of the stars at least 64 px inside with no other star
    within 16 px, brightest first."""
    import numpy as np
    from scipy.spatial import cKDTree

    sx, sy = made["sx"], made["sy"]
    pts = np.stack([sx, sy], axis=1)
    d, _ = cKDTree(pts).query(pts, k=2)
    ok = (d[:, 1] > 16.0) & (sx > 64) & (sx < size - 64) & (sy > 64) & \
        (sy < size - 64)
    idx = np.nonzero(ok)[0]
    return idx[np.argsort(made["amp"][idx])[::-1]][:n]


def _fwhm_at(layer, xs, ys):
    """The star finder's FWHM (the mean of x and y) of the star nearest
    each (x, y) within 1.5 px, NaN where none is found."""
    import numpy as np
    import torch

    from siril_tpu_torch.registration.starfinder import detect_stars

    stars = detect_stars(torch.from_numpy(np.ascontiguousarray(
        layer)).to(CARD))
    sx = np.array([s.x0 for s in stars])
    sy = np.array([s.y0 for s in stars])
    fw = np.array([0.5 * (s.fwhmx + s.fwhmy) for s in stars])
    out = np.full(len(xs), np.nan)
    for i, (x, y) in enumerate(zip(xs, ys)):
        d = np.hypot(sx - x, sy - y)
        j = int(np.argmin(d)) if len(d) else -1
        if j >= 0 and d[j] <= 1.5:
            out[i] = fw[j]
    return out


def _sky_fluxes(img, xs, ys, half: int = 10):
    """Per star, per layer: the sum over a (2·half+1)² box of ``img`` (C,
    H, W) less the layer's sky (the median of every 4th pixel in each
    direction; the field is flat after subsky) over the box.  A sky from
    the box's edge, as _star_fluxes takes it, reads rl's amplified noise
    near a star as sky."""
    import numpy as np

    sky = np.median(img[:, ::4, ::4], axis=(1, 2))
    n = (2 * half + 1) ** 2
    return np.stack([img[:, y - half:y + half + 1,
                         x - half:x + half + 1].sum(axis=(1, 2)) - sky * n
                     for x, y in zip(xs, ys)])


def enhance_checks(made, files, size: int) -> dict:
    """rl narrows the stars and keeps their fluxes, denoise halves the
    background noise and keeps the fluxes, the masked unsharp leaves the
    pixels outside the mask as they were, fftd → ffti returns its input.
    Returns the figures."""
    import numpy as np

    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops.masks import mask_blur, mask_from_stars
    import torch

    from siril_tpu_torch.ops.statistics import bgnoise

    cal, rl, dn = files["post_cal"], files["enh_rl"], files["enh_dn"]
    idx = _isolated_bright(made, size, 3 * ENHANCE_STARS)
    xi = np.floor(made["sx"][idx]).astype(int)
    yi = np.floor(made["sy"][idx]).astype(int)
    peak = np.array([rl[:, y - 2:y + 3, x - 2:x + 3].max()
                     for x, y in zip(xi, yi)])
    xs, ys = made["sx"][idx], made["sy"][idx]
    f0 = _fwhm_at(cal[1], xs, ys)
    f1 = _fwhm_at(rl[1], xs, ys)
    keep = (peak < 0.95) & np.isfinite(f0) & np.isfinite(f1)
    sel = np.nonzero(keep)[0][:ENHANCE_STARS]
    if len(sel) < ENHANCE_STARS // 2:
        raise SystemExit(f"enhance: only {len(sel)} stars to measure")
    w0, w1 = float(np.median(f0[sel])), float(np.median(f1[sel]))
    narrowing = 1.0 - w1 / w0
    flux = {n: _sky_fluxes(files[n], xi[sel], yi[sel])
            for n in ("post_cal", "enh_rl", "enh_dn")}
    rl_flux = np.median(flux["enh_rl"] / flux["post_cal"], axis=0)
    dn_flux = np.median(flux["enh_dn"] / flux["enh_rl"], axis=0)
    # the background noise on the card (statistics.bgnoise, bgnoise_np's
    # dense path)
    noise_rl, noise_dn = (np.array([bgnoise(torch.from_numpy(x).to(CARD))
                                    for x in a]) for a in (rl, dn))
    log(f"  rl: median FWHM of {len(sel)} stars {w0:.3f} → {w1:.3f} px "
        f"(narrower by {narrowing:.3f}; bound {RL_NARROWING}), fluxes × "
        f"{np.round(rl_flux, 4).tolist()} (bound ±{FLUX_TOL})")
    log(f"  denoise: bgnoise {np.round(noise_rl, 6).tolist()} → "
        f"{np.round(noise_dn, 6).tolist()} (bound half), fluxes × "
        f"{np.round(dn_flux, 4).tolist()}")
    if not narrowing >= RL_NARROWING:
        raise SystemExit(f"enhance: rl narrowed the stars by {narrowing}")
    if not (np.abs(rl_flux - 1.0).max() <= FLUX_TOL
            and np.abs(dn_flux - 1.0).max() <= FLUX_TOL):
        raise SystemExit(f"enhance: fluxes {rl_flux} {dn_flux}")
    if not (noise_dn <= 0.5 * noise_rl).all():
        raise SystemExit(f"enhance: denoise left {noise_dn} of {noise_rl}")
    # the unsharp's mask, made again from the same image on the card
    mask = mask_blur(mask_from_stars(SirilImage(data=dn), device=CARD),
                     2.0, device=CARD)
    zero = mask == 0.0
    same = bool(np.array_equal(files["enh_us"][:, zero], dn[:, zero]))
    moved = float(np.abs(files["enh_us"] - dn).max())
    log(f"  masked unsharp: the mask is 0 on {zero.mean():.3f} of the "
        f"image, bit-equal there: {same}; elsewhere up to {moved:.4f}")
    if not (same and zero.mean() > 0.5 and moved > 0.0):
        raise SystemExit("enhance: the masked unsharp changed pixels "
                         "outside its mask")
    fft_err = float(np.abs(files["enh_final"].astype(np.float64)
                           - files["enh_pm"]).max())
    log(f"  fftd → ffti: max|Δ| {fft_err:.3g} (bound 1e-5)")
    if not fft_err <= 1e-5:
        raise SystemExit(f"enhance: fftd → ffti is {fft_err} off")
    return dict(stars=len(sel), fwhm=(w0, w1), narrowing=narrowing,
                rl_flux=rl_flux.tolist(), dn_flux=dn_flux.tolist(),
                bgnoise=(noise_rl.tolist(), noise_dn.tolist()),
                mask_zero=float(zero.mean()), fft_err=fft_err)


def _peak_ms(fn, reps: int):
    """(ms, peak MiB beyond what was allocated before) of ``fn()``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = _events_ms(fn, reps)
    return ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def enhance_vs_cpu(image, crop: int, dn_crop: int, layer: int, reps: int):
    """Every op of enhance_ops on the card against the CPU on the centre
    crop² of ``image`` (3, S, S) and its ms on the whole image (CUDA
    events, median of ``reps``) but for the session's own; the median
    filter's peak at k = 5 and 9; NL-Bayes (and DA3D on its result) on
    a dn_crop² layer on both devices, by their effect; the ℓ0 and HIO
    steps; denoise -da3d, -sos=1 and the two blind engines timed on a
    layer² layer.  Returns rows."""
    import numpy as np
    import torch

    from siril_tpu_torch.ops import blind_deconv as bd
    from siril_tpu_torch.ops import filters as ft
    from siril_tpu_torch.ops.da3d import da3d, da3d_patches
    from siril_tpu_torch.ops.nlbayes import estimate_noise_sigma, \
        nlbayes_tensor

    S = image.shape[-1]

    def centre(a, c):
        c0 = (S - c) // 2
        return np.ascontiguousarray(a[..., c0:c0 + c, c0:c0 + c])

    rows = []
    full = torch.from_numpy(image).cuda()
    xh = torch.from_numpy(centre(image, crop))
    xc = xh.cuda()
    for label, fn, bound in enhance_ops():
        got = fn(xc).cpu().numpy().astype(np.float64)
        err = float(np.max(np.abs(got - fn(xh).numpy())))
        row = dict(op=label, max_abs_err=err, bound=bound)
        if label not in IN_SESSION:
            row["ms"], row["peak_mib"] = _peak_ms(lambda: fn(full), reps)
        rows.append(row)
        log(f"    {label}: card vs cpu max|Δ| {err:.3g} (bound {bound:g})"
            + (f", {row['ms']:.3f} ms per {S}² RGB image, peak "
               f"{row['peak_mib']:.0f} MiB" if "ms" in row else ""))
        if not err <= bound:
            raise SystemExit(f"enhance: {label} on the card is {err} from "
                             f"the CPU (bound {bound})")
    ms, peak = _peak_ms(lambda: ft.median_blocks(full, 9), 1)
    rows.append(dict(op="fmedian 9", ms=ms, peak_mib=peak))
    log(f"    fmedian 9: {ms:.1f} ms per {S}² RGB image, peak {peak:.0f} "
        "MiB")
    # NL-Bayes on a small layer on both devices: the same result by its
    # effect (the first pass's solve and the atomics, tests/
    # test_torch_denoise.py), and DA3D on that result
    lay = centre(image[1], dn_crop)
    s = estimate_noise_sigma(lay)
    dh = nlbayes_tensor(torch.from_numpy(lay), s)
    dc_ = nlbayes_tensor(torch.from_numpy(lay).cuda(), s).cpu()
    mean_d = float((dh - dc_).abs().mean())
    xl = torch.from_numpy(lay)
    nh, nc = float((xl - dh).std()), float((xl - dc_).std())
    log(f"    NL-Bayes {dn_crop}²: card vs cpu mean|Δ| {mean_d:.3g} (bound "
        f"5e-3), the noise removed (std of input − output) {nc:.3g} / "
        f"{nh:.3g} (bound ±5 %)")
    if not (mean_d <= 5e-3 and abs(nc / nh - 1.0) <= 0.05):
        raise SystemExit("enhance: NL-Bayes on the card is off the CPU")
    rh = da3d(lay, dh.numpy(), s, device="cpu")
    rc = da3d(lay, dh.numpy(), s, device=CARD).cpu()
    d3 = (rh - rc).abs()
    log(f"    DA3D {dn_crop}²: card vs cpu mean|Δ| {float(d3.mean()):.3g} "
        f"(bound 1e-5), max {float(d3.max()):.3g} (bound 1e-3)")
    if not (float(d3.mean()) <= 1e-5 and float(d3.max()) <= 1e-3):
        raise SystemExit("enhance: DA3D on the card is off the CPU")
    rows.append(dict(op=f"denoise {dn_crop}² layer", mean_abs_err=mean_d,
                     removed_std=(nc, nh)))
    rows.append(dict(op=f"da3d {dn_crop}² layer",
                     mean_abs_err=float(d3.mean()),
                     max_abs_err=float(d3.max())))
    # one step of each blind engine's iteration, and the DA3D patch step
    v = centre(image[1], 256)
    vt = torch.from_numpy(v)
    k = bd._kernel_cleanup(bd.l0_k_update(vt, vt, 20.0, 15).numpy())
    otf = bd._psf2otf_np(k, v.shape)
    got = bd.l0_u_update(vt.cuda(), bd._c64(otf, CARD), 6.0, 6e4).cpu()
    want = bd.l0_u_update(vt, bd._c64(otf, "cpu"), 6.0, 6e4)
    g = torch.from_numpy(np.random.default_rng(3).random(
        (60, 60)).astype(np.float32))
    mag = torch.fft.fft2(g).abs()
    sup = torch.zeros(60, 60, dtype=torch.bool)
    sup[:5, :5] = True
    hio = (bd.pr_step(g.cuda(), mag.cuda(), sup.cuda(), 0.9).cpu()
           - bd.pr_step(g, mag, sup, 0.9)).abs().max()
    py = torch.from_numpy(np.stack([v[i:i + 64, i:i + 64]
                                    for i in range(0, 160, 32)]))
    pc = da3d_patches(py.cuda(), py.cuda(), s, 31, 0.7, 14.0)[0].cpu()
    ph = da3d_patches(py, py, s, 31, 0.7, 14.0)[0]
    steps = dict(l0_step=float((got - want).abs().max()),
                 hio_step=float(hio), da3d_patch=float((pc - ph).abs().max()))
    log(f"    steps card vs cpu: {steps} (bounds 1e-5, 1e-6, 1e-5)")
    if not (steps["l0_step"] <= 1e-5 and steps["hio_step"] <= 1e-6
            and steps["da3d_patch"] <= 1e-5):
        raise SystemExit(f"enhance: a step on the card is off: {steps}")
    rows.append(dict(op="steps", **steps))
    # the options not in the session, timed once on one layer² layer
    big = torch.from_numpy(centre(image[1], layer)).cuda()
    sb = estimate_noise_sigma(centre(image[1], layer))
    base = nlbayes_tensor(big, sb)
    lay_np = big.cpu().numpy()
    for label, fn in (
            (f"denoise -da3d (the refinement) {layer}²",
             lambda: da3d(lay_np, base, sb, device=CARD)),
            (f"denoise -sos=1 {layer}²",
             lambda: nlbayes_tensor(big, sb, sos_iters=1)),
            (f"makepsf blind -l0 {layer}²",
             lambda: bd.estimate_kernel_blind(lay_np, 15, "l0",
                                              device=CARD)),
            (f"makepsf blind -si {layer}²",
             lambda: bd.estimate_kernel_blind(lay_np, 15, "si",
                                              device=CARD))):
        ms, peak = _peak_ms(fn, 1)
        rows.append(dict(op=label, ms=ms, peak_mib=peak))
        log(f"    {label}: {ms:.1f} ms, peak {peak:.0f} MiB")
    del full, big, base
    torch.cuda.empty_cache()
    return rows


def phase_enhance(seed: int, root: str, made: dict, size: int = SIZE):
    """The enhancement session (ENHANCE_SCRIPT) through the CLI's -s
    entry on the post phase's colour-calibrated field in its directory,
    each command's seconds, stages and peak device memory; the checks
    against the known scene (enhance_checks), ``wrecons 1 1 1 1 1`` on
    the session's planes; then every device op on the card against the
    CPU and timed (enhance_vs_cpu).  Returns (rows of the commands, rows
    of the ops)."""
    import numpy as np

    from siril_tpu_torch import cli
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.io.fits_io import read_fits

    with open(os.path.join(root, "enhance.ssf"), "w") as f:
        f.write(ENHANCE_SCRIPT)
    t = time.perf_counter()
    session = cli.run(["-d", root, "-s", os.path.join(root, "enhance.ssf")])
    log(f"  enhance.ssf: {time.perf_counter() - t:.2f}s")
    rows = {}
    for row in session.command_log:
        rows[row["command"]] = row
        log(f"    {row['command']}: {row['seconds']:.3f}s, peak "
            f"{row['peak_mib'] or 0:.0f} MiB" + (
                " (" + ", ".join(f"{k} {v:.3f}s" for k, v in
                                 row["stages"].items()) + ")"
                if row["stages"] else ""))
    files = {n: read_fits(os.path.join(root, n + ".fit")).data
             for n in ("post_cal", "enh_rl", "enh_dn", "enh_us", "enh_pm",
                       "enh_final")}
    checks = enhance_checks(made, files, size)
    took = np.array(session.wavelet_img.data)
    COMMANDS["wrecons"].fn(session, ["1"] * 5)
    err = float(np.abs(session.image.data.astype(np.float64) - took).max())
    log(f"  wrecons 1 1 1 1 1: max|Δ| {err:.3g} from the image wavelet took "
        "(bound 1e-6)")
    if not err <= 1e-6:
        raise SystemExit(f"enhance: wrecons 1 … 1 is {err} off")
    checks["wrecons_err"] = err
    del session, files["enh_rl"], files["enh_us"], files["enh_pm"]
    ops = enhance_vs_cpu(files["post_cal"], min(ENHANCE_CROP, size),
                         min(ENHANCE_DENOISE_CROP, size),
                         min(ENHANCE_LAYER, size), ENHANCE_REPS)
    log("enhance: " + json.dumps(dict(commands={
        k: dict(seconds=v["seconds"], stages=v["stages"],
                peak_mib=v["peak_mib"]) for k, v in rows.items()},
        checks=checks, ops=ops)))
    return rows, ops


STACK_RUNS = [("K1b", "rej a 3 3 -norm=addscale"),
              ("K1c", "rej l 3 3 -norm=addscale"),
              ("K1d", "rej g 0.3 0.05 -norm=addscale"),
              ("K1e", "rej w 3 3 -norm=addscale -weight_from_noise"),
              ("K1a", "rej w 3 3 -norm=addscale -rejmaps")]
#: the same on the 100-frame session: the column kernel
STACK100_RUNS = [("K1col", "rej w 3 3 -norm=addscale"),
                 ("K1col", "rej g 0.3 0.05 -norm=addscale")]


def phase_stack(seed: int, frames: int = FRAMES, size: int = SIZE,
                runs=STACK_RUNS):
    """The staged stack command on aligned float32 frames; returns
    ({variant: launches}, {command: {variant: launches}})."""
    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.kernels import reject_stack as k1

    t = time.perf_counter()
    scene, f32s, _, sigma_n, ray = synth_frames(seed + 7, frames, size,
                                                aligned=True)
    log(f"  synthesized {frames} aligned float32 frames of {size}x{size} "
        f"in {time.perf_counter() - t:.2f}s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stack_")
    launches = dict.fromkeys(k1.launches, 0)
    by_cmd = {}
    try:
        t = time.perf_counter()
        for i, f in enumerate(f32s):
            write_later(write_f32_fits,
                        os.path.join(tmp, f"r_light_{i + 1:05d}.fit"), f)
        writes_done()
        del f32s
        log(f"  wrote FITS in {time.perf_counter() - t:.2f}s")
        m = 48
        inner = np.s_[m:-m, m:-m]
        failed = []
        for var, cmd in runs:
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
            by_cmd[cmd] = counts
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
        return launches, by_cmd
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
    with Phase("k1col"):
        k1col = phase_k1col(args.seed)
    with Phase("warps"):
        phase_warps(args.seed)
    with Phase("fusedstack"):
        launches, stages, wall = phase_fusedstack(args.seed)
    with Phase("fusedstack_homography"):
        hom_launches, _, _, _ = phase_fusedstack_homography(args.seed)
    with Phase("stack"):
        stack_launches, _ = phase_stack(args.seed)
        _, stack100 = phase_stack(args.seed + 1, STACK100, SIZE100,
                                  STACK100_RUNS)
    # the script phase's directory stays for the drizzle and formats
    # phases, the osc phase's for the drizzle phase
    osc_root = tempfile.mkdtemp(prefix="chip_smoke_osc_")
    script_root = tempfile.mkdtemp(prefix="chip_smoke_script_")
    try:
        with Phase("script"):
            script_launches, _, _, night = phase_script(args.seed, osc_root,
                                                        script_root)
        with Phase("osc"):
            osc_launches, _, _, _, osc_made = phase_osc(args.seed, osc_root,
                                                        night)
        with Phase("drizzle"):
            drizzle_launches, _, _ = phase_drizzle(
                args.seed, osc_root, script_root, night, osc_made)
        del osc_made
        shutil.rmtree(osc_root, ignore_errors=True)
        with Phase("astrometry"):
            phase_astrometry(args.seed, script_root, night)
        del night
        with Phase("formats"):
            formats_launches, _, _ = phase_formats(args.seed, script_root)
    finally:
        shutil.rmtree(osc_root, ignore_errors=True)
        shutil.rmtree(script_root, ignore_errors=True)
    with Phase("mosaic"):
        mosaic_launches, _, _, mosaic_k1e = phase_mosaic(args.seed)
    # the post phase's directory stays for the enhance phase
    post_root = tempfile.mkdtemp(prefix="chip_smoke_post_")
    try:
        with Phase("post"):
            _, _, post_made = phase_post(args.seed, post_root)
        with Phase("enhance"):
            phase_enhance(args.seed, post_root, post_made)
    finally:
        shutil.rmtree(post_root, ignore_errors=True)
    src = "siril_tpu_torch/csrc/reject_stack.cu"
    tpu = "siril_tpu/pallas/reject_stack.py"
    # K1a runs on several paths: fusedstack (shifts and homographies), and
    # the script (its winsorized stacks) with the calibrated fusedstack
    # and the filtered stack, the OSC and Bayer-drizzle scripts, -upscale
    # and the formats phase's stacks; launches sums them
    by_path = {"fusedstack": launches,
               "fusedstack -transf=homography": hom_launches,
               **{p: c["K1a"] for p, c in script_launches.items()},
               "osc script": osc_launches["K1a"],
               **{p: c.get("K1a", 0) for p, c in {
                   **drizzle_launches, **formats_launches}.items()}}
    kernels = [dict(name="reject_stack (K1a)",
                    launches=sum(by_path.values()),
                    launches_by_path=by_path, replaces=f"{tpu}:763", **k1a)]
    lines = {"K1b": 478, "K1c": 521, "K1d": 586, "K1e": 719}
    # K1e: the noise-weighted stack, and the feathered stack of the
    # plate-solved mosaic's canvas
    k1e_paths = {"stack -weight_from_noise": stack_launches["K1e"],
                 "plate-solved mosaic -feather": sum(
                     c["K1e"] for c in mosaic_launches.values())}
    for var, *_ in STACK_VARIANTS:
        extra = dict(launches=stack_launches[var])
        if var == "K1e":
            extra = dict(launches=sum(k1e_paths.values()),
                         launches_by_path=k1e_paths,
                         other_sizes=mosaic_k1e)
        kernels.append(dict(name=f"reject_stack ({var})",
                            replaces=f"{tpu}:{lines[var]}", **extra,
                            **k1v[var]))
    # the column kernel: a row for each 100-frame stack command, at its
    # call size, with its launches; the winsorized row also carries the
    # other timing sizes, which no command launched
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    cmd_of = {"winsorized": STACK100_RUNS[0][1],
              "gesdt": STACK100_RUNS[1][1]}
    calls = [r for r in k1col if (r["n"], r["p"]) == (STACK100,
                                                      SIZE100 * SIZE100)]
    others = [dict(n=o["n"], p=o["p"], slice=o["slice"],
                   **{key: o[key] for key in keys})
              for o in k1col if o not in calls]
    for r in calls:
        kernels.append(dict(
            name=f"reject_stack (K1col {r['label']}, N={r['n']}, "
                 f"P={r['p']}; plain version on {r['slice']} pixels)",
            launches=stack100[cmd_of[r["label"]]]["K1col"],
            replaces=f"{tpu}:763", **r,
            **({"other_sizes": others} if r["label"] == "winsorized"
               else {})))
    report = {"kernels": [
        dict(name=k["name"], route="cuda", source=src,
             replaces=k["replaces"], launches=k["launches"],
             **{key: k[key] for key in keys}, library_ms=None,
             **{key: k[key] for key in ("other_sizes", "launches_by_path")
                if key in k})
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
