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
              full row block of the main path (N=FRAMES, P=682·SIZE; the
              plain version on 2^20 pixels spread over P, held_at_call)
              with the winsorized σ steps its pixels took, winsorized at
              N=64, P=2^20 (the column kernel), and winsorized at the
              masters' frame count (N=CALIB_FRAMES, P=2^20, both dtypes
              and all three normalizations; then int16 at the masters'
              call size, P=SIZE², without normalization and
              multiplicative, held_at_call), and at the stacks' full calls
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
              float32, held_at_call); and each of K1b-K1e
              at the stack command's call size (N=FRAMES, P=SIZE²,
              float32, additive+scaling; the plain version on 2^20 pixels
              spread over P, held_at_call), with its bound and, for K1b and
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
              GESDT), each held against the plain version on 2^14
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
  multidevice — a world-1 process group (NCCL for the card, gloo for
              the CPU's tensors; a FileStore rendezvous) and its meshes:
              the config-5 chain (``survey_platesolve_pcc_stack``) on
              SURVEY_FRAMES RGB frames of SURVEY_W × SURVEY_H (the IMX455)
              made on the card by its reader (a TAN-projected sky of
              SURVEY_STARS stars of known B−V through SURVEY_IMBALANCE, a
              gain and offset per frame, noise, hits), its rows per block
              those plan_survey_rows gives SURVEY_PLANNED frames on the
              card: the stack against the scene, the plate solution
              against the true WCS, the PCC gains against the imbalance,
              SURVEY_HELD of its K1 calls held against the plain version
              (held_at_call), the stages' seconds; then
              ``fused_pipeline_step`` on FRAMES 16-bit SIZE² frames,
              shifted (the separable route) and turned (the rotation
              rung), against the scene, its K1 call held against the
              plain version (held_at_call), and the card against the CPU
              on their FUSED_CROP² centre, the two K1 calls' per-pixel
              rejection counts there included;
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
  analysis — the analysis session (ANALYSIS_SCRIPT) through -s on
              ANALYSIS_LIGHTS 16-bit SIZE² lights rendered on the card
              (synth_analysis: the sky field through sky_wcs, shifts, DATE-OBS
              and WCS cards, an eclipsing target and constant comparison
              stars in a NINA CSV, hot and cold pixels, a satellite trail
              in one light) and a dark with hot pixels: convert,
              seqfind_cosme, seqstat, seqfindstar, seqpsf, light_curve
              -ninastars -aavso, seqsetmag, the sequence forms, then on one
              corrected light stat, bg, bgnoise, entropy, histo, cdg,
              findstar, psf, tilt, detect_streaks, synthstar, ssr, profile,
              the ICC commands, inspector, and find_hot → cosme on the
              dark; the light curve against the known one, the AAVSO JDs,
              every defect corrected, the trail found (and none in a light
              without one), find_hot's list, the ICC bytes read back; each
              device op on the card against the CPU on an ANALYSIS_CROP²
              crop, and ms per SIZE² frame of find_cosme, stat main,
              icc_convert_to, detect_streaks, synthstar and ssr.  No K1;
  planetary — the planetary session (PLANETARY_SCRIPT: seqquality,
              register_mpp, stack_mpp, mpp, rgbcomp -align) through -s on
              a mono 16-bit SER of PLANET_FRAMES PLANET_W × PLANET_H
              frames rendered on the card (planet_video: a banded,
              limb-darkened disc with spots, a known drift, a smooth local
              field, a seeing blur and noise, and three channels shifted
              by RGB_SHIFTS): seqquality against the known blur, the
              global and AP shifts against the drift and the field, the
              solves on the disc, mpp against the aligned mean (closer to
              the scene, sharper), register_mpp + stack_mpp equal to mpp,
              the channel shifts; the card against the CPU on
              PLANET_CPU_FRAMES frames of a PLANET_CROP² crop (quality,
              phase correlation, MLC on the same windows, the stack); ms
              per frame of the quality, the phase correlation, stage B
              and MLC, stage C.  No K1;
  formats — FORMATS_LIGHTS of the script phase's raw lights: convert
              -fitseq, convert -ser, link, and rej 3 3 stacks of the
              cube (bit-equal to the regular one's), the SER video
              (SER_MEAN_TOL, SER_FLIPS) and the files; a light as BITPIX
              8, 32 and -64; setcompress rice and gzip2, save, load; the
              C++ Rice coder's ms and bytes; a 4-frame fz sequence; the
              lights as an 8-bit uncompressed AVI, converted and stacked
              (bit-equal to the stack of the same frames as FITS); then
              RAW_LIGHTS camera-raw lights of each RAW_CONTAINERS at
              RAW_W × RAW_H (14-bit RGGB; ORF 12-bit packed), each read,
              all converted (every CFA value recovered through the
              reader's black and white), convert -debayer and convertraw
              -debayer of the NEF pair (the demosaic of the converted CFA
              frames); the native LJPEG, Nikon and Panasonic decoders
              bit-equal to the Python ones on DECODER_SIDE² streams of
              chip_smoke's encoders (the Python decoders in worker
              processes), and their MB/s; an RGB image through savetif,
              savetif8, savetif32, savebmp, savepnm (ROUND_SIZE²),
              savepng, savetif -deflate, XISF and .pic (ROUND_CROP²) and
              back, equal to to_u16 / to_u8, with ms per image;
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
              own.  No K1;
  live   — in the script phase's directory, after formats: start_ls
              -dark= -flat= with its masters (the dark with the bias), a
              thread dropping LIVE_DROPPED of LIVE_LIGHTS shifted 16-bit
              SIZE² lights into the watched directory, livestack <file>
              for the rest, stop_ls: the result against the scene, ms per
              frame; seqexport of EXPORT_FRAMES pp_light frames (a .seq
              with shifts) to each of EXPORT_FORMATS with -normalize
              -crop=, read back against the shifted frames (their
              normalization's estimators and coefficients from the card
              held against host_norm_estimators of two frames), and
              -format=mp4 (OpenCV, or the error naming cv2); then
              SEQCMD_SCRIPT through -s on SEQCMD_SIZE² float32 frames of
              the scene and two raw lights: load_seq, select, unselect,
              setref, getref, seqheader, sequpdate_key, seqgps, seqclean,
              merge, stackall (K1a once a sequence), calibrate_single
              against calibrate, mirrorx_single, jsonmetadata, load,
              dumpheader, update_key, parse, boxselect, gps, each result
              checked, and seqstarnet's refusal;
  session — last, the session surface at full width: the ``-p`` pipe
              driven in process (``cli.pipe_loop``) on SESSION_LIGHTS
              16-bit SIZE² lights made on the card and a SIZE² RGB
              image: setmem, get -a, load / mirrorx / undo / redo (ms per
              undo point), seqcrop (its ``progress:`` lines), fusedstack
              against the scene as the fusedstack phase checks, a stack
              cancelled at its first row block by the pipe's ``cancel``
              and the next command succeeding, pyscript (PYSCRIPT: the
              RGB image read and written back through shared memory, ms
              per crossing, a stack through ``siril.cmd``, no jax,
              siril_tpu or torch in the script's process), precompile
              finding the library built, each ``status:`` line; the
              compute probe's ladder (PROBE_STAGES, n = PROBE_N, SIZE²,
              PROBE_ITERS iterations), Mpix/s per stage, no stage failed,
              its K1a call held against the plain version
              (held_at_call); one fusedstack under the torch.profiler
              trace (``utils/trace``): the K1 kernel among its CUDA
              kernels and the device's busy share over the window.
Then a JSON line describing every kernel, the card line, and last the
result line.  Any failure exits non-zero without a result line.  The script
needs CUDA and the repository beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
# mirrors and saves the result, left out here); 16
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
               sighigh, work=None, **extra):
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
            capped=None if refs else capped_plain, **kw)), 1)
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
    # held on 2^20 columns spread over the block (the plain version over
    # all of it took 4.2 s)
    work = {}
    full = held_at_call("the main-path block", "winsorized/addscale",
                        block, sc, off, torch.ones_like(sc),
                        dict(rtype=rj.WINSORIZED, mode=ADDITIVE_SCALING,
                             siglow=3.0, sighigh=3.0), work_out=work)
    if not full["ok"]:
        failures.append("main-path block")
    log(f"  main-path block bound: {full['bytes'] / 1e6:.1f} MB → "
        f"{full['bytes_ms']:.4f} ms; {full['ops'] / 1e9:.2f} G float ops → "
        f"{full['ops_ms']:.4f} ms; kernel {full['ms']:.3f} ms = "
        f"{full['ms'] / full['bound_ms']:.2f}x the bound, plain "
        f"{full['plain_ms']:.1f} ms on {full['slice']} columns, no library "
        "call computes this function")
    log_steps("main-path block", work, full["slice"])
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
        r = held_at_call("the masters' call size", f"winsorized/{nname}",
                         rawm, sc8, off8, mul8,
                         dict(rtype=rj.WINSORIZED, mode=mode, siglow=3.0,
                              sighigh=3.0))
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


def held_at_call(label: str, what: str, x, sc, off, mul, kw: dict,
                 work_out=None, extra_bytes: int = 0) -> dict:
    """K1 (``what``: its rejection and normalization) on the (N, P) stack
    ``x`` with the keywords ``kw`` of a call (``weights`` (N, P) or
    (N, 1) among them for K1e): the kernel over all P pixels (CUDA
    events, median of 10), the plain version on 2^20 pixels in
    COLUMN_CHUNKS runs spread over P (each pixel's result depends on its
    own column only), bit-equal, and no loop stopped at its bound in
    either; the bound from the plain version's work scaled to P (the
    unscaled work into ``work_out``; ``extra_bytes``: a table the kernel
    reads, GESDT's λ)."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.stacking import reject_stack_plain

    n, p = x.shape
    dtype = "i16" if x.dtype == torch.int16 else "f32"
    capped0 = k1.capped_pixels()
    got = k1.reject_mean(x, sc, off, mul, **kw)
    capped_kernel = k1.capped_pixels() - capped0
    ms = _events_ms(lambda: k1.reject_mean(x, sc, off, mul, **kw), 10)
    idx = spread_slice(p, 1 << 20, COLUMN_CHUNKS, x.device)
    w = kw.get("weights")
    pkw = dict(kw)
    if w is not None and w.shape[1] == p:
        pkw["weights"] = w[:, idx].contiguous()
    work = {} if work_out is None else work_out
    refs = []
    capped_plain = torch.zeros((), dtype=torch.int64, device=x.device)
    plain = _events_ms(lambda: refs.append(reject_stack_plain(
        x[:, idx].contiguous(), sc, off, mul,
        work=None if refs else work,
        capped=None if refs else capped_plain, **pkw)), 1)
    ref = refs[0]
    capped_plain = int(capped_plain)
    nbad = int(((got[1][idx] != ref[1]) | (got[2][idx] != ref[2])).sum())
    err = float((got[0][idx] - ref[0]).abs().max())
    scaled = {key: work.get(key, 0) * p / idx.numel()
              for key in ("flops", "compares")}
    # the stack once, 3 coefficient vectors, 12 B per pixel out, and the
    # weights once
    nbytes = n * p * x.element_size() + 3 * n * 4 + p * 12 + (
        0 if w is None else w.numel() * w.element_size()) + extra_bytes
    r = dict(label=label, n=n, p=p, dtype=dtype, slice=int(idx.numel()),
             ms=ms, plain_ms=plain, max_abs_err=err, nbad=nbad,
             capped=capped_kernel + capped_plain,
             **_bound(nbytes, scaled))
    wtxt = ""
    if w is not None:
        # the weights that are 0, over the call and in the compared slice
        r.update(weights="per pixel" if w.shape[1] == p else "per frame",
                 zero_weights=int((w == 0).sum()),
                 zero_weights_compared=int((pkw["weights"] == 0).sum()))
        wtxt = (f", weights {r['weights']} ({r['zero_weights']} of them 0, "
                f"{r['zero_weights_compared']} compared)")
    r["ok"] = nbad == 0 and err == 0.0 and \
        bool(torch.isfinite(got[0]).all()) and \
        capped_kernel == capped_plain == 0
    log(f"  {what} {dtype} N={n} P={p}{wtxt} ({label}): kernel {ms:.3f} "
        f"ms; on {idx.numel()} pixels in {COLUMN_CHUNKS} runs over P count "
        f"mismatches {nbad}, max|Δmean| {err:.3g}, plain {plain:.1f} ms; "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel = "
        f"{ms / r['bound_ms']:.1f}x the bound; loops stopped at their "
        f"bound: kernel {capped_kernel} (all P), plain {capped_plain}"
        + ("" if r["ok"] else "  <-- DIFFERS FROM THE PLAIN VERSION"))
    del got
    return r


@contextlib.contextmanager
def k1_calls(keep=lambda i: True):
    """Records the calls of ``kernels.reject_stack.reject_mean`` (K1 on the
    card, its plain version on the CPU) made inside the block: for each
    call whose index ``keep`` takes, (its arguments cloned, its keywords,
    its outputs: the mean and the per-pixel counts), else None."""
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1

    calls, real = [], k1.reject_mean

    def spy(*a, **kw):
        kept = keep(len(calls))
        calls.append([tuple(v.clone() if torch.is_tensor(v) else v
                            for v in a), dict(kw), None] if kept else None)
        out = real(*a, **kw)
        if kept:
            calls[-1][2] = out
        return out

    k1.reject_mean = spy
    try:
        yield calls
    finally:
        k1.reject_mean = real


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
    c4 = coeffs(4, g4)
    record("K1e", tag, held_at_call(
        "a tile's size", "winsorized/addscale", st4, *c4,
        dict(rtype=rj.WINSORIZED, mode=ADDITIVE_SCALING, siglow=3.0,
             sighigh=3.0, weights=w4)))
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
        # held on 2^20 columns spread over the call (the plain version
        # over all of it took 22 s, K1e 19.4 of them); the
        # bound counts the stack once, 3 coefficient vectors, 12 B per
        # pixel out, a weighted mean's per-frame weights, GESDT's λ table
        r = held_at_call("the stack call size", f"{label}/addscale", full,
                         sc, off, one,
                         dict(rtype=rtype, mode=ADDITIVE_SCALING, siglow=sl,
                              sighigh=sh, **extra), work_out=work,
                         extra_bytes=4 * len(extra.get("critical", ())))
        record(var, tag, r)
        r["max_abs_err"] = errs[var]
        r["nbad_all"] = nbad[var]
        log(f"  {var} bound at the stack call size: "
            f"{r['bytes'] / 1e6:.1f} MB → {r['bytes_ms']:.4f} ms; "
            f"{r['ops'] / 1e9:.2f} G operations → {r['ops_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel "
            f"{r['ms']:.3f} ms = {r['ms'] / r['bound_ms']:.2f}x the bound; "
            f"plain {r['plain_ms']:.1f} ms on {r['slice']} columns; count "
            f"mismatches over all its configurations {nbad[var]}"
            + (f", loops stopped at their bound {capped[var]}"
               if var in ("K1b", "K1e") else "")
            + "; no library call computes this function")
        log_steps(f"{var} at the stack call size", work, r["slice"])
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
#: (winsorized and GESDT, as the stack phase runs it), held against the
#: plain version on COLUMN_SLICE pixels in COLUMN_CHUNKS runs spread over
#: P, the last ending at P, so that tiles that blocks take after their
#: first are compared too.  The sizes no command launches (winsorized at
#: N = 128 and 300 on SIZE², 1000 on 2^20; PERF.md §6 keeps their last
#: times) are not timed, to make room for the analysis phase;
#: COLUMN_FRAMES still compares every mode at 300 and 1000 frames
COLUMN_TIMING = [(STACK100, SIZE100 * SIZE100, "winsorized"),
                 (STACK100, SIZE100 * SIZE100, "gesdt")]
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


def _card_rng(seed: int):
    """A torch generator seeded with ``seed`` on the card (CARD), or on
    the CPU where there is none (the tests synthesize sessions there):
    the synthesized frames' noise is drawn on it (host numpy took ~1 s a
    4096² frame)."""
    import torch

    dev = CARD if CARD == "cpu" or torch.cuda.is_available() else "cpu"
    g = torch.Generator(device=torch.device(dev))
    g.manual_seed(seed)
    return g


def synth_frames(seed: int, n: int, size: int, aligned: bool = False):
    """A scene of Gaussian stars on a sky background, and ``n`` frames of
    it shifted by integer + sub-pixel offsets, with noise and cosmic rays
    (rendered on the card).  Returns (scene, frames u16 list, shifts,
    noise σ, ray value).  With ``aligned`` the frames are not shifted (as
    registration leaves them) and are float32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = _card_rng(seed)
    dev = g.device
    sky, sigma_n, ray = 0.1, 0.01, 1.0
    sx, sy, amp = _star_field(rng, size, 4000)
    scene_t = _render_torch(size, sky, sx, sy, amp, dev)
    shifts = [(0.0, 0.0)] * n if aligned else \
        [(0.0, 0.0)] + [(float(rng.integers(-12, 13)
                               + rng.uniform(-0.5, 0.5)),
                         float(rng.integers(-12, 13)
                               + rng.uniform(-0.5, 0.5)))
                        for _ in range(n - 1)]
    frames = []
    for dx, dy in shifts:
        f = scene_t.clone() if aligned else \
            _render_torch(size, sky, sx + dx, sy + dy, amp, dev)
        f += sigma_n * torch.randn(f.shape, generator=g, device=dev)
        k = size * size // 4000
        f[torch.as_tensor(rng.integers(0, size, k), device=dev),
          torch.as_tensor(rng.integers(0, size, k), device=dev)] = ray
        f = f.clamp_(0, 1)
        frames.append(f.cpu().numpy() if aligned else
                      torch.round(f * 65535.0).to(torch.int32).cpu().numpy()
                      .astype(np.uint16))
    return scene_t.cpu().numpy(), frames, shifts, sigma_n, ray


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
    import torch

    rng = np.random.default_rng(seed)
    g = _card_rng(seed)
    dev = g.device
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
    bias_t, dark_t, vig_t = (torch.as_tensor(a, device=dev) for a in
                             (bias, dark, vig.astype(np.float32)))

    def noisy(base, s):
        # base + s·N(0, 1), to the host
        return (base + s * torch.randn((size, size), generator=g,
                                       device=dev)).cpu().numpy()

    def put(sub, name, f):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        write_later(write_float_u16, os.path.join(root, sub, name), f)

    for i in range(calib):
        put("biases", f"bias_{i + 1:05d}.fit", noisy(bias_t, read_n))
        put("flats", f"flat_{i + 1:05d}.fit",
            noisy(bias_t + 0.5 * vig_t, read_n))
        put("darks", f"dark_{i + 1:05d}.fit", noisy(bias_t + dark_t, read_n))
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
            f = noisy(bias_t + dark_t + vig_t * _render_torch(
                size, sky, cx, cy, amp, dev), sigma_n)
            hit = _ray_tracks(rng, f, max(size * size // 40000, 4), ray)
            if k == 0:
                rays[sub] = hit
            put(sub, f"light_{k + 1:05d}.fit", f)
    scene = _render_torch(size, sky, sx, sy, amp, dev).cpu().numpy() * \
        np.float32(vig.mean())
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
    body = (u16[::-1] ^ np.uint16(0x8000)).astype(">u2").tobytes()
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

    import torch

    rng = np.random.default_rng(seed)
    g = _card_rng(seed)
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
        f = _render_torch(size, sky, v[0] / v[2], v[1] / v[2], amp,
                          g.device)
        f += sigma_n * torch.randn(f.shape, generator=g, device=g.device)
        f = f.cpu().numpy()
        hit = _ray_tracks(rng, f, max(size * size // 400000, 4), ray)
        if k == 0:
            rays = hit
        write_later(write_float_u16,
                    os.path.join(root, f"light_{k + 1:05d}.fit"), f)
    scene = _render_torch(size, sky, sx, sy, amp, g.device).cpu().numpy()
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


#: the analysis phase: ANALYSIS_LIGHTS 16-bit lights of the sky
#: field, shifted by up to ±ANALYSIS_SHIFT px, DATE-OBS ANALYSIS_STEP_MIN
#: apart, WCS cards on each; a target star whose magnitude follows
#: ECLIPSE_DM (0.2 mag deep across frames 3-5) and ANALYSIS_COMPS constant
#: comparison stars of the same brightness, listed in a NINA CSV;
#: ANALYSIS_DEFECTS hot (0.95) and as many cold (0) pixels in each light;
#: one satellite trail in light TRAIL_LIGHT from TRAIL_FROM, TRAIL_LENGTH
#: px long at TRAIL_ANGLE (both ×size/4096; its normal on a 0.5° bin of
#: the Hough vote)
ANALYSIS_LIGHTS = 8
ANALYSIS_STARS = 4000
ANALYSIS_SHIFT = 4.0
ANALYSIS_STEP_MIN = 10.0
ANALYSIS_DATE0 = "2026-03-14T22:00:00.000"
ECLIPSE_DM = (0.0, 0.0, 0.0, 0.1, 0.2, 0.1, 0.0, 0.0)
ANALYSIS_AMP = 0.4
ANALYSIS_COMPS = 5
ANALYSIS_DEFECTS = 300
ANALYSIS_SKY, ANALYSIS_NOISE = 0.1, 0.005
TRAIL_LIGHT = 3
TRAIL_FROM, TRAIL_LENGTH, TRAIL_ANGLE = (400.0, 600.0), 4000.0, 36.5
TRAIL_AMP, TRAIL_SIGMA = 0.15, 0.8
#: seqfind_cosme's σ factors against the frame's avgDev (~0.0041): cold
#: 8 (0.033 below the 24-neighbour median), hot 120 (0.49 above: above the
#: brightest star's core, 0.75·0.55, below a hot pixel's 0.85)
COSME_COLD, COSME_HOT = 8, 120
#: the dark of find_hot: DARK_SIZE², 0.02 ± 0.002, DARK_HOT pixels at 0.5
DARK_SIZE, DARK_HOT = 512, 100
#: the card against the CPU on a crop of a light
ANALYSIS_CROP = 256
#: the light curve: each point within LC_K × its reported error (the
#: target's and the comparisons' in quadrature, with the out-of-eclipse
#: mean's) of the known curve
LC_K = 5.0

ANALYSIS_SCRIPT = """requires 1.2.0
convert light
seqfind_cosme light_ {cold} {hot}
seqstat cc_light_ seqstat.csv main
seqfindstar cc_light_
seqpsf cc_light_ 0 {tx:.2f} {ty:.2f}
light_curve cc_light_ 0 -ninastars=nina.csv -aavso
seqsetmag 12.5
sequnsetmag
seqmtf cc_light_ 0.02 0.2 1
seqghs cc_light_ -D=2
seqcrop cc_light_ {crop_x} {crop_y} {crop_w} {crop_w}
seqresample cc_light_ 0.5
seqsubsky scaled_cc_light_ 1
load cc_light_{trail:05d}
detect_streaks -out=streaks.csv
load cc_light_00001
detect_streaks -out=nostreak.csv
stat main
bg
bgnoise
entropy
histo 0
cdg
findstar -out=stars.csv
psf {tx:.2f} {ty:.2f}
tilt
synthstar
save an_synth
load cc_light_00001
ssr
save an_ssr
load cc_light_00001
profile -from={px0},{py0} -to={px1},{py1} -savedat
icc_assign rec2020
icc_convert_to srgblinear
save an_icc
load an_icc
icc_remove
inspector
save an_insp
load dark/dark
find_hot dark/hot 5 5
cosme dark/hot
save dark/dark_cc
"""


def _trail_geometry(size: int):
    """(start, end) of the trail at ``size``."""
    import math

    k = size / 4096.0
    a = math.radians(TRAIL_ANGLE)
    p0 = (TRAIL_FROM[0] * k, TRAIL_FROM[1] * k)
    return p0, (p0[0] + TRAIL_LENGTH * k * math.cos(a),
                p0[1] + TRAIL_LENGTH * k * math.sin(a))


def _segment_distance(px, py, p0, p1):
    """Distance of the points (px, py) — numpy arrays or tensors — to the
    segment p0 → p1."""
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    t = (((px - p0[0]) * dx + (py - p0[1]) * dy)
         / (dx * dx + dy * dy)).clip(0.0, 1.0)
    return ((px - p0[0] - t * dx) ** 2 + (py - p0[1] - t * dy) ** 2) ** 0.5


def _render_torch(size, sky: float, cx, cy, amp, dev,
                  psf_s: float = 1.3):
    """``_render`` on the card: the stars on 13×13 patches, summed; a
    ``size`` (h, w) renders a rectangle."""
    import numpy as np
    import torch

    h, size = (size, size) if isinstance(size, int) else size
    img = torch.full((h * size,), sky, dtype=torch.float32, device=dev)
    r = 6
    o = torch.arange(-r, r + 1, device=dev)
    cx = torch.as_tensor(np.asarray(cx), device=dev)[:, None, None]
    cy = torch.as_tensor(np.asarray(cy), device=dev)[:, None, None]
    px = torch.floor(cx).long() + o[None, None, :]
    py = torch.floor(cy).long() + o[None, :, None]
    d2 = (px + 0.5 - cx) ** 2 + (py + 0.5 - cy) ** 2
    a = torch.as_tensor(np.asarray(amp), device=dev)[:, None, None]
    val = (a * torch.exp(-d2 / (2 * psf_s ** 2))).float()
    px, py = px.expand(val.shape), py.expand(val.shape)
    inb = (px >= 0) & (px < size) & (py >= 0) & (py < h)
    img.index_put_(((py * size + px)[inb],), val[inb], accumulate=True)
    return img.reshape(h, size)


def synth_analysis(root: str, seed: int, size: int,
                   nstars: int = ANALYSIS_STARS, device: str = ""):
    """The analysis phase's session in ``root``: ANALYSIS_LIGHTS raw
    16-bit lights ``raw_0000k.fit`` rendered on the card (sky field,
    shifts, noise, the eclipsing target, the defects, the trail in
    TRAIL_LIGHT), the NINA CSV ``nina.csv``, and ``dark/dark.fit``
    (rendered on ``device``, the card by default).  Returns what the
    checks need."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from siril_tpu_torch.io.fits_io import _format_card
    from siril_tpu_torch.utils.dates import format_date_obs, parse_date_obs

    rng = np.random.default_rng(seed + 71)
    dev = torch.device(device or CARD)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 72)
    sx, sy, amp = _star_field(rng, size, nstars)
    p0, p1 = _trail_geometry(size)
    # no star within 12 px of the trail's line, so that the inliers of the
    # found line are the trail's own pixels
    d_line = np.abs((sx - p0[0]) * (p1[1] - p0[1]) - (sy - p0[1])
                    * (p1[0] - p0[0])) / np.hypot(p1[0] - p0[0],
                                                  p1[1] - p0[1])
    keep = d_line > 12.0
    sx, sy, amp = sx[keep], sy[keep], amp[keep]
    # the target and its comparisons: bright isolated stars, away from the
    # trail
    margin = max(64, size // 16)
    k = size / 4096.0
    iso = _isolated(sx, sy, amp, size, n=len(sx), margin=margin,
                    near=max(10.0, 40.0 * k))
    iso = [i for i in iso if d_line[keep][i] > max(15.0, 60.0 * k)]
    picks = np.asarray(iso[:1 + ANALYSIS_COMPS], np.int64)
    if len(picks) < 1 + ANALYSIS_COMPS:
        raise SystemExit("analysis: too few isolated stars for the light "
                         "curve")
    amp = amp.copy()
    amp[picks] = ANALYSIS_AMP
    target, comps = int(picks[0]), picks[1:]
    sky = sky_wcs(size)
    tree = cKDTree(np.stack([sx, sy], axis=1))
    shifts = [(0.0, 0.0)] + [tuple(rng.uniform(-ANALYSIS_SHIFT,
                                               ANALYSIS_SHIFT, 2))
                             for _ in range(ANALYSIS_LIGHTS - 1)]
    t0 = parse_date_obs(ANALYSIS_DATE0)
    dates, defects = [], []
    # as many defects as the 16-px cells allow at a small size
    ndef = min(ANALYSIS_DEFECTS, (size // 16) ** 2 // 8)
    for k, (dx, dy) in enumerate(shifts):
        a = amp.copy()
        a[target] = ANALYSIS_AMP * 10.0 ** (-0.4 * ECLIPSE_DM[k])
        clean = _render_torch(size, ANALYSIS_SKY, sx + dx, sy + dy, a, dev)
        if k == TRAIL_LIGHT:
            lo = [int(max(0, min(p0[i], p1[i]) - 8)) for i in (0, 1)]
            hi = [int(min(size, max(p0[i], p1[i]) + 9)) for i in (0, 1)]
            yy, xx = torch.meshgrid(
                torch.arange(lo[1], hi[1], device=dev, dtype=torch.float64),
                torch.arange(lo[0], hi[0], device=dev, dtype=torch.float64),
                indexing="ij")
            d = _segment_distance(xx + 0.5, yy + 0.5, p0, p1)
            clean[lo[1]:hi[1], lo[0]:hi[0]] += (TRAIL_AMP * torch.exp(
                -d * d / (2 * TRAIL_SIGMA ** 2))).float()
        f = clean + ANALYSIS_NOISE * torch.randn(
            (size, size), generator=gen, device=dev)
        # defects on the sky, no two within 4 px (one per 16-px cell): no
        # star within 8 px, away from the trail
        n = 2 * ndef
        cand = _lattice_points(rng, size, 4 * n)
        ok = (tree.query(cand[:, ::-1] + 0.5 - np.array([dx, dy]))[0] > 8.0) \
            & (_segment_distance(cand[:, 1] + 0.5, cand[:, 0] + 0.5, p0, p1)
               > 12.0)
        cand = cand[ok][:n]
        hot, cold = cand[:ndef], cand[ndef:n]
        for pts, v in ((hot, 0.95), (cold, 0.0)):
            f[torch.as_tensor(pts[:, 0], device=dev),
              torch.as_tensor(pts[:, 1], device=dev)] = v
        defects.append(dict(
            hot=hot, cold=cold,
            clean_hot=clean[torch.as_tensor(hot[:, 0], device=dev),
                            torch.as_tensor(hot[:, 1], device=dev)]
            .cpu().numpy(),
            clean_cold=clean[torch.as_tensor(cold[:, 0], device=dev),
                             torch.as_tensor(cold[:, 1], device=dev)]
            .cpu().numpy()))
        u16 = torch.round(torch.clamp(f, 0, 1) * 65535.0).to(
            torch.int32).cpu().numpy().astype(np.uint16)
        date = format_date_obs(t0 + __import__("datetime").timedelta(
            minutes=ANALYSIS_STEP_MIN * k))
        dates.append(date)
        cards = [_format_card("DATE-OBS", date)] + [
            _format_card(key, v, c) for key, v, c in
            sky.shifted(dx, dy).to_cards()]
        write_later(write_u16_fits, os.path.join(root, f"raw_{k + 1:05d}.fit"),
                    u16, extra=cards)
        del clean, f
    ra, dec = sky.pix2world(sx[picks], sy[picks])
    with open(os.path.join(root, "nina.csv"), "w") as f:
        f.write("Type,Name,Ra,Dec\n")
        for j in range(len(picks)):
            f.write(f"{'Target' if j == 0 else 'Comparison'},s{j},"
                    f"{ra[j]:.8f},{dec[j]:.8f}\n")
    # the dark of find_hot
    os.makedirs(os.path.join(root, "dark"), exist_ok=True)
    dark = (0.02 + 0.002 * rng.standard_normal((DARK_SIZE, DARK_SIZE)))
    hot = _lattice_points(rng, DARK_SIZE, DARK_HOT)
    dark[hot[:, 0], hot[:, 1]] = 0.5
    write_later(write_float_u16, os.path.join(root, "dark", "dark.fit"),
                dark)
    return dict(sx=sx, sy=sy, amp=amp, target=target, comps=comps,
                shifts=shifts, dates=dates, defects=defects, trail=(p0, p1),
                dark_hot=hot)


def _lattice_points(rng, size: int, n: int):
    """``n`` (row, col) points, one in each of ``n`` distinct 16-px cells
    at 2-13 px into it: no two within 4 px, none within 2 px of an
    edge."""
    import numpy as np

    cells = size // 16
    c = rng.choice(cells * cells, n, replace=False)
    return np.stack([c // cells, c % cells], axis=1) * 16 + \
        rng.integers(2, 14, (n, 2))


def analysis_checks(root: str, made: dict, size: int) -> dict:
    """The checks of the analysis session against what synth_analysis
    made; raises on the first that fails."""
    import math

    import numpy as np

    from siril_tpu_torch.io.fits_io import read_fits, read_icc_extension
    from siril_tpu_torch.ops.icc import _builtin_icc
    from siril_tpu_torch.ops.icc_file import write_icc_bytes
    from siril_tpu_torch.utils.dates import date_obs_to_julian

    out = {}
    # every injected hot and cold pixel corrected, within 5σ of the scene
    worst = 0.0
    for k, d in enumerate(made["defects"]):
        img = read_fits(os.path.join(root, f"cc_light_{k + 1:05d}.fit"))
        lay = img.data[0]
        for pts, clean in ((d["hot"], d["clean_hot"]),
                           (d["cold"], d["clean_cold"])):
            err = np.abs(lay[pts[:, 0], pts[:, 1]] - clean)
            worst = max(worst, float(err.max()))
    out["cosme_worst_sigma"] = worst / ANALYSIS_NOISE
    log(f"  seqfind_cosme: the worst of {2 * len(d['hot'])} defects × "
        f"{ANALYSIS_LIGHTS} lights is {worst / ANALYSIS_NOISE:.2f}σ from "
        "the clean scene (bound 5σ)")
    if not worst <= 5.0 * ANALYSIS_NOISE:
        raise SystemExit("analysis: seqfind_cosme left a defect")
    # the light curve against the known one
    rows = [ln.split() for ln in open(os.path.join(root, "light_curve.dat"))
            if not ln.startswith("#")]
    frames = [int(r[0]) for r in rows]
    rel = np.array([float(r[2]) for r in rows])
    err = np.array([float(r[3]) for r in rows])
    dm = np.array([ECLIPSE_DM[i] for i in frames])
    flat = dm == 0.0
    base = rel[flat].mean()
    tol = LC_K * np.sqrt(err ** 2 + np.mean(err[flat] ** 2) / flat.sum())
    dev = np.abs(rel - base - dm)
    out["light_curve"] = dict(frames=frames, rel=(rel - base).tolist(),
                              err=err.tolist(), dev=dev.tolist(),
                              tol=tol.tolist())
    log(f"  light curve: {len(rows)} points; rel. mag − baseline "
        f"{np.round(rel - base, 4).tolist()} against {dm.tolist()}; "
        f"|Δ| max {dev.max():.4f} (bound {LC_K}× the reported error, "
        f"{tol.min():.4f}-{tol.max():.4f})")
    if len(rows) != ANALYSIS_LIGHTS or not (dev <= tol).all():
        raise SystemExit("analysis: the light curve is off the known one")
    # the AAVSO report: one row a frame, JD from DATE-OBS
    lines = [ln.strip().split(",") for ln in open(
        os.path.join(root, "light_curve_aavso.csv"))
        if not ln.startswith("#")]
    want = np.array([date_obs_to_julian(d) for d in made["dates"]])
    jd0 = 2440587.5 + (__import__("datetime").datetime(
        2026, 3, 14, 22, tzinfo=__import__("datetime").timezone.utc)
        .timestamp()) / 86400.0
    truth = jd0 + ANALYSIS_STEP_MIN / 1440.0 * np.arange(ANALYSIS_LIGHTS)
    got = np.array([float(r[1]) for r in lines])
    jd_err = float(np.abs(got - truth).max()) if len(got) == len(truth) \
        else math.inf
    out["aavso_jd_err"] = jd_err
    log(f"  AAVSO: {len(lines)} rows, JD max|Δ| {jd_err:.2e} d (bound 1e-5; "
        f"DATE-OBS → JD {float(np.abs(want - truth).max()):.1e})")
    if len(lines) != ANALYSIS_LIGHTS or not jd_err <= 1e-5:
        raise SystemExit("analysis: the AAVSO report is off")
    # the trail, and none in a light without one
    p0, p1 = made["trail"]
    best = None
    for r in [ln.strip().split(",") for ln in
              open(os.path.join(root, "streaks.csv"))][1:]:
        a, b = (float(r[0]), float(r[1])), (float(r[2]), float(r[3]))
        # pixel centres against the rendered segment's ends
        e = min(max(math.dist(a, (p0[0] - .5, p0[1] - .5)),
                    math.dist(b, (p1[0] - .5, p1[1] - .5))),
                max(math.dist(b, (p0[0] - .5, p0[1] - .5)),
                    math.dist(a, (p1[0] - .5, p1[1] - .5))))
        want_ang = math.degrees(math.atan2(p1[1] - p0[1], p1[0] - p0[0]))
        ang = (float(r[5]) - want_ang + 90.0) % 180.0 - 90.0
        if best is None or e < best[0]:
            best = (e, abs(ang))
    out["streak"] = best
    nostreak = os.path.exists(os.path.join(root, "nostreak.csv"))
    log("  detect_streaks: " + (
        f"endpoints {best[0]:.2f} px, angle {best[1]:.3f}° off" if best
        else "no track") + " (bounds 5 px, 0.5°); the light without a "
        f"trail: {'a track' if nostreak else 'none'}")
    if best is None or not (best[0] <= 5.0 and best[1] <= 0.5) or nostreak:
        raise SystemExit("analysis: detect_streaks missed")
    # find_hot's list and cosme
    lst = [ln.split() for ln in open(os.path.join(root, "dark", "hot.lst"))]
    listed = {(int(r[1]), DARK_SIZE - 1 - int(r[2])) for r in lst
              if r[3] == "H"}
    hot = made["dark_hot"]
    missing = sum((int(x), int(y)) not in listed for y, x in hot)
    cc = read_fits(os.path.join(root, "dark", "dark_cc.fit")).data[0]
    left = float(np.abs(cc[hot[:, 0], hot[:, 1]] - 0.02).max())
    out["find_hot"] = dict(listed=len(listed), missing=missing, left=left)
    log(f"  find_hot: {len(listed)} hot pixels listed, {missing} of "
        f"{len(hot)} missing; after cosme max|Δ| {left:.4f} from the dark "
        "level (bound 5σ = 0.01)")
    if missing or not left <= 0.01:
        raise SystemExit("analysis: find_hot / cosme missed a hot pixel")
    # the ICC profile read back from the saved FITS
    raw = read_icc_extension(os.path.join(root, "an_icc.fit"))
    same = raw == write_icc_bytes(_builtin_icc("srgblinear"))
    out["icc_bytes_equal"] = same
    log(f"  icc: the profile read back from an_icc.fit ({len(raw or b'')} "
        f"bytes) is {'byte-equal to' if same else 'NOT'} the one written")
    if not same:
        raise SystemExit("analysis: the ICC profile did not round-trip")
    return out


def analysis_vs_cpu(root: str, made: dict, crop: int) -> list:
    """Each device op of the analysis session on the card against the CPU
    on a crop² of the trail light (cc_light_ of TRAIL_LIGHT): the
    24-neighbour median and its masks, the Hough vote, the histogram, the
    statistics, the painting of synthstar and ssr, the ICC curves, the
    profile."""
    import numpy as np
    import torch

    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops import cosmetic, icc, inspector, statistics
    from siril_tpu_torch.ops import streaks, synthstar
    from siril_tpu_torch.registration.starfinder import detect_stars

    img = read_fits(os.path.join(root, f"cc_light_{TRAIL_LIGHT + 1:05d}.fit"))
    S = img.width
    p0, _ = made["trail"]
    # a crop that holds the trail's start and stars
    c0 = (int(np.clip(p0[1] - crop // 4, 0, S - crop)),
          int(np.clip(p0[0] - crop // 4, 0, S - crop)))
    h = np.ascontiguousarray(img.data[0, c0[0]:c0[0] + crop,
                                      c0[1]:c0[1] + crop])
    xh = torch.from_numpy(h)
    xc = xh.to(CARD)
    rows = []

    def row(op, err, bound):
        rows.append(dict(op=op, max_abs_err=err, bound=bound))
        log(f"    {op}: card vs cpu max|Δ| {err:.3g} (bound {bound:g})")
        if not err <= bound:
            raise SystemExit(f"analysis: {op} on the card is {err} from the "
                             f"CPU (bound {bound})")

    # the 24-neighbour median and the masks (a frame and as a CFA)
    err = 0.0
    for cfa in (False, True):
        a = cosmetic.auto_detect_tensor(xc, 3.0, 3.0, cfa)
        b = cosmetic.auto_detect_tensor(xh, 3.0, 3.0, cfa)
        m = cosmetic.neighbour_median(xc, cfa).cpu()
        err = max(err, float((a[0].cpu() - b[0]).abs().max()),
                  float((m - cosmetic.neighbour_median(xh, cfa)).abs().max()),
                  float((a[1].cpu() != b[1]).sum() + (a[2].cpu() != b[2])
                        .sum()))
    row("find_cosme: median, masks, correction", err, 0.0)
    yx = torch.nonzero(xh > 0.2).float()
    acc = [streaks.hough_accumulator(t[:, 0], t[:, 1], (crop, crop), 360)
           for t in (yx.to(CARD), yx)]
    row(f"detect_streaks: Hough vote of {yx.shape[0]} points",
        float(np.abs(acc[0].astype(np.int64) - acc[1]).max()), 0.0)
    hist = [statistics.histogram256(t) for t in (xc, xh)]
    row("histogram", float(np.abs(hist[0] - hist[1]).max()), 0.0)
    sc, sh = (statistics.compute_stats_tensor(t, statistics.STATS_EXTRA)
              for t in (xc, xh))
    med = max(abs(getattr(sc, k) - getattr(sh, k))
              for k in ("median", "mad", "location", "min", "max"))
    row("statistics: medians, MAD, IKSS location", med, 0.0)
    row("statistics: mean, avgdev, σ, bgnoise, bwmv, scale", max(
        abs(getattr(sc, k) - getattr(sh, k))
        for k in ("mean", "avgdev", "sigma", "bgnoise", "sqrtbwmv",
                  "scale")), 1e-12)
    stars = detect_stars(xh)
    rgb = np.stack([h, 0.8 * h, np.clip(1.2 * h, 0, 1)]).astype(np.float32)
    paint = [synthstar.paint_stars(torch.from_numpy(rgb.copy()).to(d),
                                   stars, 0).cpu() for d in (CARD, "cpu")]
    row(f"synthstar: painting {len(stars)} stars, in "
        f"{len(synthstar.paint_waves(stars, crop, crop))} waves",
        float((paint[0] - paint[1]).abs().max()), 1e-6)
    discs = [synthstar.star_discs(stars, crop, crop, torch.device(d)).cpu()
             for d in (CARD, "cpu")]
    row("ssr: the star mask", float((discs[0] != discs[1]).sum()), 0.0)
    dd = torch.from_numpy(rgb).double()
    timg = SirilImage(data=rgb)
    for prof in ("rec2020", "srgblinear"):
        timg = icc.assign_profile(SirilImage(data=rgb), "srgb")
        a = icc.convert_tensor(dd.to(CARD), timg, prof)[0].cpu()
        b = icc.convert_tensor(dd, timg, prof)[0]
        row(f"icc_convert_to {prof}: float64 curves",
            float((a - b).abs().max()), 1e-12)
    prof = [inspector.intensity_profile(SirilImage(data=rgb), (3.2, 5.7),
                                        (crop - 4.1, crop - 9.3), width=3,
                                        device=d) for d in (CARD, "cpu")]
    row("profile", float(np.abs(prof[0] - prof[1]).max()), 1e-6)
    return rows


def analysis_timings(root: str, reps: int) -> dict:
    """ms per SIZE² frame (CUDA events) of the session's device ops on the
    trail light."""
    import numpy as np
    import torch

    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops import cosmetic, icc, statistics, streaks
    from siril_tpu_torch.ops import synthstar
    from siril_tpu_torch.registration.starfinder import detect_stars

    img = read_fits(os.path.join(root, f"cc_light_{TRAIL_LIGHT + 1:05d}.fit"))
    x = torch.from_numpy(img.data[0]).to(CARD)
    d3 = x[None].double()
    srgb = icc.assign_profile(SirilImage(data=img.data), "srgb")
    out = {}
    for label, fn, n in (
            ("find_cosme", lambda: cosmetic.auto_detect_tensor(
                x, COSME_HOT, COSME_COLD), reps),
            ("stat main", lambda: statistics.compute_stats_tensor(
                x, statistics.STATS_MAIN), reps),
            ("icc_convert_to rec2020", lambda: icc.convert_tensor(
                d3, srgb, "rec2020"), reps),
            ("detect_streaks", lambda: streaks.detect_streaks_tensor(x), 1),
            ("synthstar", lambda: synthstar.paint_stars(
                x[None].clone(), detect_stars(x), 0), 1),
            ("ssr", lambda: x.clone().masked_fill_(synthstar.star_discs(
                detect_stars(x), x.shape[0], x.shape[1], x.device),
                statistics.compute_stats_tensor(
                    x, statistics.STATS_BASIC).median), 1)):
        out[label], peak = _peak_ms(fn, n)
        log(f"    {label}: {out[label]:.3f} ms per {img.width}² frame"
            f" ({'median of ' + str(n) if n > 1 else 'one run'}), peak "
            f"{peak:.0f} MiB")
    del x, d3
    torch.cuda.empty_cache()
    return out


def phase_analysis(seed: int, size: int = SIZE):
    """The analysis session (ANALYSIS_SCRIPT) through the CLI's -s entry
    on synth_analysis's lights: each command's seconds and peak device
    memory; analysis_checks against the known scene; the card against
    the CPU (analysis_vs_cpu); the device ops timed (analysis_timings).
    Returns (rows of the commands, checks, card rows, timings)."""
    from siril_tpu_torch import cli

    root = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        t = time.perf_counter()
        made = synth_analysis(root, seed, size, int(
            ANALYSIS_STARS * (size / 4096.0) ** 2))
        writes_done()
        log(f"  {ANALYSIS_LIGHTS} lights of {size}², the NINA list and the "
            f"dark rendered and written in {time.perf_counter() - t:.2f}s")
        k = size / 4096.0
        p0, p1 = made["trail"]
        script = ANALYSIS_SCRIPT.format(
            cold=COSME_COLD, hot=COSME_HOT,
            tx=made["sx"][made["target"]], ty=made["sy"][made["target"]],
            crop_x=int(1024 * k), crop_y=int(1024 * k), crop_w=int(2048 * k),
            trail=TRAIL_LIGHT + 1, px0=int(100 * k), py0=int(200 * k),
            px1=int(3900 * k), py1=int(3700 * k))
        with open(os.path.join(root, "analysis.ssf"), "w") as f:
            f.write(script)
        t = time.perf_counter()
        session = cli.run(["-d", root, "-s",
                           os.path.join(root, "analysis.ssf")])
        log(f"  analysis.ssf: {time.perf_counter() - t:.2f}s")
        rows = {}
        for row in session.command_log:
            rows[row["command"]] = row
            log(f"    {row['command']}: {row['seconds']:.3f}s, peak "
                f"{row['peak_mib'] or 0:.0f} MiB" + (
                    " (" + ", ".join(f"{k} {v:.3f}s" for k, v in
                                     row["stages"].items()) + ")"
                    if row["stages"] else ""))
        t = time.perf_counter()
        checks = analysis_checks(root, made, size)
        log(f"  checks: {time.perf_counter() - t:.2f}s")
        t = time.perf_counter()
        ops = analysis_vs_cpu(root, made, min(ANALYSIS_CROP, size))
        log(f"  card vs cpu: {time.perf_counter() - t:.2f}s")
        timings = analysis_timings(root, 3)
        log("analysis: " + json.dumps(dict(
            commands={k: dict(seconds=v["seconds"], peak_mib=v["peak_mib"])
                      for k, v in rows.items()},
            checks=checks, ops=ops, ms=timings), default=str))
        return rows, checks, ops, timings
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the planetary phase: a mono 16-bit SER of PLANET_FRAMES frames of
#: PLANET_W × PLANET_H, rendered on the card from --seed (planet_video)
PLANET_FRAMES = 1000
PLANET_W, PLANET_H = 640, 480
#: the disc's radius (px), the global drift (± px), the local field's
#: largest displacement on the disc (px) and coherence (its Gaussian σ,
#: px), the seeing
#: blur's σ range (px) and the noise σ
PLANET_R = 150.0
PLANET_DRIFT = 8.0
PLANET_LOCAL = 1.5
PLANET_COHERENCE = 25.0
PLANET_BLUR = (0.5, 2.0)
PLANET_NOISE = 0.01
#: the channel shifts (dx, dy) of R and B for ``rgbcomp -align``
RGB_SHIFTS = {"r": (0.6, -0.4), "b": (-0.8, 0.3)}
PLANETARY_SCRIPT = """requires 1.2.0
seqquality planet
register_mpp planet
stack_mpp planet -out=stacked
mpp planet -out=mpp_full
rgbcomp r g b -align -out=rgb
"""
#: checks: seqquality's rank correlation with the known blur, the share
#: of the (frame, AP) solves on the disc that succeed, rgbcomp -align's
#: channel shifts (px)
QUALITY_RHO = 0.9
SOLVED_SHARE = 0.9
RGB_ALIGN_TOL = 0.1
#: the global shifts' RMS against the known drift (px), and their slope
#: against it.  The reference's parabola through the phase-correlation
#: peak locks to whole pixels (a 0.25 px shift reads 0.11; the phase logs
#: it, PERF.md §4), and the local field moves the peak further: 0.2 px
#: RMS is out of its reach even without the field.  The first card run
#: measured 0.398 (the data are seeded, the run deterministic)
GLOBAL_RMS_TOL = 0.45
GLOBAL_SLOPE_TOL = 0.02
#: the AP shifts against the known local field, RMS over the solved
#: (frame, AP) pairs on the disc (px; the first card run measured 0.310
#: against a field of 0.742 RMS, PERF.md §4)
LOCAL_RMS_TOL = 0.35
#: card against CPU: frames and crop; the share of the AP shifts within
#: 1e-3 px, and within AP_CPU_TOL px, and the stacked image's largest
#: difference.  The two devices' FFTs round differently (cuFFT,
#: pocketfft), the sub-pixel fit magnifies it, and a solve on the edge of
#: its gates can flip (one of 1296 moved 0.69 px on the first card run,
#: PERF.md §4); MLC on the same windows is held bit for bit
PLANET_CPU_FRAMES = 16
PLANET_CROP = 256
AP_CPU_SHARE = 0.97
AP_CPU_TOL = 1e-2
AP_CPU_TOL_SHARE = 0.995
IMAGE_CPU_TOL = 2e-4


def planet_scene(x, y, cx: float, cy: float, r: float):
    """The planet at (x, y) (tensors, px): a banded, limb-darkened,
    slightly oblate disc of radius ``r`` centred on (cx, cy), with fine
    belts and a few spots, on a dark sky."""
    import torch

    u = (x - cx) / r
    v = (y - cy) / (0.93 * r)
    rr = torch.clamp(u * u + v * v, max=1.0)
    mu = torch.sqrt(1.0 - rr)
    lat = torch.asin(torch.clamp(v, -1.0, 1.0))
    bands = 0.14 * torch.sin(7.0 * lat + 0.4) + 0.06 * torch.sin(
        19.0 * lat + 1.1) + 0.03 * torch.sin(23.0 * lat + 1.7 * u)
    # festoons and eddies: waves of 8-40 px in every direction
    for k, (fx, fy, ph) in enumerate(((0.9, 0.4, 0.3), (-0.5, 0.8, 1.9),
                                      (0.2, -1.0, 2.6), (0.7, 0.7, 4.1),
                                      (-0.95, -0.3, 5.3), (0.35, 0.9, 0.8))):
        wl = (8.0 + 6.0 * k) / r
        bands = bands + 0.05 * torch.sin((fx * u + fy * v) * (2 * 3.14159265
                                                               / wl) + ph)
    disc = 0.62 * (0.35 + 0.65 * mu) * (1.0 + bands)
    for sx, sy, sr, a in ((-0.35, 0.28, 0.09, -0.25), (0.22, -0.12, 0.05,
                                                         0.2),
                          (0.45, 0.4, 0.04, -0.3), (-0.1, -0.45, 0.07,
                                                    0.15)):
        disc = disc * (1.0 + a * torch.exp(-((u - sx) ** 2 + (v - sy) ** 2)
                                           / (2 * sr * sr)))
    edge = torch.sigmoid((1.0 - torch.sqrt(u * u + v * v)) * r / 0.7)
    return 0.02 + edge * disc


def _gauss_ft(h: int, w: int, sigma, dev):
    """exp(−2π²σ²f²) on the rfft2 grid, (N, h, w//2+1) for σ of (N,)."""
    import math

    import torch

    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    f2 = (fy * fy + fx * fx)[None]
    s = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    return torch.exp(-2.0 * math.pi ** 2 * s[:, None, None] ** 2 * f2)


def local_fields(g, n: int, h: int, w: int, dev, step: int = 8):
    """(n, 2, h//step, w//step) coarse local displacement fields (dx, dy):
    white noise smoothed to PLANET_COHERENCE px, with zero mean over the
    disc (where the frame has content: the sky is flat) and PLANET_LOCAL
    px at its largest there."""
    import torch

    hc, wc = h // step, w // step
    noise = torch.randn(n, 2, hc, wc, generator=g, device=dev)
    sig = torch.full((n * 2,), PLANET_COHERENCE / step, device=dev)
    f = torch.fft.irfft2(torch.fft.rfft2(noise.reshape(n * 2, hc, wc))
                         * _gauss_ft(hc, wc, sig, dev), s=(hc, wc))
    f = f.reshape(n, 2, hc, wc)
    yy, xx = torch.meshgrid(
        (torch.arange(hc, device=dev) + 0.5) * step - h / 2.0,
        (torch.arange(wc, device=dev) + 0.5) * step - w / 2.0,
        indexing="ij")
    disc = (torch.hypot(xx, yy / 0.93) < PLANET_R).float()
    f = f - (f * disc).sum(dim=(2, 3), keepdim=True) / disc.sum()
    peak = (f.abs() * disc).amax(dim=(1, 2, 3), keepdim=True)
    return f * (PLANET_LOCAL / peak)


def _full_field(coarse, h: int, w: int):
    """A coarse (n, 2, hc, wc) field at full resolution (bilinear)."""
    import torch.nn.functional as F

    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)


def planet_video(root: str, seed: int, n: int = PLANET_FRAMES,
                 w: int = PLANET_W, h: int = PLANET_H, dev="cuda"):
    """``planet.ser`` in ``root``: n mono 16-bit frames rendered on
    ``dev``: the scene displaced by a global drift and a local field,
    blurred by a seeing σ, with noise; and r.fit, g.fit, b.fit, the scene
    with R and B shifted by RGB_SHIFTS.  Returns the truth."""
    import numpy as np
    import torch

    from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.io.ser import SER_MONO, SerWriter

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 41)
    cx, cy = w / 2.0, h / 2.0
    drift = (torch.rand(n, 2, generator=g, device=dev) * 2 - 1) * PLANET_DRIFT
    blur = PLANET_BLUR[0] + (PLANET_BLUR[1] - PLANET_BLUR[0]) * torch.rand(
        n, generator=g, device=dev)
    coarse = local_fields(g, n, h, w, dev)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    wr = SerWriter(os.path.join(root, "planet.ser"), w, h, SER_MONO, 16)
    batch = 50
    for b0 in range(0, n, batch):
        b1 = min(n, b0 + batch)
        field = _full_field(coarse[b0:b1], h, w)
        # the content at x comes from the scene at x − displacement
        sx = xx[None] - drift[b0:b1, 0, None, None] - field[:, 0]
        sy = yy[None] - drift[b0:b1, 1, None, None] - field[:, 1]
        f = planet_scene(sx, sy, cx, cy, PLANET_R)
        f = torch.fft.irfft2(torch.fft.rfft2(f) * _gauss_ft(
            h, w, blur[b0:b1], dev), s=(h, w))
        f = f + PLANET_NOISE * torch.randn(f.shape, generator=g, device=dev)
        # the 16-bit words as int16 (two's complement) on the card: half
        # the bytes to fetch, the same bytes in the file
        q = torch.round(torch.clamp(f, 0.0, 1.0) * 65535.0).to(
            torch.int32).to(torch.int16)
        wr.write_raw(q.cpu().numpy().view(np.uint16))
    wr.close()
    scene = planet_scene(xx, yy, cx, cy, PLANET_R)
    for name in ("r", "g", "b"):
        dx, dy = RGB_SHIFTS.get(name, (0.0, 0.0))
        c = planet_scene(xx - dx, yy - dy, cx, cy, PLANET_R)
        c = c + 0.005 * torch.randn(c.shape, generator=g, device=dev)
        write_fits(SirilImage(data=c.cpu().numpy()[None]),
                   os.path.join(root, f"{name}.fit"), bitdepth=FLOAT_IMG)
    return dict(drift=drift.cpu().numpy().astype(np.float64),
                blur=blur.cpu().numpy().astype(np.float64), coarse=coarse,
                scene=scene.cpu().numpy(), cx=cx, cy=cy)


def _spearman(a, b) -> float:
    import numpy as np

    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def _box_field(coarse, ap_xy, S: int, h: int, w: int):
    """(n, A, 2) mean of each frame's local field over each AP box."""
    import numpy as np
    import torch

    out = np.zeros((coarse.shape[0], len(ap_xy), 2))
    half = S // 2
    for b0 in range(0, coarse.shape[0], 100):
        f = _full_field(coarse[b0:b0 + 100], h, w)
        for a, (x, y) in enumerate(ap_xy.astype(int)):
            y0 = int(np.clip(y - half, 0, h - S))
            x0 = int(np.clip(x - half, 0, w - S))
            out[b0:b0 + 100, a] = f[:, :, y0:y0 + S, x0:x0 + S].mean(
                dim=(2, 3)).cpu().numpy()
        del f
        torch.cuda.empty_cache()
    return out


def _align_to(scene, x):
    """``x`` moved onto ``scene`` by its phase correlation (sub-pixel,
    Fourier shift on the card)."""
    import numpy as np
    import torch

    from siril_tpu_torch.planetary.mpp import _shift_core
    from siril_tpu_torch.registration.shift import phase_correlate

    d = phase_correlate(scene, x[None], device=CARD)[0]
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(CARD)
    sh = torch.tensor([[d[0], d[1]]], dtype=torch.float32, device=CARD)
    return _shift_core(t[None], sh)[0].cpu().numpy(), d


def planetary_checks(root: str, truth: dict) -> dict:
    """The session's results against the truth (PLANETARY_SCRIPT's
    outputs in ``root``)."""
    import numpy as np
    import torch

    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.planetary.mpp import MPPState, _shift_core
    from siril_tpu_torch.planetary.quality import quality_batch
    from siril_tpu_torch.registration.shift import phase_correlate

    checks, vals = {}, {}
    n = len(truth["blur"])
    qual = read_seqfile(os.path.join(root, "planet.seq")).reg(0).quality
    rho = _spearman(qual[:n], -truth["blur"])
    vals["quality_spearman"] = rho
    checks[f"seqquality ranks the blur (Spearman {rho:.4f} ≥ "
           f"{QUALITY_RHO})"] = rho >= QUALITY_RHO
    st = MPPState.load(os.path.join(root, "planet.mpp"))
    best = int(np.argmax(st.quality))
    want = -(truth["drift"] - truth["drift"][best])
    gerr = st.global_shifts - want
    grms = float(np.sqrt((gerr ** 2).sum(1).mean()))
    vals.update(best=best, global_rms=grms,
                global_max=float(np.abs(gerr).max()), aps=len(st.ap_xy),
                boxes=int(n * len(st.ap_xy)))
    slope = [float(np.polyfit(want[:, k], st.global_shifts[:, k], 1)[0])
             for k in (0, 1)]
    # the parabola's pull to whole pixels, on the scene itself
    yy, xx = np.mgrid[0:PLANET_H, 0:PLANET_W].astype(np.float32)
    lock = {}
    for d in (0.25, 0.5, 0.75):
        moved = planet_scene(torch.from_numpy(xx - d), torch.from_numpy(yy),
                             truth["cx"], truth["cy"], PLANET_R).numpy()
        lock[d] = float(-phase_correlate(truth["scene"], moved[None],
                                         device=CARD)[0][0])
    vals.update(global_slope=slope, pixel_locking=lock)
    checks[f"global shifts within {GLOBAL_RMS_TOL} px RMS of the drift "
           f"({grms:.4f}), slope 1 ± {GLOBAL_SLOPE_TOL} "
           f"({slope[0]:.4f}, {slope[1]:.4f})"] = \
        grms <= GLOBAL_RMS_TOL and \
        max(abs(v - 1) for v in slope) <= GLOBAL_SLOPE_TOL
    # the AP shifts against the local field: lx = −(ε_i + L_i − mean over
    # the reference frames of (ε_j + L_j)), ε the global residual
    S = 48
    L = _box_field(truth["coarse"], st.ap_xy, S, PLANET_H, PLANET_W)
    disp = gerr[:, None, :] + L
    n_ref = max(int(round(n * 25.0 / 100.0)), 1)
    ref = np.argsort(-st.quality)[:n_ref]
    expect = -(disp - disp[ref].mean(0)[None])
    r = np.hypot(st.ap_xy[:, 0] - truth["cx"], st.ap_xy[:, 1] - truth["cy"])
    on_disc = r < PLANET_R * 0.93 - S / 2
    solved = (st.ap_shifts != 0).any(-1) & on_disc[None]
    share = float(solved.sum() / max(on_disc.sum() * n, 1))
    d = (st.ap_shifts - expect)[solved]
    lrms = float(np.sqrt((d ** 2).sum(-1).mean()))
    vals.update(aps_on_disc=int(on_disc.sum()), solved_share=share,
                local_rms=lrms, local_p99=float(np.quantile(
                    np.hypot(d[:, 0], d[:, 1]), 0.99)),
                local_field_rms=float(np.sqrt((expect[solved] ** 2).sum(
                    -1).mean())))
    checks[f"{share:.4f} of the (frame, AP) solves on the disc succeed "
           f"(≥ {SOLVED_SHARE})"] = share >= SOLVED_SHARE
    checks[f"AP shifts within {LOCAL_RMS_TOL} px RMS of the local field "
           f"({lrms:.4f}; the field itself {vals['local_field_rms']:.4f})"] \
        = lrms <= LOCAL_RMS_TOL
    # the mpp result against the plain mean of the globally aligned frames
    mpp = read_fits(os.path.join(root, "mpp_full.fit")).host()[0]
    stacked = read_fits(os.path.join(root, "stacked.fit")).host()[0]
    checks["register_mpp + stack_mpp equal to mpp"] = bool(
        np.array_equal(mpp, stacked))
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.planetary.source import frame_chunks

    seq = Sequence.from_ser(os.path.join(root, "planet.ser"))
    acc = None
    for chunk, fr in frame_chunks(seq, np.arange(n), 0, 100, CARD):
        sh = torch.from_numpy(st.global_shifts[chunk].astype(
            np.float32)).to(CARD)
        part = _shift_core(fr, sh).sum(0)
        acc = part if acc is None else acc + part
    mean = (acc / n).cpu().numpy()
    scene = truth["scene"]
    yy, xx = np.mgrid[0:PLANET_H, 0:PLANET_W]
    disc = np.hypot(xx - truth["cx"], (yy - truth["cy"]) / 0.93) < \
        PLANET_R - 12
    a_mpp, _ = _align_to(scene, mpp)
    a_mean, _ = _align_to(scene, mean)
    e_mpp = float(np.abs(a_mpp - scene)[disc].mean())
    e_mean = float(np.abs(a_mean - scene)[disc].mean())
    q = quality_batch(np.stack([mpp, mean]), device=CARD)
    vals.update(err_mpp=e_mpp, err_mean=e_mean, q_mpp=float(q[0]),
                q_mean=float(q[1]))
    checks[f"mpp closer to the scene than the aligned mean ({e_mpp:.5f} < "
           f"{e_mean:.5f})"] = e_mpp < e_mean
    checks[f"mpp sharper than the aligned mean ({q[0]:.4g} > {q[1]:.4g})"] \
        = bool(q[0] > q[1])
    checks["mpp finite, one layer of the frame size"] = \
        mpp.shape == (PLANET_H, PLANET_W) and bool(np.isfinite(mpp).all())
    # rgbcomp -align: the channel shifts it measured, and what is left
    rgb = read_fits(os.path.join(root, "rgb.fit")).host()
    src = np.stack([read_fits(os.path.join(root, f"{c}.fit")).host()[0]
                    for c in ("r", "g", "b")])
    got = phase_correlate(src[1], src[[0, 2]], device=CARD)
    left = phase_correlate(rgb[1], rgb[[0, 2]], device=CARD)
    errs = []
    for k, c in enumerate(("r", "b")):
        errs.append(float(np.abs(got[k] + np.asarray(RGB_SHIFTS[c])).max()))
        errs.append(float(np.abs(left[k]).max()))
    vals["rgb_align"] = errs
    checks[f"rgbcomp -align: the channel shifts within {RGB_ALIGN_TOL} px, "
           f"none left ({max(errs):.4f})"] = max(errs) <= RGB_ALIGN_TOL
    return checks, vals


def planetary_vs_cpu(root: str, seed: int) -> dict:
    """Card against CPU on PLANET_CPU_FRAMES frames of a PLANET_CROP² crop
    of the video: the quality, the phase correlation, MLC on the same
    windows, and the three MPP stages."""
    import numpy as np
    import torch

    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.ser import SER_MONO, SerFile, SerWriter
    from siril_tpu_torch.planetary import mpp as pm

    crop_dir = os.path.join(root, "crop")
    os.makedirs(crop_dir)
    src = SerFile(os.path.join(root, "planet.ser"))
    c = PLANET_CROP
    y0, x0 = (PLANET_H - c) // 2, (PLANET_W - c) // 2
    raw = np.asarray(src._mm[:PLANET_CPU_FRAMES, y0:y0 + c, x0:x0 + c, 0])
    wr = SerWriter(os.path.join(crop_dir, "crop.ser"), c, c, SER_MONO, 16)
    wr.write_raw(raw)
    wr.close()
    out, rows = {}, {}
    for dev in ("cuda", "cpu"):
        seq = Sequence.from_ser(os.path.join(crop_dir, "crop.ser"))
        a = pm.MPPArgs()
        st = pm.mpp_analyze(seq, a, dev)
        st = pm.mpp_compute_shifts(seq, st, a, dev)
        img = pm.mpp_stack(seq, st, a, dev)
        rows[dev] = (st, img.host()[0], seq)
    (sc, ic, seq), (sh, ih, _) = rows["cuda"], rows["cpu"]
    out["quality"] = float(np.abs(sc.quality / sh.quality - 1).max())
    out["quality_order"] = bool(np.array_equal(np.argsort(sc.quality),
                                               np.argsort(sh.quality)))
    out["global"] = float(np.abs(sc.global_shifts - sh.global_shifts).max())
    out["aps_equal"] = bool(np.array_equal(sc.ap_xy, sh.ap_xy))
    d = np.abs(sc.ap_shifts - sh.ap_shifts).max(-1)
    out["ap_shift_max"] = float(d.max())
    out["ap_shifts_over_1e-3"] = int((d > 1e-3).sum())
    out["ap_shifts_within_1e-3"] = float((d <= 1e-3).mean())
    out["ap_shifts_within_tol"] = float((d <= AP_CPU_TOL).mean())
    out["image"] = float(np.abs(ic - ih).max())
    n = len(sc.quality)
    n_keep = max(int(round(n * 0.5)), 1)
    selc = np.sort(np.argsort(-sc.ap_quality, axis=0)[:n_keep], axis=0)
    selh = np.sort(np.argsort(-sh.ap_quality, axis=0)[:n_keep], axis=0)
    ties, picks = True, 0
    for a in np.nonzero((selc != selh).any(0))[0]:
        picks += 1
        edge = np.sort(sh.ap_quality[:, a])[::-1][n_keep - 1:n_keep + 1]
        ties &= abs(edge[0] / edge[1] - 1) <= 1e-5
    out["selection_differs"] = picks
    out["selection_near_ties"] = bool(ties)
    # MLC on the same windows (the CPU's stage-B windows of the first 8
    # frames), on both devices
    a = pm.MPPArgs()
    S, half = a.ap_size, a.ap_size // 2
    H, W = sh.reference.shape
    oy = torch.tensor([int(np.clip(int(y) - half, 0, H - S))
                       for _, y in sh.ap_xy])
    ox = torch.tensor([int(np.clip(int(x) - half, 0, W - S))
                       for x, _ in sh.ap_xy])
    from siril_tpu_torch.planetary.mlc import blur_gauss
    from siril_tpu_torch.planetary.source import frame_chunks

    (_, fr), = list(frame_chunks(seq, np.arange(8), 0, 8, "cpu"))
    gs = torch.from_numpy(sh.global_shifts[:8].astype(np.float32))
    _, big = pm.stage_b_windows(fr, gs, oy, ox, a)
    refb = blur_gauss(torch.from_numpy(sh.reference)[None],
                      a.gauss_width)[0]
    refs = torch.stack([refb[y:y + S, x:x + S] for y, x in zip(
        oy.tolist(), ox.tolist())])
    p1 = refs[:, ::2, ::2].contiguous()
    A = len(oy)
    tidx = torch.arange(A).repeat(8)
    core = pm.stage_b_mlc(a)
    rc = [t.cpu() for t in core(big.cuda(), refs.cuda(), p1.cuda(),
                                tidx.cuda(), surfaces=True)]
    rh = core(big, refs, p1, tidx, surfaces=True)
    same_int = (torch.round(rc[0]) == torch.round(rh[0])) & \
        (torch.round(rc[1]) == torch.round(rh[1]))
    out["mlc_success_equal"] = bool(torch.equal(rc[2], rh[2]))
    out["mlc_integer_differs"] = int((~same_int).sum())
    out["mlc_subpixel"] = float(torch.maximum(
        (rc[0] - rh[0]).abs(), (rc[1] - rh[1]).abs())[same_int].max())
    out["mlc_surfaces"] = max(float((rc[3] - rh[3]).abs().max()),
                              float((rc[4] - rh[4]).abs().max()))
    tie = True
    for b in torch.nonzero(~same_int)[:, 0].tolist():
        # the two devices' peaks tie on each device's own surface: phase
        # 1, and phase 2 where phase 1 agreed
        for k in (3, 4):
            ic = int(torch.argmax(rc[k][b]))
            ih = int(torch.argmax(rh[k][b]))
            for surf in (rc[k][b].flatten(), rh[k][b].flatten()):
                tie &= abs(float(surf[ic] - surf[ih])) <= 1e-6
            if ic != ih:
                break
    out["mlc_differences_are_ties"] = bool(tie)
    return out


def planetary_timings(root: str) -> dict:
    """ms per PLANET_W × PLANET_H frame (CUDA events, median of 3) of the
    quality pass, the phase correlation, stage B and MLC's share of it,
    and stage C, on one chunk of 64 frames of the resident video."""
    import numpy as np
    import torch

    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.planetary import mpp as pm
    from siril_tpu_torch.planetary.quality import quality_core
    from siril_tpu_torch.planetary.source import frame_chunks
    from siril_tpu_torch.registration.shift import phase_correlate_device

    st = pm.MPPState.load(os.path.join(root, "planet.mpp"))
    seq = Sequence.from_ser(os.path.join(root, "planet.ser"))
    nb = min(64, seq.number)
    (idx, fr), = list(frame_chunks(seq, np.arange(nb), 0, nb, CARD))
    a = pm.MPPArgs()
    S, half = a.ap_size, a.ap_size // 2
    H, W = st.reference.shape
    oy = torch.tensor([int(np.clip(int(y) - half, 0, H - S))
                       for _, y in st.ap_xy], device=CARD)
    ox = torch.tensor([int(np.clip(int(x) - half, 0, W - S))
                       for x, _ in st.ap_xy], device=CARD)
    from siril_tpu_torch.planetary.mlc import blur_gauss

    refb = blur_gauss(torch.from_numpy(st.reference).to(CARD)[None],
                      a.gauss_width)[0]
    refs = torch.stack([refb[y:y + S, x:x + S] for y, x in zip(
        oy.tolist(), ox.tolist())])
    p1 = refs[:, ::2, ::2].contiguous()
    gs = torch.from_numpy(st.global_shifts[:nb].astype(np.float32)).to(CARD)
    A = len(oy)
    _, big = pm.stage_b_windows(fr, gs, oy, ox, a)
    tidx = torch.arange(A, device=CARD).repeat(nb)
    core = pm.stage_b_mlc(a)
    sel = torch.ones(nb, A, device=CARD)
    iy = oy[None].expand(nb, -1).contiguous()
    ix = ox[None].expand(nb, -1).contiguous()
    res = torch.zeros(nb, A, 2, device=CARD)
    acc = torch.zeros(A, S, S, device=CARD)
    ms = dict(
        quality=_events_ms(lambda: quality_core(fr), 3),
        phase_correlation=_events_ms(
            lambda: phase_correlate_device(fr[0], fr), 3),
        stage_b=_events_ms(lambda: pm.shift_stage(fr, gs, refs, p1, oy, ox,
                                                  a), 3),
        mlc=_events_ms(lambda: core(big, refs, p1, tidx), 3),
        stage_c=_events_ms(lambda: pm.stack_stage(acc, fr, gs, iy, ix, res,
                                                  sel), 3))
    return {k: v / nb for k, v in ms.items()}


def phase_planetary(seed: int):
    """The planetary session (PLANETARY_SCRIPT) through the CLI's -s entry
    on planet_video's SER: each command's seconds and peak device memory;
    planetary_checks against the truth; the card against the CPU
    (planetary_vs_cpu); the stages timed (planetary_timings).  Returns
    (rows, checks, card rows, timings)."""
    from siril_tpu_torch import cli

    root = tempfile.mkdtemp(prefix="chip_smoke_planetary_")
    try:
        t = time.perf_counter()
        truth = planet_video(root, seed)
        log(f"  {PLANET_FRAMES} frames of {PLANET_W}×{PLANET_H} rendered "
            f"on the card and written as a 16-bit SER, and the three "
            f"channels, in {time.perf_counter() - t:.2f}s")
        with open(os.path.join(root, "planetary.ssf"), "w") as f:
            f.write(PLANETARY_SCRIPT)
        t = time.perf_counter()
        session = cli.run(["-d", root, "-s",
                           os.path.join(root, "planetary.ssf")])
        log(f"  planetary.ssf: {time.perf_counter() - t:.2f}s")
        rows = {}
        for row in session.command_log:
            rows[row["command"]] = row
            log(f"    {row['command']}: {row['seconds']:.3f}s, peak "
                f"{row['peak_mib'] or 0:.0f} MiB" + (
                    " (" + ", ".join(f"{k} {v:.3f}s" for k, v in
                                     row["stages"].items()) + ")"
                    if row["stages"] else ""))
        t = time.perf_counter()
        checks, vals = planetary_checks(root, truth)
        log(f"  checks: {time.perf_counter() - t:.2f}s; " + json.dumps(
            vals))
        t = time.perf_counter()
        cmp_ = planetary_vs_cpu(root, seed)
        log(f"  card vs cpu: {time.perf_counter() - t:.2f}s; "
            + json.dumps(cmp_))
        checks[f"card vs CPU: quality within 1e-5 relative "
               f"({cmp_['quality']:.3g}), same order"] = \
            cmp_["quality"] <= 1e-5 and cmp_["quality_order"]
        checks[f"card vs CPU: phase correlation within 1e-3 px "
               f"({cmp_['global']:.3g})"] = cmp_["global"] <= 1e-3
        checks["card vs CPU: MLC on the same windows, the same successes "
               f"and integer shifts but ties ({cmp_['mlc_integer_differs']}"
               f" differ), sub-pixel within 1e-3 px "
               f"({cmp_['mlc_subpixel']:.3g})"] = \
            cmp_["mlc_success_equal"] and cmp_["mlc_differences_are_ties"] \
            and cmp_["mlc_subpixel"] <= 1e-3
        checks[f"card vs CPU: AP shifts within 1e-3 px on "
               f"{cmp_['ap_shifts_within_1e-3']:.4f} of the solves (≥ "
               f"{AP_CPU_SHARE}), within {AP_CPU_TOL} px on "
               f"{cmp_['ap_shifts_within_tol']:.4f} (≥ {AP_CPU_TOL_SHARE};"
               f" the largest {cmp_['ap_shift_max']:.3g})"] = \
            cmp_["ap_shifts_within_1e-3"] >= AP_CPU_SHARE and \
            cmp_["ap_shifts_within_tol"] >= AP_CPU_TOL_SHARE
        checks[f"card vs CPU: the stacked image within {IMAGE_CPU_TOL:g} "
               f"({cmp_['image']:.3g})"] = cmp_["image"] <= IMAGE_CPU_TOL
        checks[f"card vs CPU: differing frame picks are near ties "
               f"({cmp_['selection_differs']} APs)"] = \
            cmp_["selection_near_ties"]
        timings = planetary_timings(root)
        log("  ms per frame (CUDA events, one chunk of 64): " + ", ".join(
            f"{k} {v:.3f}" for k, v in timings.items()))
        log("planetary: " + json.dumps(dict(
            commands={k: dict(seconds=v["seconds"], peak_mib=v["peak_mib"])
                      for k, v in rows.items()},
            checks=checks, values=vals, card_vs_cpu=cmp_, ms=timings),
            default=str))
        failed = [k for k, ok in checks.items() if not ok]
        for k in checks:
            log(f"  check planetary: {k}: "
                f"{'FAILED' if k in failed else 'ok'}")
        if failed:
            raise RuntimeError(f"planetary checks failed: {failed}")
        return rows, checks, cmp_, timings
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    against the same 8-bit frames written as FITS; camera-raw lights of
    every container at a real sensor size, converted (formats_raw), and
    the save commands' round trips (formats_roundtrip).  Returns ({path:
    K1 launches}, {command: row}, timings)."""
    import multiprocessing

    fmt = os.path.join(script_dir, "formats")
    os.makedirs(fmt)
    # the host work of the camera-raw part and the round trips runs in
    # worker processes beside the phase's FITS parts (formats_start)
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        pending = formats_start(seed, fmt, pool)
        return _phase_formats(seed, script_dir, fmt, pending)
    finally:
        pool.terminate()
        pool.join()


def _phase_formats(seed: int, script_dir: str, fmt: str, pending: dict):
    import numpy as np

    from siril_tpu_torch import native
    from siril_tpu_torch.core.image import DOUBLE_IMG
    from siril_tpu_torch.io import fits_compress as fc
    from siril_tpu_torch.io.fits_io import read_fits, write_fits

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
    t = time.perf_counter()
    formats_raw(pending, fmt, rows, checks, timings)
    log(f"  camera raw, decoders, round trips: {time.perf_counter() - t:.2f}"
        "s past the FITS parts")
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        log(f"  check formats: {k}: FAILED")
    if failed:
        raise RuntimeError(f"formats checks failed: {failed}")
    return launches, rows, timings


#: the formats phase's camera-raw lights: RAW_LIGHTS of each container at
#: a real sensor size (RAW_W × RAW_H, 14-bit RGGB; ORF's packing holds 12
#: bits), and the native decoders' streams (DECODER_SIDE² against the
#: Python decoders, full size for their rate)
RAW_W, RAW_H = 6000, 4000
RAW_LIGHTS = 2
RAW_CONTAINERS = ("nef", "arw", "dng", "rw2", "orf", "pef")
DECODER_SIDE = 512
#: the save commands' round trips: the uncompressed writers at ROUND_SIZE²,
#: PNG, deflate TIFF and XISF (zlib at its default level) at ROUND_CROP²
ROUND_SIZE = 4096
ROUND_CROP = 1024
#: Nikon's lossless 14-bit Huffman tree (tree 5): 16 code-length counts
#: and the leaves (the category of the difference)
NIKON_TREE5 = ([0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0],
               [7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14])
#: the lossless JPEG encoder's table: category → code length
LJPEG_LENGTHS = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _pack_bits(vals, lens, pad_ones: bool = False) -> bytes:
    """The MSB-first bit stream of ``vals`` (each ``lens`` bits, ≤ 32),
    vectorized through 64-bit words; the last byte padded with 1s or 0s."""
    import numpy as np

    vals = np.asarray(vals, np.uint64)
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens
    total = int(ends[-1]) if len(ends) else 0
    words = np.zeros(total // 64 + 2, np.uint64)
    w = starts // 64
    sh = 64 - starts % 64 - lens
    fits = sh >= 0
    a = np.where(fits, vals << np.clip(sh, 0, 63).astype(np.uint64),
                 vals >> np.clip(-sh, 0, 63).astype(np.uint64))
    first = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
    words[w[first]] |= np.bitwise_or.reduceat(a, first)
    sp = ~fits
    words[w[sp] + 1] |= vals[sp] << (64 + sh[sp]).astype(np.uint64)
    out = words.byteswap().tobytes()[:(total + 7) // 8]
    if pad_ones and total % 8:
        out = out[:-1] + bytes([out[-1] | ((1 << (8 - total % 8)) - 1)])
    return out


def _canonical(counts, leaves):
    """{leaf: (length, code)} of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            codes[leaves[k]] = (ln, code)
            code += 1
            k += 1
        code <<= 1
    return codes


def _categories(diff):
    """The bit length of |diff| (JPEG's SSSS), vectorized."""
    import numpy as np

    a = np.abs(diff.astype(np.int64))
    return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(
        np.int64) + 1)


def _huff_symbols(diff, codes, extra_limit: int = 16):
    """(values, lengths) of the Huffman code of each difference's category
    followed by its extra bits (JPEG's: the value, or value − 1 + 2^t
    when negative)."""
    import numpy as np

    t = _categories(diff)
    t = np.where(diff == -32768, 16, t)
    lut_len = np.zeros(17, np.int64)
    lut_code = np.zeros(17, np.uint64)
    for cat, (ln, c) in codes.items():
        lut_len[cat] = ln
        lut_code[cat] = c
    te = np.where((t == 0) | (t >= extra_limit), 0, t)
    d = diff.astype(np.int64)
    extra = np.where(d >= 0, d, d + (1 << te) - 1) & ((1 << te) - 1)
    vals = (lut_code[t] << te.astype(np.uint64)) | extra.astype(np.uint64)
    return vals, lut_len[t] + te


def encode_ljpeg(img, precision: int = 16) -> bytes:
    """A one-component lossless JPEG (SOF3, predictor 1) of (H, W) uint16
    ``img``, vectorized: the differences against the left pixel (the
    first column against the one above, the first pixel against
    2^(precision−1)), Huffman-coded with LJPEG_LENGTHS, 0xFF bytes
    stuffed."""
    import struct

    import numpy as np

    h, w = img.shape
    x = img.astype(np.int64)
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    diff = ((x - pred + 32768) & 0xFFFF) - 32768
    counts = [0] * 16
    for ln in LJPEG_LENGTHS:
        counts[ln - 1] += 1
    order = sorted(range(17), key=lambda i: (LJPEG_LENGTHS[i], i))
    codes = _canonical(counts, order)
    vals, lens = _huff_symbols(diff.ravel(), codes)
    body = np.frombuffer(_pack_bits(vals, lens, pad_ones=True), np.uint8)
    ff = np.flatnonzero(body == 0xFF)
    body = np.insert(body, ff + 1, 0).tobytes()
    head = b"\xff\xd8"
    dht = bytes([0x00]) + bytes(counts) + bytes(order)
    head += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0])
    head += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    sos = bytes([1, 1, 0x00, 1, 0, 0])
    head += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    return head + body + b"\xff\xd9"


def encode_nikon(img):
    """A Nikon lossless 14-bit Huffman stream (tree 5) of (H, W) uint16
    ``img``, vectorized: each pixel against the one two columns left, the
    first two columns against the row two above (the first two rows
    against 2048).  Returns (stream, vpred)."""
    import numpy as np

    vpred = np.full(4, 2048, np.uint16)
    x = img.astype(np.int64)
    pred = np.empty_like(x)
    pred[:, 2:] = x[:, :-2]
    pred[2:, :2] = x[:-2, :2]
    pred[:2, :2] = 2048
    diff = x - pred
    codes = _canonical(*NIKON_TREE5)
    vals, lens = _huff_symbols(diff.ravel(), codes)
    return _pack_bits(vals, lens), vpred


def _ifd(entries, heap_off: int, next_off: int = 0):
    """A little-endian TIFF IFD of (tag, type, values) entries (type 2:
    a string, 3: SHORT, 4: LONG, 1: BYTE) and its heap at ``heap_off``."""
    import struct

    heap = bytearray()
    out = struct.pack("<H", len(entries))
    for tag, typ, vals in sorted(entries):
        if typ == 2:
            data, n = vals.encode() + b"\0", len(vals) + 1
        else:
            fmt = {1: "B", 3: "H", 4: "I"}[typ]
            data, n = struct.pack("<%d%s" % (len(vals), fmt), *vals), \
                len(vals)
        if len(data) <= 4:
            val = data.ljust(4, b"\0")
        else:
            val = struct.pack("<I", heap_off + len(heap))
            heap += data
            heap += b"\0" * (len(heap) & 1)
        out += struct.pack("<HHI", tag, typ, n) + val
    return out + struct.pack("<I", next_off), bytes(heap)


def _tiff_file(path: str, magic: bytes, ifd0, raw_ifd, blob: bytes,
               strip_tag: int = 273) -> None:
    """header | IFD0 | its heap | the raw IFD (``raw_ifd`` None: the
    pixels' tags are IFD0's) | its heap | the pixels.  Offsets resolved in
    two passes; a SubIFD (330) entry points at the raw IFD."""
    import struct

    def layout(pix_off, raw_off):
        e0 = [e for e in ifd0]
        if raw_ifd is None:
            e0 = e0 + [(strip_tag, 4, [pix_off])]
        else:
            e0 = e0 + [(330, 4, [raw_off])]
        b0, h0 = _ifd(e0, 8 + 2 + 12 * len(e0) + 4)
        off = 8 + len(b0) + len(h0)
        b1 = h1 = b""
        if raw_ifd is not None:
            e1 = raw_ifd + [(strip_tag, 4, [pix_off])]
            b1, h1 = _ifd(e1, off + 2 + 12 * len(e1) + 4)
        return b0 + h0, off, b1 + h1

    head, raw_off, tail = layout(0, 0)
    pix_off = raw_off + len(tail)
    head, raw_off, tail = layout(pix_off, raw_off)
    with open(path, "wb") as f:
        f.write(magic + struct.pack("<I", 8) + head + tail)
        f.write(blob)


def raw_sensor(seed: int, w: int, h: int, bits: int = 14):
    """A natural 14-bit RGGB mosaic rendered on the host (numpy, for the
    worker processes): a sky gradient, stars, per-channel levels, noise;
    (h, w) uint16."""
    import numpy as np

    g = np.random.default_rng(seed + 61)
    top = (1 << bits) - 1
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    img = (0.06 + 0.03 * xx / w + 0.02 * np.sin(yy / h * 3.0)).astype(
        np.float32) * np.ones((h, w), np.float32)
    n, r = 3000, 5
    cx, cy = g.random(n) * w, g.random(n) * h
    amp = 0.02 + 0.8 * g.random(n) ** 3
    o = np.arange(-r, r + 1)
    px = np.floor(cx).astype(int)[:, None, None] + o[None, None, :]
    py = np.floor(cy).astype(int)[:, None, None] + o[None, :, None]
    val = amp[:, None, None] * np.exp(
        -((px + 0.5 - cx[:, None, None]) ** 2 +
          (py + 0.5 - cy[:, None, None]) ** 2) / (2 * 1.6 ** 2))
    px, py = np.broadcast_to(px, val.shape), np.broadcast_to(py, val.shape)
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    np.add.at(img.reshape(-1), (py * w + px)[inb], val[inb].astype(
        np.float32))
    img[0::2, 0::2] *= 1.3
    img[1::2, 1::2] *= 0.8
    img += 0.004 * g.standard_normal((h, w), dtype=np.float32)
    return np.clip(np.rint(img * top + 512), 0, top).astype("<u2")


def _write_raw_lights(d: str, seed: int, w: int, h: int, n: int):
    """In a worker process: n lights of each RAW_CONTAINERS in ``d``,
    and one read of each container timed.  Returns the sensors, {path:
    (light, black, white)} and {container: ms}."""
    import numpy as np

    from siril_tpu_torch.io.conversion import load_any

    t = time.perf_counter()
    sensors = [raw_sensor(seed + 10 * k, w, h) for k in range(n)]
    made = {}
    for k, sensor in enumerate(sensors):
        for kind in RAW_CONTAINERS:
            p = os.path.join(d, f"{kind}_{k + 1}.{kind}")
            _, black, white = write_raw_light(p, kind, sensor)
            made[p] = (k, black, white)
    write_s = time.perf_counter() - t
    read_ms = {}
    for kind in RAW_CONTAINERS:
        t = time.perf_counter()
        load_any(os.path.join(d, f"{kind}_1.{kind}"))
        read_ms[kind] = (time.perf_counter() - t) * 1e3
    return sensors, made, write_s, read_ms


def _roundtrip_job(d: str, seed: int, size: int, crop: int):
    """``formats_roundtrip`` in a worker process: (checks, timings)."""
    checks, timings = {}, {}
    formats_roundtrip(seed, d, checks, timings, size, crop)
    return checks, timings


def write_raw_light(path: str, kind: str, sensor) -> tuple:
    """``sensor`` (14-bit) in the container ``kind``; returns the stored
    values and the reader's (black, white)."""
    import numpy as np

    h, w = sensor.shape
    cfa = (1, 4, [0, 1, 1, 2])
    if kind == "nef":
        q = sensor.astype(np.uint32).reshape(-1, 4)
        out = np.empty((len(q), 7), np.uint8)
        out[:, 0] = q[:, 0] & 0xFF
        out[:, 1] = ((q[:, 0] >> 8) & 0x3F) | ((q[:, 1] & 0x03) << 6)
        out[:, 2] = (q[:, 1] >> 2) & 0xFF
        out[:, 3] = ((q[:, 1] >> 10) & 0x0F) | ((q[:, 2] & 0x0F) << 4)
        out[:, 4] = (q[:, 2] >> 4) & 0xFF
        out[:, 5] = ((q[:, 2] >> 12) & 0x03) | ((q[:, 3] & 0x3F) << 2)
        out[:, 6] = q[:, 3] >> 6
        blob = out.tobytes()
        ifd0 = [(271, 2, "NIKON CORPORATION"), (272, 2, "Z 7II")]
        raw = [(256, 4, [w]), (257, 4, [h]), (258, 3, [14]), (259, 3, [1]),
               (262, 3, [32803]), (279, 4, [len(blob)]), (278, 4, [h]),
               (33422, *cfa[1:])]
        _tiff_file(path, b"II*\0", ifd0, raw, blob)
        return sensor, 0.0, 16383.0
    if kind in ("arw", "pef"):
        blob = sensor.astype("<u2").tobytes()
        ifd0 = [(271, 2, "SONY" if kind == "arw" else "PENTAX"),
                (272, 2, "ILCE-7RM4" if kind == "arw" else "K-1")]
        raw = [(256, 4, [w]), (257, 4, [h]), (258, 3, [14]), (259, 3, [1]),
               (262, 3, [32803]), (279, 4, [len(blob)]), (278, 4, [h]),
               (33422, *cfa[1:])]
        if kind == "arw":
            _tiff_file(path, b"II*\0", ifd0, raw, blob)
            return sensor, 512.0, 16383.0
        _tiff_file(path, b"II*\0", ifd0 + raw, None, blob)
        return sensor, 0.0, 16383.0
    if kind == "dng":
        blob = sensor.astype("<u2").tobytes()
        ifd0 = [(271, 2, "testmake"), (272, 2, "testcam")]
        raw = [(256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]),
               (262, 3, [32803]), (279, 4, [len(blob)]), (278, 4, [h]),
               (33421, 3, [2, 2]), (33422, *cfa[1:]), (50714, 3, [0]),
               (50717, 3, [16383])]
        _tiff_file(path, b"II*\0", ifd0, raw, blob)
        return sensor, 0.0, 16383.0
    if kind == "orf":
        v = (sensor >> 2).astype(np.uint16).ravel()
        trip = np.empty((len(v) // 2, 3), np.uint8)
        v0, v1 = v[0::2], v[1::2]
        trip[:, 0] = v0 & 0xFF
        trip[:, 1] = ((v0 >> 8) & 0xF) | ((v1 & 0xF) << 4)
        trip[:, 2] = v1 >> 4
        blob = trip.tobytes()
        ifd0 = [(256, 4, [w]), (257, 4, [h]), (258, 3, [12]), (259, 3, [1]),
                (262, 3, [32803]), (279, 4, [len(blob)]),
                (33422, *cfa[1:])]
        _tiff_file(path, b"IIRO", ifd0, None, blob)
        return v.reshape(h, w), 0.0, 4095.0
    if kind == "rw2":
        blob = sensor.astype("<u2").tobytes()
        ifd0 = [(0x0002, 3, [w]), (0x0003, 3, [h]), (0x0009, 3, [1]),
                (0x000A, 3, [14]), (0x0110, 2, "DC-S1R"),
                (0x0117, 4, [len(blob)])]
        _tiff_file(path, b"II\x55\0", ifd0, None, blob, strip_tag=0x0118)
        return sensor, 0.0, 16383.0
    raise ValueError(kind)


def _python_decode(kind: str, stream: bytes, side: int):
    """The port's Python decoder of ``kind`` on a side² stream (run in a
    worker process)."""
    import numpy as np

    from siril_tpu_torch.io import dng, rawfile

    t = time.perf_counter()
    if kind == "ljpeg":
        out = dng._ljpeg_decode_py(stream)[0]
    elif kind == "nikon":
        out = rawfile._nikon_decode_py(stream, side, side, 5,
                                       np.full(4, 2048, np.uint16), 0)
    else:
        out = rawfile._pana_bits_decode_py(stream, side, side)
    return np.asarray(out), time.perf_counter() - t


def _encode_full_ljpeg(sensor):
    t = time.perf_counter()
    return encode_ljpeg(sensor, 14), time.perf_counter() - t


def formats_start(seed: int, fmt: str, pool) -> dict:
    """Start the formats phase's host work in ``pool`` (worker processes),
    beside the phase's FITS parts: the camera-raw lights written (and
    one of each read), the save commands' round trips, the Python raw
    decoders on DECODER_SIDE² streams of chip_smoke's encoders, and a
    full-size lossless JPEG encoded.  Returns the pending work."""
    import numpy as np

    side = DECODER_SIDE
    small = raw_sensor(seed + 1, side, side)
    g = np.random.default_rng(seed + 71)
    streams = {"ljpeg": encode_ljpeg(small, 14),
               "nikon": encode_nikon(small)[0],
               "panasonic": g.integers(0, 256, side * side * 2).astype(
                   np.uint8).tobytes()}
    raw_dir = os.path.join(fmt, "camera")
    round_dir = os.path.join(fmt, "round")
    os.makedirs(raw_dir)
    os.makedirs(round_dir)
    return dict(
        raw_dir=raw_dir, small=small, streams=streams, g=g,
        raw=pool.apply_async(_write_raw_lights, (raw_dir, seed, RAW_W,
                                                 RAW_H, RAW_LIGHTS)),
        round=pool.apply_async(_roundtrip_job, (round_dir, seed, ROUND_SIZE,
                                                ROUND_CROP)),
        py={k: pool.apply_async(_python_decode, (k, s, side))
            for k, s in streams.items()},
        full=pool.apply_async(_encode_full_ljpeg, (raw_sensor(
            seed + 2, RAW_W, RAW_H),)))


def formats_raw(pending: dict, fmt: str, rows: dict, checks: dict,
                timings: dict) -> None:
    """The camera-raw lights (``formats_start``): ``convert`` of them all
    (each CFA value recovered exactly through the reader's black and
    white), ``convert -debayer`` and ``convertraw -debayer`` of the NEF
    pair (the port's demosaic of the converted CFA frames, the two
    commands' frames equal); the native decoders against the Python ones
    and their rates; the round trips' results."""
    import numpy as np

    from siril_tpu_torch import native
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.demosaic import debayer_image

    raw_dir = pending["raw_dir"]
    sensors, made, write_s, read_ms = pending["raw"].get(timeout=600)
    timings.update(raw_write_s=write_s, raw_read_ms=read_ms)
    mib = sum(os.path.getsize(p) for p in made) / 2 ** 20
    log(f"  {len(made)} camera-raw lights of {RAW_W}×{RAW_H} written "
        f"({mib:.0f} MiB) in {write_s:.2f}s (a worker process); readers, ms "
        "a light: " + ", ".join(f"{k} {v:.1f}" for k, v in read_ms.items()))
    _timed_cli(rows, raw_dir, "convert", "raw")
    key = "convert: every frame's CFA values recovered (all containers)"

    def check(i, p):
        # the written value normalised as the readers do, in float32:
        # (v − black) / (white − black), clipped to [0, 1]
        k, black, white = made[p]
        vals = sensors[k] >> 2 if p.endswith(".orf") else sensors[k]
        img = read_fits(os.path.join(raw_dir, f"raw_{i + 1:05d}.fit"))
        want = np.clip((vals.astype(np.float32) - np.float32(black))
                       / np.float32(white - black), 0.0, 1.0)
        ok = bool(np.array_equal(img.host()[0], want)) and \
            img.keywords.bayer_pattern == "RGGB"
        if not ok:
            log(f"  {os.path.basename(p)}: the values differ")
        return ok, img

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as tp:
        done = list(tp.map(check, range(len(made)), sorted(made)))
    checks[key] = all(ok for ok, _ in done)
    nef_cfa = {made[p][0]: img for p, (_, img) in zip(sorted(made), done)
               if p.endswith(".nef")}
    del done
    for f in os.listdir(raw_dir):
        if f.startswith("raw_"):
            os.unlink(os.path.join(raw_dir, f))
    # -debayer on the NEF pair, through convert and convertraw
    nef_dir = os.path.join(fmt, "nef")
    os.makedirs(nef_dir)
    for k in range(RAW_LIGHTS):
        os.rename(os.path.join(raw_dir, f"nef_{k + 1}.nef"),
                  os.path.join(nef_dir, f"nef_{k + 1}.nef"))
    shutil.rmtree(raw_dir)
    _timed_cli(rows, nef_dir, "convert", "deb", "-debayer", "-out=deb")
    _timed_cli(rows, nef_dir, "convertraw", "rawd", "-debayer", "-out=rawd")
    key = ("convert / convertraw -debayer: the demosaic of the converted "
           "CFA frames, the two equal")
    names = [os.path.join(nef_dir, d, f"{d}_{k + 1:05d}.fit")
             for k in range(RAW_LIGHTS) for d in ("deb", "rawd")]
    with ThreadPoolExecutor(4) as tp:
        outs = [x.host() for x in tp.map(read_fits, names)]
    checks[key] = True
    for k in range(RAW_LIGHTS):
        cfa = nef_cfa[k]
        want = debayer_image(SirilImage(data=cfa.host(),
                                        keywords=cfa.keywords),
                             device=CARD).host()
        a, b = outs[2 * k], outs[2 * k + 1]
        checks[key] &= a.shape == (3, RAW_H, RAW_W) and bool(
            np.array_equal(a, want)) and bool(np.array_equal(b, a))
    del outs
    shutil.rmtree(nef_dir)
    # the native decoders against the Python ones, and their rates
    side, streams, small = DECODER_SIDE, pending["streams"], \
        pending["small"]
    nat = {}
    for kind, s in streams.items():
        t = time.perf_counter()
        if kind == "ljpeg":
            out = native.decode_ljpeg(s)[0]
        elif kind == "nikon":
            out = native.decode_nikon(s, side, side, 5,
                                      np.full(4, 2048, np.uint16), 0)
        else:
            out = native.decode_panasonic(s, side, side)
        nat[kind] = (out, (time.perf_counter() - t) * 1e3)
    rates = {}
    for kind, fut in pending["py"].items():
        ref, py_s = fut.get(timeout=300)
        same = bool(np.array_equal(nat[kind][0], ref))
        if kind != "panasonic":
            same &= bool(np.array_equal(nat[kind][0], small))
        checks[f"native {kind} decoder bit-equal to the Python one "
               f"({side}²)"] = same
        rates[kind] = dict(native_ms=nat[kind][1], python_s=py_s,
                           mb_s=len(streams[kind]) / 1e6 /
                           (nat[kind][1] / 1e3), size=f"{side}²")
    big, enc_s = pending["full"].get(timeout=300)
    t = time.perf_counter()
    out = native.decode_ljpeg(big)[0]
    dt = time.perf_counter() - t
    rates["ljpeg"].update(full_mb_s=len(big) / 1e6 / dt, full_ms=dt * 1e3,
                          full_encode_s=enc_s)
    checks["native ljpeg decodes a full-size light"] = bool(
        out.shape == (RAW_H, RAW_W))
    pb = pending["g"].integers(0, 256, RAW_W * RAW_H * 2).astype(
        np.uint8).tobytes()
    t = time.perf_counter()
    native.decode_panasonic(pb, RAW_W, RAW_H)
    dt = time.perf_counter() - t
    rates["panasonic"].update(full_mb_s=len(pb) / 1e6 / dt,
                              full_ms=dt * 1e3)
    timings["decoders"] = rates
    log("  native decoders: " + json.dumps(rates))
    rc, rt = pending["round"].get(timeout=600)
    checks.update(rc)
    timings.update(rt)
    log("  writers, ms an image (a worker process; 4096² but PNG, deflate "
        f"TIFF and XISF at {ROUND_CROP}²): " + ", ".join(
            f"{k} {v:.1f}" for k, v in rt["writers_ms"].items()))
    log("  readers, ms an image: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rt["readers_ms"].items()))


def formats_roundtrip(seed: int, d: str, checks: dict, timings: dict,
                      size: int, crop: int) -> None:
    """In ``d``, on the host: an RGB image through savetif, savetif8,
    savetif32, savebmp and savepnm at size², savepng and savetif -deflate
    at crop²,
    then ``load``: each equal to to_u16 / to_u8 (float32 exactly for
    savetif32); XISF (zlib with shuffling) and IRIS .pic likewise; ms per
    image of each writer and reader."""
    import numpy as np

    from siril_tpu_torch import cli
    from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
    from siril_tpu_torch.io import internal_formats, xisf
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.io.fits_io import write_fits

    g = np.random.default_rng(seed + 81)
    n, c = size, crop
    ramp = np.linspace(0, 1, n, dtype=np.float32)
    img = np.stack([0.3 + 0.4 * ramp[None, :] + 0 * ramp[:, None],
                    0.2 + 0.5 * ramp[:, None] + 0 * ramp[None, :],
                    0.5 * (ramp[None, :] + ramp[:, None])])
    img = np.clip(img + 0.05 * g.standard_normal(img.shape,
                                                 dtype=np.float32),
                  -0.02, 1.02).astype(np.float32)
    write_fits(SirilImage(data=img), os.path.join(d, "rgb.fit"),
               bitdepth=FLOAT_IMG)
    write_fits(SirilImage(data=np.ascontiguousarray(img[:, :c, :c])),
               os.path.join(d, "crop.fit"), bitdepth=FLOAT_IMG)
    with open(os.path.join(d, "round.ssf"), "w") as f:
        f.write("load rgb\nsavetif a\nsavetif8 b\nsavetif32 c\nsavebmp d\n"
                "savepnm e\nload crop\nsavepng f\nsavetif g -deflate\n")
    s = cli.run(["-d", d, "--device", "cpu", "-s",
                 os.path.join(d, "round.ssf")])
    ms = {}
    for row in s.command_log:
        w0 = row["command"].split()[0]
        if w0.startswith("save"):
            key = w0 + (" -deflate" if "deflate" in row["command"] else "")
            ms[key] = row["seconds"] * 1e3
    full, crop = SirilImage(data=img), SirilImage(data=img[:, :c, :c])
    want = {"a.tif": full.to_u16() / np.float32(65535.0),
            "b.tif": full.to_u8() / np.float32(255.0),
            "c.tif": img, "d.bmp": full.to_u8() / np.float32(255.0),
            "e.ppm": full.to_u8() / np.float32(255.0),
            "f.png": crop.to_u16() / np.float32(65535.0),
            "g.tif": crop.to_u16() / np.float32(65535.0)}
    # XISF (Float32, zlib with shuffling) and .pic, written by the port
    t = time.perf_counter()
    xisf.write_xisf(crop, os.path.join(d, "h.xisf"), "Float32", True, True)
    ms["write_xisf zlib+sh"] = (time.perf_counter() - t) * 1e3
    want["h.xisf"] = crop.host()
    t = time.perf_counter()
    internal_formats.write_pic(full, os.path.join(d, "i.pic"))
    ms["write_pic"] = (time.perf_counter() - t) * 1e3
    want["i.pic"] = np.clip(img * 65535.0 + 0.5, 0, 65535).astype(
        np.uint16).astype(np.float32) / np.float32(65535.0)
    read = {}
    for name, w_ in want.items():
        t = time.perf_counter()
        back = load_any(os.path.join(d, name)).host()
        read[name] = (time.perf_counter() - t) * 1e3
        same = back.shape == w_.shape and bool(np.array_equal(
            back, w_.astype(np.float32)))
        checks[f"round trip {name}: equal"] = same
    timings["writers_ms"] = ms
    timings["readers_ms"] = read
    shutil.rmtree(d)


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
    from siril_tpu_torch.core.settings import get_settings

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
                # command sets: 2048 MB × the setmem ratio)
                rows_per = plan_blocks(out_h, out_w, 4, max(int(
                    2048 * min(get_settings().memory_ratio, 4.0)), 128))
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


# ---------------------------------------------------------------------------
# multidevice: the config-5 chain and the sharded fused step
# ---------------------------------------------------------------------------

#: the config-5 frame: the IMX455 full-frame sensor, 9576 × 6388 (61.2 MP)
SURVEY_W, SURVEY_H = 9576, 6388
#: the chain's frames (a survey stacks 1000: the row blocks are planned
#: for 1000 frames on this card, so each block is one a survey streams)
SURVEY_FRAMES = 12
SURVEY_PLANNED = 1000
SURVEY_STARS = 6000
SURVEY_NOISE = 0.01
#: the catalogue stars' colours through the channels as a camera sees
#: them; PCC undoes it
SURVEY_IMBALANCE = (1.12, 1.0, 0.91)
#: the chain's K1 calls held against the plain version (held_at_call)
SURVEY_HELD = 2
#: the solved WCS against the truth, RMS over the catalogue in the frame
SURVEY_WCS_TOL = 0.5
#: the sharded fused step: FRAMES 16-bit SIZE² frames, shifted by up to
#: FUSED_SHIFT px (the separable path's MARGIN is 8), or turned by up to
#: FUSED_TURN_DEG (the rotation rung), σ-clipped (as the JAX package's
#: sharded tests; the CPU's plain winsorized on the crop took 5 s); card
#: against CPU on FUSED_CROP²
FUSED_SHIFT = 6.0
FUSED_TURN_DEG = 0.5
FUSED_CROP = 256
FUSED_CPU_TOL = 1e-5
#: the share of the crop's pixels whose σ-clip may flip between the card
#: and the CPU: the rotation rung's cuFFT and pocketfft part by ~1e-7,
#: which moves a value across a clipping bound now and then (a flip moves
#: that pixel's mean by ~1e-3: 1.31e-3 on the H100)
FUSED_FLIP_SHARE = 1e-3
#: the largest |Δmean| of a flipped pixel: one value across a 3σ clip
#: moves its column's mean by about 3σ/(N − 1), 1.3e-3 at the noise's σ
#: 0.01 over 24 frames; this allows a column's σ up to three times the
#: noise (the rim of a star after a turn)
FUSED_FLIP_MAX = 4e-3


def start_group():
    """A world-1 process group on this host (NCCL for the card, gloo for
    the CPU's tensors), its rendezvous a FileStore in a temporary
    directory; ``destroy_process_group`` ends it."""
    import torch.distributed as dist

    d = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    backend = "cuda:nccl,cpu:gloo" if CARD == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{d}/store",
                            world_size=1, rank=0)
    return d


def survey_scene(seed: int, h: int, w: int, nstars: int, dev):
    """The chain's sky: ``nstars`` stars of known B−V through a TAN WCS
    centred on SKY_CENTRE at SKY_SCALE″/px, each channel the stars'
    ``bv_to_rgb`` colour × SURVEY_IMBALANCE on its sky, rendered on the
    card; the catalogue, the truth WCS and the stars."""
    import numpy as np
    import torch

    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.pcc import bv_to_rgb
    from siril_tpu_torch.ops.wcs import WCS

    rng = np.random.default_rng(seed)
    m = 48
    sx = rng.uniform(m, w - m, nstars)
    sy = rng.uniform(m, h - m, nstars)
    amp = np.minimum(0.05 + 0.02 * rng.pareto(1.5, nstars), 0.5)
    bv = rng.uniform(0.0, 1.2, nstars)
    th = np.radians(SKY_TURN)
    s = SKY_SCALE / 3600.0
    truth = WCS(crpix=(w / 2.0 + 0.5, h / 2.0 + 0.5), crval=SKY_CENTRE,
                cd=np.array([[-s * np.cos(th), s * np.sin(th)],
                             [s * np.sin(th), s * np.cos(th)]]), height=h)
    ra, dec = truth.pix2world(sx, sy)
    col = np.stack([bv_to_rgb(b) for b in bv], axis=1)
    scene = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    for c in range(3):
        scene[c] = _render_torch((h, w), 0.1 * (0.9 + 0.1 * c), sx, sy,
                                 amp * col[c] * SURVEY_IMBALANCE[c], dev,
                                 psf_s=1.5)
    cat = Catalog(ra=ra, dec=dec, mag=star_mags(amp), bv=bv)
    return scene, cat, truth, dict(sx=sx, sy=sy, amp=amp, h=h, w=w)


def survey_reader(scene, seed: int, gains, offsets):
    """``read_rows(frame, chan, y0, y1)``: rows of the scene through the
    frame's gain and offset, with noise and cosmic-ray hits (one in 40000
    pixels), seeded by (frame, channel, first row) and made on the card;
    returned on the host as a reader of files would."""
    import torch

    dev = scene.device

    def read_rows(k, c, y0, y1):
        g = torch.Generator(device=dev)
        g.manual_seed(((seed * 1009 + k) * 8 + c) * 100003 + y0)
        blk = scene[c, y0:y1] * gains[k] + offsets[k]
        blk += SURVEY_NOISE * torch.randn(blk.shape, generator=g,
                                          device=dev)
        hits = torch.randint(0, blk.numel(), (max(blk.numel() // 40000, 1),),
                             generator=g, device=dev)
        blk.view(-1)[hits] = 1.0
        return blk.clamp_(0.0, 1.0).cpu().numpy()

    return read_rows


def _star_gains(before, after, stars, n: int = 200):
    """``post_gains`` on a rectangle: the G-relative gains that took
    ``before`` to ``after`` on the n brightest stars at least 64 px
    inside."""
    import numpy as np

    sx, sy, amp, h, w = (stars[k] for k in ("sx", "sy", "amp", "h", "w"))
    ok = (sx > 64) & (sx < w - 64) & (sy > 64) & (sy < h - 64)
    idx = np.nonzero(ok)[0]
    idx = idx[np.argsort(amp[idx])[::-1][:n]]
    xi, yi = np.floor(sx[idx]).astype(int), np.floor(sy[idx]).astype(int)
    k = []
    for c in range(3):
        pin = before[c, yi, xi] - np.median(before[c, ::4, ::4])
        pout = after[c, yi, xi] - np.median(after[c, ::4, ::4])
        k.append(float(np.median(pout / pin)))
    return np.array(k) / k[1]


def phase_survey(seed: int, mesh, h: int = SURVEY_H, w: int = SURVEY_W,
                 n: int = SURVEY_FRAMES, nstars: int = SURVEY_STARS):
    """The config-5 chain (``survey_platesolve_pcc_stack``) on ``n`` RGB
    frames of h × w through the world-1 mesh: the stack against the known
    scene, the plate solution against the truth, the PCC gains against
    SURVEY_IMBALANCE, and SURVEY_HELD of its K1 calls held against the
    plain version.  Returns ({launches}, the held rows, the stages)."""
    import numpy as np
    import torch

    from siril_tpu_torch.astrometry.solver import SolveArgs
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING
    from siril_tpu_torch.parallel.sharding import mesh_device
    from siril_tpu_torch.parallel.survey import (
        plan_survey_rows,
        survey_platesolve_pcc_stack,
    )

    dev = mesh_device(mesh)
    t = time.perf_counter()
    scene, cat, truth, stars = survey_scene(seed + 71, h, w, nstars, dev)
    rng = np.random.default_rng(seed + 72)
    gains = np.concatenate([[1.0], rng.uniform(0.98, 1.02, n - 1)])
    offsets = np.concatenate([[0.0], rng.uniform(-0.02, 0.02, n - 1)])
    read_rows = survey_reader(scene, seed + 73, gains, offsets)
    torch.cuda.synchronize()
    log(f"  rendered the {w}x{h} RGB scene of {nstars} stars on the card "
        f"in {time.perf_counter() - t:.2f}s")
    rows_planned = plan_survey_rows(SURVEY_PLANNED, w, 1, device=dev)
    budget = rows_planned * n * w * 16
    log(f"  rows per block for {SURVEY_PLANNED} frames on this card: "
        f"{rows_planned} (budget {budget} B for {n} frames)")
    ra0, dec0 = truth.pix2world(np.array([w / 2.0]), np.array([h / 2.0]))
    args = SolveArgs(ra=float(ra0[0]) + 0.08, dec=float(dec0[0]) - 0.06,
                     pixel_scale=SKY_SCALE * 1.02, mag_limit=14.0)
    n_blocks = 3 * -(-h // min(rows_planned, h))
    held_at = {0, n_blocks // 2 + 1}
    k1.reset_counts()
    t = time.perf_counter()
    with k1_calls(lambda i: i in held_at) as calls:
        img, solve, sres = survey_platesolve_pcc_stack(
            read_rows, n, 3, h, w, mesh, cat, args,
            rtype=rj.WINSORIZED, mode=ADDITIVE_SCALING,
            budget_bytes_per_dev=budget)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in k1.launches.items() if v}
    log(f"  survey_platesolve_pcc_stack: {n} frames x 3 x {w}x{h} in "
        f"{wall:.2f}s; {sres.n_blocks} blocks of {sres.rows_per_block} rows, "
        f"K1 launches {launches}, rejected {sres.total_rejected}")
    log("    stages: " + ", ".join(f"{k} {v:.3f}s"
                                   for k, v in sres.stage_s.items()))
    out = sres.data
    want = scene.cpu().numpy()
    m = 48
    errs = [float(np.abs(out[c, m:-m, m:-m] - want[c, m:-m, m:-m]).mean())
            for c in range(3)]
    ok = {}
    ok["stack: interior mean |Δ| < noise/3 in each channel"] = \
        max(errs) < SURVEY_NOISE / 3
    ok["stack: rays rejected"] = sres.total_rejected[1] > 0
    ok[f"rows per block as planned for {SURVEY_PLANNED} frames"] = \
        sres.rows_per_block == min(rows_planned, h)
    ok["K1 launched once a block"] = sum(launches.values()) == sres.n_blocks
    log(f"  stack vs scene: interior mean |Δ| {errs} (noise "
        f"{SURVEY_NOISE})")
    ok["plate solved"] = solve is not None and img.wcs is not None
    if solve is not None:
        inside = (stars["sx"] > 64) & (stars["sx"] < w - 64) & \
            (stars["sy"] > 64) & (stars["sy"] < h - 64)
        xg, yg = truth.world2pix(cat.ra[inside], cat.dec[inside])
        xs, ys = solve.wcs.world2pix(cat.ra[inside], cat.dec[inside])
        rms = float(np.sqrt(np.mean((xs - xg) ** 2 + (ys - yg) ** 2)))
        log(f"  plate solution: scale {solve.scale_arcsec:.5f}″/px (truth "
            f"{SKY_SCALE}), RMS against the truth over {int(inside.sum())} "
            f"stars {rms:.4f} px (bound {SURVEY_WCS_TOL})")
        ok["solution within bound of the truth"] = rms < SURVEY_WCS_TOL
        ok["scale within 0.5 %"] = \
            abs(solve.scale_arcsec / SKY_SCALE - 1.0) < 5e-3
    ok["PCC applied"] = "PCC" in " ".join(img.history)
    g = _star_gains(np.clip(out, 0, 1), img.host(), stars)
    want_g = 1.0 / np.asarray(SURVEY_IMBALANCE)
    gerr = np.abs(g / want_g - 1.0)
    log(f"  pcc: gains R/G {g[0]:.4f} B/G {g[2]:.4f} against "
        f"{want_g[0]:.4f} / {want_g[2]:.4f} (off {gerr[0]:.4f}, "
        f"{gerr[2]:.4f}; bound {POST_GAIN_TOL})")
    ok["PCC gains against the imbalance"] = gerr.max() <= POST_GAIN_TOL
    ok["result finite, expected shape"] = \
        bool(np.isfinite(img.host()).all()) and img.host().shape == (3, h, w)
    del scene, want
    held = []
    for i in sorted(held_at):
        if i >= len(calls) or calls[i] is None:
            ok[f"block {i} captured"] = False
            continue
        a, kw, _ = calls[i]
        r = held_at_call(f"the survey's block {i}", "winsorized/addscale",
                         *a, kw)
        held.append(r)
        ok[f"block {i} bit-equal to the plain version"] = r["ok"]
    calls.clear()
    for k, good in ok.items():
        log(f"  check {k}: {'ok' if good else 'FAILED'}")
    if not all(ok.values()):
        raise RuntimeError("survey checks failed")
    return launches, held, dict(wall=wall, n_blocks=sres.n_blocks,
                                rows=sres.rows_per_block, **sres.stage_s)


def fused_frames(seed: int, n: int, size: int, route: str, dev):
    """``n`` raw int16 frames of a star scene on the card and their warp
    parameters in the fused step's layout: (n, 2) shifts (out(x) =
    in(x − d)) or (n, 5) rotations (p, q, tx, ty, flip) about the centre,
    with noise and hits; frame 0 is the reference."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sx, sy, amp = _star_field(rng, size, 4000)
    scene = _render_torch(size, 0.1, sx, sy, amp, dev)
    raw = torch.empty((n, size, size), dtype=torch.int16, device=dev)
    c = (size - 1) / 2.0
    if route == "shift":
        par = rng.uniform(-FUSED_SHIFT, FUSED_SHIFT, (n, 2))
        par[0] = 0.0
    else:
        # turned about the frame's centre c, then shifted a little
        th = np.radians(rng.uniform(-FUSED_TURN_DEG, FUSED_TURN_DEG, n))
        th[0] = 0.0
        par = np.zeros((n, 5))
        p, q = np.cos(th), np.sin(th)
        par[:, 0], par[:, 1] = p, q
        par[:, 2] = c - (p * c + q * c)
        par[:, 3] = c - (-q * c + p * c)
        par[1:, 2:4] += rng.uniform(-3, 3, (n - 1, 2))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for k in range(n):
        if route == "shift":
            fx, fy = sx - par[k, 0], sy - par[k, 1]
        else:
            # the rung samples the frame at R·u + t for the output pixel u
            # (R = [[p, q], [−q, p]], index coordinates; a star at x lies
            # on pixel x − 0.5), so the scene's star at u is there
            p, q, tx, ty = par[k, :4]
            ux, uy = sx - 0.5, sy - 0.5
            fx = p * ux + q * uy + tx + 0.5
            fy = -q * ux + p * uy + ty + 0.5
        f = _render_torch(size, 0.1, fx, fy, amp, dev)
        f += 0.01 * torch.randn(f.shape, generator=g, device=dev)
        hits = torch.randint(0, size * size, (size * size // 4000,),
                             generator=g, device=dev)
        f.view(-1)[hits] = 1.0
        raw[k] = (torch.round(f.clamp(0, 1) * 65535.0) - 32768.0).to(
            torch.int16)
    return scene, raw, torch.as_tensor(par, dtype=torch.float32,
                                       device=dev)


def phase_fused_step(seed: int, mesh, cpu_mesh, n: int = FRAMES,
                     size: int = SIZE):
    """``fused_pipeline_step`` through the world-1 mesh on ``n`` 16-bit
    size² frames, the shift route and the rotation rung: the result
    against the known scene, its K1 call held against the plain version
    on the same inputs (held_at_call), and the card against the CPU on
    the centre FUSED_CROP² of the same frames, the per-pixel rejection
    counts of the two K1 calls there included.  Returns ({route:
    launches}, rows, the held rows)."""
    import numpy as np
    import torch

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING
    from siril_tpu_torch.parallel.sharding import (
        fused_pipeline_step,
        mesh_device,
    )

    dev = mesh_device(mesh)
    launches, rows, ok, held = {}, {}, {}, []
    for route in ("shift", "rotation"):
        t = time.perf_counter()
        scene, raw, par = fused_frames(seed + (81 if route == "shift"
                                               else 82), n, size, route,
                                       dev)
        torch.cuda.synchronize()
        log(f"  {route}: rendered {n} 16-bit {size}² frames on the card in "
            f"{time.perf_counter() - t:.2f}s")
        kw = dict(shift_warp=route == "shift", rot_warp=route == "rotation")
        dark = torch.zeros((size, size), device=dev)
        flat = torch.ones((size, size), device=dev)
        step = fused_pipeline_step(mesh, rj.SIGMA, ADDITIVE_SCALING,
                                   3.0, 3.0, n, size, size, **kw)
        k1.reset_counts()
        t = time.perf_counter()
        with k1_calls() as calls:
            mean, rl, rh = step(raw, par, dark, flat, 0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[route] = {k: v for k, v in k1.launches.items() if v}
        out = mean.reshape(size, size).cpu().numpy()
        m = 64
        want = scene.cpu().numpy()
        err = float(np.abs(out[m:-m, m:-m] - want[m:-m, m:-m]).mean())
        log(f"  {route}: fused_pipeline_step {wall:.3f}s "
            f"({wall / n * 1e3:.2f} ms a frame), K1 launches "
            f"{launches[route]}, rejected {int(rl)}/{int(rh)}, interior "
            f"mean |Δ| vs scene {err:.5f} (noise 0.01)")
        ok[f"{route}: interior mean |Δ| < noise/3"] = err < 0.01 / 3
        ok[f"{route}: rays rejected"] = int(rh) > 0
        ok[f"{route}: K1 launched once"] = \
            sum(launches[route].values()) == len(calls) == 1
        # the step's K1 call on its own inputs against the plain version
        a, ckw, _ = calls[0]
        calls.clear()
        r = held_at_call(f"the fused step's call, {route}", "sigma/addscale",
                         *a, ckw)
        held.append(r)
        ok[f"{route}: its K1 call bit-equal to the plain version"] = r["ok"]
        del a, ckw
        # the card against the CPU on the centre crop of the same frames,
        # and the two K1 calls' per-pixel counts there
        a = (size - FUSED_CROP) // 2
        crop = np.s_[:, a:a + FUSED_CROP, a:a + FUSED_CROP]
        cstep = [fused_pipeline_step(msh, rj.SIGMA, ADDITIVE_SCALING,
                                     3.0, 3.0, n, FUSED_CROP, FUSED_CROP,
                                     **kw) for msh in (mesh, cpu_mesh)]
        with k1_calls() as calls:
            got = cstep[0](raw[crop].contiguous(), par, dark[crop[1:]]
                           .contiguous(), flat[crop[1:]].contiguous(), 0)
            cpu = cstep[1](raw[crop].cpu(), par.cpu(),
                           dark[crop[1:]].cpu(), flat[crop[1:]].cpu(), 0)
        (_, _, (_, gl, gh)), (_, _, (_, cl, ch)) = calls
        calls.clear()
        gl, gh = gl.cpu(), gh.cpu()
        dm = (got[0].cpu() - cpu[0]).abs()
        d = float(dm.max())
        past = dm > FUSED_CPU_TOL
        flips = int(past.sum())
        flip_max = float(dm[past].max()) if flips else 0.0
        counts_apart = (gl != cl) | (gh != ch)
        totals = [(int(got[1]), int(got[2])), (int(cpu[1]), int(cpu[2]))]
        log(f"  {route}: card vs CPU on {FUSED_CROP}² max |Δmean| {d:.3g}, "
            f"{flips} pixels past {FUSED_CPU_TOL} (largest {flip_max:.3g}),"
            f" {int(counts_apart.sum())} with other rejection counts "
            f"({int(counts_apart[past].sum())} of them past it); "
            f"rejections {totals[0][0]}/{totals[0][1]} vs "
            f"{totals[1][0]}/{totals[1][1]}")
        ok[f"{route}: the step's totals are its K1 call's counts"] = \
            totals == [(int(gl.sum()), int(gh.sum())),
                       (int(cl.sum()), int(ch.sum()))]
        if route == "shift":
            ok["shift: card vs CPU bit-equal, same counts at every pixel"] \
                = d == 0.0 and not bool(counts_apart.any())
        else:
            ok[f"{route}: card vs CPU within {FUSED_CPU_TOL} but on "
               f"{FUSED_FLIP_SHARE:.0e} of the pixels (clips flipped by "
               f"FFT rounding)"] = flips <= FUSED_FLIP_SHARE * dm.numel()
            ok[f"{route}: a flipped pixel's |Δmean| ≤ {FUSED_FLIP_MAX}"] = \
                flip_max <= FUSED_FLIP_MAX
            ok[f"{route}: the same rejection counts at every pixel within "
               f"{FUSED_CPU_TOL}"] = not bool((counts_apart & ~past).any())
        rows[f"{route} card vs CPU"] = dict(
            max_abs=d, flips=flips, flip_max=flip_max,
            counts_apart=int(counts_apart.sum()), totals=totals)
        rows[route] = dict(seconds=wall, ms_per_frame=wall / n * 1e3,
                           err=err)
        del scene, raw, mean
        torch.cuda.empty_cache()
    for k, good in ok.items():
        log(f"  check {k}: {'ok' if good else 'FAILED'}")
    if not all(ok.values()):
        raise RuntimeError("fused step checks failed")
    return launches, rows, held


def phase_multidevice(seed: int):
    """The world-1 group and its meshes (the card's over NCCL, a CPU one
    over gloo for the comparisons), then the config-5 chain and the
    sharded fused step; the group is destroyed whatever happens."""
    import torch.distributed as dist

    from siril_tpu_torch.parallel.sharding import make_mesh

    store = start_group()
    try:
        mesh = make_mesh(1, 1, device_type=CARD)
        cpu_mesh = make_mesh(1, 1, device_type="cpu")
        log(f"  process group: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}; mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}")
        survey = phase_survey(seed, mesh)
        fused = phase_fused_step(seed, mesh, cpu_mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return survey, fused


# ---------------------------------------------------------------------------
# live: live stacking, seqexport and the sequence and header commands
# ---------------------------------------------------------------------------

#: lights of the live stack: LIVE_DROPPED dropped into the watched
#: directory by a thread, the rest through ``livestack <file>``
LIVE_LIGHTS = 8
LIVE_DROPPED = 5
LIVE_POLL = 0.05
#: pp_light frames exported (4 for the live phase's 20 s: PERF.md §4),
#: and the crop (x, y, w, h)
EXPORT_FRAMES = 4
EXPORT_CROP = (1024, 768, 1536, 1280)
EXPORT_FORMATS = ("fits", "fitseq", "ser", "tiff", "avi")
#: the sequence commands' frames: float32 crops of the night's scene
SEQCMD_SIZE = 2048
SEQCMD_FRAMES = (8, 4)
SEQCMD_SCRIPT = """requires 1.2.0
load_seq a_
select a_ 0 7
unselect a_ 6 7
setref a_ 3
getref a_
select b_ 0 3
seqheader a_ EXPTIME
sequpdate_key a_ OBSERVER chip_smoke
sequpdate_key b_ GPSLAT 48.5
seqgps b_
seqheader b_ GPSLAT
seqclean a_ -sel
merge a_ b_ ab_
stackall rej 3 3 -norm=addscale
calibrate raw -bias=../process/bias_stacked -dark=../process/pp_dark_stacked -flat=../process/pp_flat_stacked -cc=dark
calibrate_single raw_00001.fit -bias=../process/bias_stacked -dark=../process/pp_dark_stacked -flat=../process/pp_flat_stacked -cc=dark -prefix=single_
mirrorx_single raw_00002
jsonmetadata ab_00001.fit -out=meta.json
load ab_00001
dumpheader
update_key FIELD m42
parse out_$FIELD$_$EXPTIME:%d$s
boxselect 10 20 300 400
gps
"""


def live_lights(night: dict, seed: int, size: int, n: int, dev):
    """``n`` raw 16-bit lights of the night's scene as synth_session makes
    them (bias, dark with hot pixels, vignetting, noise, hits), shifted
    by whole pixels (the live stacker's shift route rounds); light 0 is
    the reference.  Returns the uint16 frames on the host and the
    shifts."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ar = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    c = size / 2.0
    vig = 1.0 - 0.3 * ((xx + 0.5 - c) ** 2 + (yy + 0.5 - c) ** 2) / \
        (2 * c * c)
    base = torch.as_tensor(night["bias"] + night["dark"], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out, shifts = [], [(0, 0)]
    shifts += [tuple(int(v) for v in rng.integers(-12, 13, 2))
               for _ in range(n - 1)]
    for dx, dy in shifts:
        f = base + vig * _render_torch(size, 0.1, night["sx"] + dx,
                                       night["sy"] + dy, night["amp"], dev)
        f += night["sigma_n"] * torch.randn(f.shape, generator=g,
                                            device=dev)
        hits = torch.randint(0, size * size, (size * size // 40000,),
                             generator=g, device=dev)
        f.view(-1)[hits] = 1.0
        out.append(torch.round(f.clamp(0, 1) * 65535.0).to(torch.int32)
                   .cpu().numpy().astype(np.uint16))
    return out, shifts


def _exported(path, fmt):
    """The frames of an exported file, [0, 1] float (H, W) arrays."""
    from siril_tpu_torch.io.avi import AviReader
    from siril_tpu_torch.io.fits_io import image_hdus, read_fits
    from siril_tpu_torch.io.image_formats import read_tiff
    from siril_tpu_torch.io.ser import SerFile

    if fmt == "fits":
        return [read_fits(p).data[0] for p in path]
    if fmt == "tiff":
        return [read_tiff(p).data[0] for p in path]
    p = path[0]
    if fmt == "fitseq":
        return [read_fits(p, i).data[0] for i in range(len(image_hdus(p)))]
    if fmt == "ser":
        f = SerFile(p)
        return [f.read_frame(i).data[0] for i in range(f.frame_count)]
    r = AviReader(p)
    return [r.read_frame(i).data[0] for i in range(r.nframes)]


def host_norm_estimators(f):
    """The plain host reference of the stack's normalization estimators
    (``ops.statistics.norm_estimators``; normalization.c:98-142) for one
    frame, in numpy: the IKSSlite location (the median of the non-zero
    finite pixels within 6 MAD of their median) and the biweight
    midvariance scale, its sums in float64.  Returns (location, scale)."""
    import numpy as np

    x = f[(f != 0) & np.isfinite(f)].ravel()
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    w = x[(x >= med - 6.0 * np.float64(mad))
          & (x <= med + 6.0 * np.float64(mad))]
    loc = np.median(w)
    d = w - loc
    y2 = np.square(d / np.float32(9.0 * np.median(np.abs(d))))
    np.minimum(y2, 1.0, out=y2)
    om = 1.0 - y2
    up = (d * om * om).astype(np.float64)
    dn = np.sum(om * (1.0 - 5.0 * y2), dtype=np.float64)
    return float(loc), float(np.sqrt(w.size * np.dot(up, up) / dn ** 2)
                             * 0.991)


def phase_live(seed: int, root: str, night: dict, size: int = SIZE):
    """In the script phase's directory ``root``: live stacking of
    LIVE_LIGHTS lights through start_ls / livestack / stop_ls with the
    night's masters, against the known scene; seqexport of EXPORT_FRAMES
    pp_light frames (shift-only registration in a .seq) to each of
    EXPORT_FORMATS with -normalize -crop=, read back and held against
    the frames, and -format=mp4 (OpenCV); then SEQCMD_SCRIPT's sequence
    and header commands through -s, each result checked.  Returns
    (stackall's K1 launches, rows)."""
    import importlib.util
    import logging as _logging
    import threading

    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.context import CommandError
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.fits_io import read_fits, write_fits
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        compute_normalization,
    )

    dev = torch.device(CARD)
    proc = os.path.join(root, "process")
    ok, rows = {}, {}
    # the plain host estimators of the reference and the last exported
    # frame, on threads from the start (seqexport's coefficients from the
    # card are held against them)
    norm_held = (0, EXPORT_FRAMES - 1)
    host_est = {}

    def estimate(k):
        host_est[k] = host_norm_estimators(read_fits(os.path.join(
            proc, f"pp_light_{k + 1:05d}.fit")).data[0])

    est_threads = [threading.Thread(target=estimate, args=(k,))
                   for k in norm_held]
    for th in est_threads:
        th.start()
    # --- live stacking ------------------------------------------------
    live, extra, masters = (os.path.join(root, d) for d in
                            ("live", "live_extra", "live_masters"))
    for d in (live, extra, masters):
        os.makedirs(d, exist_ok=True)
    dark = read_fits(os.path.join(proc, "bias_stacked.fit")).data + \
        read_fits(os.path.join(proc, "pp_dark_stacked.fit")).data
    write_fits(SirilImage(data=dark.astype(np.float32)),
               os.path.join(masters, "dark_bias.fit"), bitdepth=-32)
    t = time.perf_counter()
    lights, shifts = live_lights(night, seed + 91, size, LIVE_LIGHTS, dev)
    for k in range(LIVE_DROPPED, LIVE_LIGHTS):
        write_later(write_u16_fits,
                    os.path.join(extra, f"light_{k + 1:05d}.fit"), lights[k])
    writes_done()
    log(f"  rendered {LIVE_LIGHTS} lights of {size}² in "
        f"{time.perf_counter() - t:.2f}s, shifts {shifts}")
    t = time.perf_counter()
    session = cli.run(["-d", live, "start_ls", "-dark=../live_masters/"
                       "dark_bias", "-flat=../process/pp_flat_stacked"])
    ls = session.livestacker
    ls.cfg.poll_s = LIVE_POLL

    def drop(k):
        p = os.path.join(live, f"light_{k + 1:05d}.fit")
        write_u16_fits(p + ".part", lights[k])
        os.replace(p + ".part", p)

    def wait_for(count, timeout=120.0):
        end = time.monotonic() + timeout
        while ls.count + ls.failed < count and time.monotonic() < end:
            time.sleep(0.01)

    drop(0)
    wait_for(1)
    dropper = threading.Thread(target=lambda: [drop(k) for k in
                                               range(1, LIVE_DROPPED)])
    dropper.start()
    dropper.join()
    wait_for(LIVE_DROPPED)
    for k in range(LIVE_DROPPED, LIVE_LIGHTS):
        COMMANDS["livestack"].fn(session,
                                 [f"../live_extra/light_{k + 1:05d}.fit"])
    COMMANDS["stop_ls"].fn(session, [])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = read_fits(os.path.join(live, "live_stack_result.fit")).data[0]
    m = 64
    err = float(np.abs(res[m:-m, m:-m] - night["scene"][m:-m, m:-m]).mean())
    ms = sorted(ls.frame_ms)
    rows["live"] = dict(seconds=wall, frames=ls.count, failed=ls.failed,
                        ms_per_frame=ms, median_ms=ms[len(ms) // 2])
    log(f"  live stack: {ls.count} frames ({ls.failed} failed) in "
        f"{wall:.2f}s; ms a frame (read to sum) {[round(v, 1) for v in ms]}"
        f", median {ms[len(ms) // 2]:.1f}; interior mean |Δ| vs scene "
        f"{err:.5f} (noise {night['sigma_n']})")
    ok["live: every light stacked"] = (ls.count, ls.failed) == \
        (LIVE_LIGHTS, 0)
    ok["live: interior mean |Δ| < noise/3"] = err < night["sigma_n"] / 3
    # --- seqexport ------------------------------------------------------
    exp = os.path.join(root, "export")
    os.makedirs(exp, exist_ok=True)
    for i in range(EXPORT_FRAMES):
        os.link(os.path.join(proc, f"pp_light_{i + 1:05d}.fit"),
                os.path.join(exp, f"pp_light_{i + 1:05d}.fit"))
    seq = Sequence.scan("pp_light_", exp)
    rs = np.random.default_rng(seed + 92)
    d = np.concatenate([[[0.0, 0.0]], rs.uniform(-6, 6, (EXPORT_FRAMES - 1,
                                                           2))])
    reg = seq.reg(0)
    reg.H[:] = np.eye(3)
    reg.H[:, :2, 2] = d
    reg.valid[:] = True
    seq.reference_image = 0
    seq.save()
    whole = np.rint(d).astype(int)
    cx, cy, cw, ch = EXPORT_CROP
    crop = ",".join(str(v) for v in EXPORT_CROP)
    # what each exported frame should hold: the frame moved by its whole
    # shift, x·scale − offset where x > 0 with the coefficients of the
    # normalization (on the card, as the export takes them), cropped,
    # clipped; within half a step of the written format
    cseq = read_seqfile(os.path.join(exp, "pp_light_.seq"))
    co = compute_normalization(cseq, np.arange(EXPORT_FRAMES),
                               ADDITIVE_SCALING, device=CARD)
    want = []
    for k in range(EXPORT_FRAMES):
        f = read_fits(os.path.join(exp, f"pp_light_{k + 1:05d}.fit")).data[0]
        sx, sy = whole[k]
        x = np.zeros_like(f)
        h, w = x.shape
        x[max(0, sy):min(h, h + sy), max(0, sx):min(w, w + sx)] = \
            f[max(0, -sy):min(h, h - sy), max(0, -sx):min(w, w - sx)]
        v = np.where(x > 0, x * np.float32(co.scale[0, k])
                     - np.float32(co.offset[0, k]), x)
        want.append(np.clip(v[cy:cy + ch, cx:cx + cw], 0.0, 1.0))
    for fmt in EXPORT_FORMATS:
        t = time.perf_counter()
        COMMANDS["seqexport"].fn(cli.Session(cwd=exp, device=CARD), [
            "pp_light_", f"out_{fmt}", f"-format={fmt}", "-normalize",
            f"-crop={crop}"])
        dt = time.perf_counter() - t
        names = sorted(f for f in os.listdir(exp)
                       if f.startswith(f"out_{fmt}"))
        got = _exported([os.path.join(exp, f) for f in names], fmt)
        step = 1 / 255 if fmt == "avi" else 1 / 65535
        worst = max(float(np.abs(y - e).max()) / step
                    for y, e in zip(got, want))
        rows[f"seqexport {fmt}"] = dict(seconds=dt, frames=len(got),
                                        worst_steps=worst)
        log(f"  seqexport -format={fmt} -normalize -crop={crop}: {dt:.2f}s, "
            f"{len(got)} frames of {got[0].shape if got else None}; "
            f"against the shifted, normalized, cropped frames: largest "
            f"|Δ| {worst:.4f} steps of 1/{round(1 / step)}")
        ok[f"seqexport {fmt}: every frame, the crop's size"] = \
            len(got) == EXPORT_FRAMES and got[0].shape == (ch, cw)
        ok[f"seqexport {fmt}: within half a step of the frames"] = \
            worst <= 0.5 + 0.02
    for th in est_threads:
        th.join()
    (l0, s0), (lk, sk) = (host_est[k] for k in norm_held)
    k = norm_held[1]
    card_est = [cseq.get_frame_stats(0, i) for i in norm_held]
    est_err = max(max(abs(st.location / hl - 1.0), abs(st.scale / hs - 1.0))
                  for st, (hl, hs) in zip(card_est, (host_est[i] for i in
                                                     norm_held)))
    scale_k = s0 / sk
    co_err = (abs(co.scale[0, k] / scale_k - 1.0),
              abs(co.offset[0, k] - (scale_k * lk - l0)))
    log(f"  seqexport's normalization on the card against the host "
        f"estimators of frames {norm_held}: estimators within "
        f"{est_err:.3g} (relative), frame {k}'s scale within "
        f"{co_err[0]:.3g} (relative), offset within {co_err[1]:.3g}")
    ok["seqexport: the card's estimators within 1e-5 of the host's"] = \
        est_err <= 1e-5
    ok["seqexport: the card's coefficients within 2e-5 of the host's"] = \
        bool(max(co_err) <= 2e-5)
    have_cv2 = importlib.util.find_spec("cv2") is not None
    try:
        COMMANDS["seqexport"].fn(cli.Session(cwd=exp, device=CARD), [
            "pp_light_", "out_mp4", "-format=mp4"])
        ok["seqexport mp4 (OpenCV installed)"] = have_cv2 and \
            os.path.exists(os.path.join(exp, "out_mp4.mp4"))
    except RuntimeError as e:
        log(f"  seqexport -format=mp4: {e}")
        ok["seqexport mp4 without OpenCV: the error names cv2"] = \
            not have_cv2 and "cv2" in str(e) and \
            not any(f.startswith("out_mp4") for f in os.listdir(exp))
    # --- the sequence and header commands -------------------------------
    sd = os.path.join(root, "seqcmds")
    os.makedirs(sd, exist_ok=True)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 93)
    scene = night["scene"][:SEQCMD_SIZE, :SEQCMD_SIZE]
    st = torch.as_tensor(scene, device=dev)
    for name, count in zip(("a_", "b_"), SEQCMD_FRAMES):
        for i in range(count):
            f = st + night["sigma_n"] * torch.randn(st.shape, generator=g,
                                                    device=dev)
            hits = torch.randint(0, st.numel(), (st.numel() // 4000,),
                                 generator=g, device=dev)
            f.view(-1)[hits] = 1.0
            write_later(write_f32_fits, os.path.join(
                sd, f"{name}{i + 1:05d}.fit"), f.clamp(0, 1).cpu().numpy())
    for i in (1, 2):
        shutil.copy(os.path.join(root, "lights", f"light_{i:05d}.fit"),
                    os.path.join(sd, f"raw_{i:05d}.fit"))
    writes_done()
    before = read_fits(os.path.join(sd, "raw_00002.fit")).data
    with open(os.path.join(sd, "seqcmds.ssf"), "w") as f:
        f.write(SEQCMD_SCRIPT)
    lines = []

    class Keep(_logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep(_logging.INFO)
    lg = _logging.getLogger("siril_tpu_torch.cli")
    lg.addHandler(keep)
    level = lg.level
    lg.setLevel(_logging.INFO)
    k1.reset_counts()
    t = time.perf_counter()
    try:
        session = cli.run(["-d", sd, "-s", os.path.join(sd, "seqcmds.ssf")])
        torch.cuda.synchronize()
    finally:
        lg.removeHandler(keep)
        lg.setLevel(level)
    wall = time.perf_counter() - t
    launches = {k: v for k, v in k1.launches.items() if v}
    _log_rows(session, rows)
    log(f"  the sequence and header commands: {wall:.2f}s, K1 launches "
        f"{launches}")
    a_ = read_seqfile(os.path.join(sd, "a_.seq"))
    ab = read_seqfile(os.path.join(sd, "ab_.seq"))
    kw_a = read_fits(os.path.join(sd, "a_00003.fit")).keywords
    kw_b = read_fits(os.path.join(sd, "b_00002.fit")).keywords
    stacks = {n: read_fits(os.path.join(sd, f"{n}stacked.fit"))
              for n in ("a_", "b_", "ab_")}
    mm = 48
    serr = float(np.abs(stacks["ab_"].data[0][mm:-mm, mm:-mm]
                        - scene[mm:-mm, mm:-mm]).mean())
    pp = read_fits(os.path.join(sd, "pp_raw_00001.fit")).data
    single = read_fits(os.path.join(sd, "single_raw_00001.fit")).data
    after = read_fits(os.path.join(sd, "raw_00002.fit")).data
    meta = json.load(open(os.path.join(sd, "meta.json")))
    log(f"  ab_ stack vs scene: interior mean |Δ| {serr:.5f}; stack counts "
        f"{ {n: s.keywords.stackcnt for n, s in stacks.items()} }; "
        f"calibrate_single vs calibrate max |Δ| "
        f"{float(np.abs(single - pp).max()):.3g}")
    checks = {
        "getref logs frame 3": "reference image of sequence: 3" in lines,
        "a_.seq: reference 3, every frame selected after seqclean -sel":
            a_.reference_image == 2 and bool(a_.incl.all()),
        "merge: 12 frames in ab_": ab.number == 12,
        "sequpdate_key wrote OBSERVER":
            kw_a.observer == "chip_smoke" or
            kw_a.extra.get("OBSERVER") == "chip_smoke",
        "sequpdate_key wrote GPSLAT": kw_b.extra.get("GPSLAT") == 48.5,
        "seqgps counted b_'s frames": "seqgps: GPS data in 4/4 frames"
        in lines,
        "seqheader logged every selected frame":
            sum(1 for s in lines if s.split("\t")[0].isdigit()) == 6 + 4,
        "stackall: a stack of each sequence": [
            stacks[n].keywords.stackcnt for n in ("a_", "b_", "ab_")] ==
            [8, 4, 12],
        "stackall: ab_ within noise/3 of the scene":
            serr < night["sigma_n"] / 3,
        "stackall launched K1 for each sequence":
            sum(launches.values()) >= 3,
        "calibrate_single equals calibrate": bool(np.array_equal(single,
                                                                 pp)),
        "mirrorx_single flipped the file": bool(np.array_equal(
            after, before[:, ::-1, :])),
        "jsonmetadata": (meta["width"], meta["height"], meta["channels"],
                         len(meta["statistics"])) ==
            (SEQCMD_SIZE, SEQCMD_SIZE, 1, 1),
        "dumpheader": any(s.startswith("NAXIS1  =") for s in lines),
        "update_key + parse": "out_m42_60s" in lines,
        "boxselect": session.selection == (10, 20, 300, 400),
        "gps": "No GPS data found in this image" in lines,
    }
    try:
        COMMANDS["seqstarnet"].fn(session, ["a_"])
        checks["seqstarnet raises"] = False
    except CommandError as e:
        checks["seqstarnet raises"] = "StarNet" in str(e)
    ok.update(checks)
    rows["seqcmds"] = dict(seconds=wall, launches=launches)
    for k, good in ok.items():
        log(f"  check {k}: {'ok' if good else 'FAILED'}")
    if not all(ok.values()):
        raise RuntimeError("live checks failed")
    for d in (live, extra, masters, exp, sd):
        shutil.rmtree(d, ignore_errors=True)
    return launches, rows


SESSION_LIGHTS = 8
#: the compute probe's call (compute_probe.py's defaults but the count of
#: iterations, cut from 3 to 2 for room)
PROBE_N, PROBE_ITERS = 8, 2
PROBE_STAGES = ("sum", "calib", "stats", "cand", "detect", "warp", "est",
                "stack", "nodetect", "full")
#: an RGB image's channel gains (the load / undo / pyscript image)
SESSION_RGB = (1.0, 0.8, 0.6)
PYSCRIPT = """import json, sys, time
import numpy as np
t0 = time.perf_counter()
px = siril.get_image_pixeldata()
t1 = time.perf_counter()
half = np.ascontiguousarray(px * np.float32(0.5))
siril.set_image_pixeldata(half)
t2 = time.perf_counter()
back = siril.get_image_pixeldata()
siril.cmd("stack", "light_", "rej", "3", "3", "-norm=addscale",
          "-out=py_stack")
t3 = time.perf_counter()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "siril_tpu", "torch"))
json.dump(dict(get_ms=(t1 - t0) * 1e3, set_ms=(t2 - t1) * 1e3,
               stack_s=t3 - t2, shape=list(px.shape), modules=bad,
               sum_in=float(px.sum(dtype=np.float64)),
               back_equal=bool(np.array_equal(back, half))),
          open(sys.argv[1], "w"))
"""


class _Feed:
    """The pipe's input: command lines, and before the one marked with an
    event, a wait for that event (the second stack's first row block)."""

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        import threading

        for it in self.items:
            if isinstance(it, threading.Event):
                if not it.wait(120):
                    raise RuntimeError("the stack to cancel never started")
                continue
            yield it + "\n"


def _k1a_only(k1) -> int:
    """K1a's launch count; the session's stacks of 8 frames launch no
    other variant."""
    other = {v: n for v, n in k1.launches.items() if v != "K1a" and n}
    if other:
        raise RuntimeError(f"the session launched other K1 variants: "
                           f"{other}")
    return k1.launches.get("K1a", 0)


def _pipe_run(session, items):
    """``cli.pipe_loop`` on ``session`` fed ``items``: (its output lines,
    seconds)."""
    import io

    from siril_tpu_torch.cli import pipe_loop

    out = io.StringIO()
    t = time.perf_counter()
    pipe_loop(session, _Feed(items), out)
    return out.getvalue().splitlines(), time.perf_counter() - t


def phase_session(seed: int, size: int = SIZE):
    """The session surface at full width (see the module's docstring):
    the pipe, pyscript, the compute probe ladder, a traced fusedstack and
    precompile.  Returns (K1a launches by path, the probe's held call)."""
    import threading

    import numpy as np
    import torch

    from siril_tpu_torch import cli
    from siril_tpu_torch.core import processing
    from siril_tpu_torch.core import undo as undo_mod
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import read_fits, write_fits
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops import stacking as st
    from siril_tpu_torch.tools import compute_probe
    from siril_tpu_torch.utils import trace

    launches, checks, timings = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    try:
        t = time.perf_counter()
        scene, u16s, shifts, sigma_n, ray = synth_frames(
            seed + 7, SESSION_LIGHTS, size)
        for i, u in enumerate(u16s):
            write_later(write_u16_fits,
                        os.path.join(tmp, f"light_{i + 1:05d}.fit"), u)
        rgb = np.stack([scene * np.float32(g) for g in SESSION_RGB])
        write_fits(SirilImage(data=rgb), os.path.join(tmp, "rgb.fit"),
                   bitdepth=-32)
        writes_done()
        del u16s
        with open(os.path.join(tmp, "s.py"), "w") as f:
            f.write(PYSCRIPT)
        log(f"  synthesized {SESSION_LIGHTS} lights and a {size}² RGB image "
            f"in {time.perf_counter() - t:.2f}s")

        # 1. the pipe: setmem, get -a, load / mirrorx / undo / redo, a
        # sequence command (progress), fusedstack, a cancelled stack,
        # pyscript, precompile
        spills = []
        real_spill = undo_mod.UndoStack._spill

        def timed_spill(self, img, desc):
            t0 = time.perf_counter()
            e = real_spill(self, img, desc)
            spills.append((time.perf_counter() - t0) * 1e3)
            return e

        started = threading.Event()
        real_read = st.read_block

        def reading(*a, **k):
            # the cancelled stack: its first row block waits (at most 30
            # s) for the pipe's cancel, so that the cancel lands mid-stack
            if not started.is_set():
                started.set()
                t0 = time.perf_counter()
                while processing.processing_should_continue() and \
                        time.perf_counter() - t0 < 30:
                    time.sleep(0.005)
            return real_read(*a, **k)

        session = cli.build_session(tmp)
        undo_mod.UndoStack._spill = timed_spill
        k1.reset_counts()
        try:
            lines, wall = _pipe_run(session, [
                "setmem 0.5", "get -a", "load rgb", "mirrorx", "undo",
                "redo", "seqcrop light_ 0 0 1024 1024",
                "fusedstack light_ -out=piped"])
            st.read_block = reading
            more, wall2 = _pipe_run(session, [
                "stack light_ rej 3 3 -norm=addscale -rejmaps", started,
                "cancel", "load piped", "load rgb",
                f"pyscript s.py {os.path.join(tmp, 'pyscript.json')}",
                "precompile 8 -rej=w"])
        finally:
            undo_mod.UndoStack._spill = real_spill
            st.read_block = real_read
        lines += more
        launches["session pipe"] = _k1a_only(k1)
        status = [ln for ln in lines if ln.startswith("status:")]
        progress = [ln for ln in lines if ln.startswith("progress:")]
        entry = {e["command"]: e for e in session.command_log}
        log(f"  pipe: {len(lines)} lines in {wall + wall2:.2f}s; status "
            f"{status}")
        log(f"  progress lines {progress}")
        for c, e in entry.items():
            log(f"  {c[:60]:<60} {e['seconds']:8.3f} s rc {e['rc']} "
                f"K1 {e['launches']}")
        log(f"  undo points: {len(spills)} spills of the {size}² RGB "
            f"image, ms each {[round(v, 1) for v in spills]}")
        timings["undo_point_ms"] = spills
        res = read_fits(os.path.join(tmp, "piped.fit")).host()[0]
        m = 48
        inner = np.s_[m:-m, m:-m]
        err = float(np.abs(res[inner] - scene[inner]).mean())
        py = json.load(open(os.path.join(tmp, "pyscript.json")))
        pyst = read_fits(os.path.join(tmp, "py_stack.fit")).host()
        log(f"  piped fusedstack: interior mean |Δ| vs scene {err:.5f} "
            f"(noise {sigma_n}), max {float(res.max()):.4f}")
        log(f"  pyscript: SHM get {py['get_ms']:.1f} ms, set "
            f"{py['set_ms']:.1f} ms ({size}² RGB float32, "
            f"{3 * size * size * 4 / 1e6:.0f} MB), stack through siril.cmd "
            f"{py['stack_s']:.2f} s; modules in the script {py['modules']}")
        timings.update(shm_get_ms=py["get_ms"], shm_set_ms=py["set_ms"])
        want = ["status: success setmem", "status: success get",
                "status: success load", "status: success mirrorx",
                "status: success undo", "status: success redo",
                "status: success seqcrop", "status: success fusedstack",
                "status: error stack", "status: success cancel",
                "status: success load", "status: success load",
                "status: success pyscript", "status: success precompile"]
        checks.update({
            "pipe status lines": status == want,
            "progress lines of seqcrop": progress == [
                f"progress: {(i + 1) / SESSION_LIGHTS:.2f}"
                for i in range(SESSION_LIGHTS)],
            "setmem reached the preferences":
                session.prefs.memory_ratio == 0.5,
            "undo points: mirrorx, undo, redo, the pyscript's write":
                len(spills) == 4,
            "the cancelled stack logged its cancel":
                "log: stack: cancelled" in lines,
            "piped fusedstack: interior mean |Δ| < noise/3":
                err < sigma_n / 3,
            "piped fusedstack: K1a launched":
                sum(entry["fusedstack light_ -out=piped"]["launches"]
                    .values()) > 0,
            "pyscript: the image read, halved and written back": False,
            "pyscript: its stack launched K1a":
                sum(entry["pyscript s.py " + os.path.join(
                    tmp, "pyscript.json")]["launches"].values()) > 0,
            "pyscript: the stack's result finite": bool(
                np.isfinite(pyst).all()) and pyst.shape == (1, size, size),
            "pyscript: the script loaded neither jax, siril_tpu nor "
            "torch": py["modules"] == [],
            "precompile found the library built":
                any("precompile: reject_stack already built" in ln
                    for ln in lines),
        })
        # the RGB image loaded again, read, halved and read back by the
        # script (its stack then became the loaded image)
        checks["pyscript: the image read, halved and written back"] = \
            py["shape"] == [3, size, size] and py["back_equal"] and \
            py["sum_in"] == float(rgb.sum(dtype=np.float64))
        del res, rgb

        # 2. the compute probe ladder at its call (K1a: N = 8, 4096², f32
        # winsorized / addscale); one K1 call held at its inputs
        torch.cuda.empty_cache()
        k1.reset_counts()
        with k1_calls(keep=lambda i: i == 0) as calls:
            ladder = compute_probe.device_stage_probe(
                PROBE_STAGES, n=PROBE_N, size=size, iters=PROBE_ITERS,
                seed=seed)
        launches["compute probe"] = _k1a_only(k1)
        for stage_name in PROBE_STAGES:
            d = ladder["details"].get(stage_name, {})
            log(f"  probe {stage_name:<9} "
                + (f"{d['compute_mpix_s']:>10.2f} Mpix/s (loop "
                   f"{d['t_loop_s']:.4f} s)" if "error" not in d
                   else f"ERROR {d.get('error')}"))
        log(f"  probe: empty synchronize {ladder['t_rtt_s'] * 1e6:.1f} µs, "
            f"K1a launches {launches['compute probe']}")
        timings["probe_mpix_s"] = ladder["stages_mpix_s"]
        checks["probe: every stage ran"] = set(
            ladder["stages_mpix_s"]) == set(PROBE_STAGES) and not any(
            "error" in d for d in ladder["details"].values())
        (args, kw, _), = [c for c in calls if c is not None]
        from siril_tpu_torch.ops import rejection as rj
        from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

        checks["probe: K1a called at N=8, 4096², f32 winsorized/addscale"] \
            = tuple(args[0].shape) == (PROBE_N, size * size) and \
            args[0].dtype == torch.float32 and \
            kw["rtype"] == rj.WINSORIZED and kw["mode"] == ADDITIVE_SCALING
        held = held_at_call("compute probe", "winsorized/addscale", *args,
                            kw)
        checks["probe: K1a bit-equal to its plain version at the call"] = \
            held["ok"]
        del calls, args
        torch.cuda.empty_cache()

        # 3. one fusedstack under the port's trace
        tdir = os.path.join(tmp, "trace")
        k1.reset_counts()
        trace.start_device_trace(tdir)
        t = time.perf_counter()
        try:
            cli.run(["-d", tmp, "fusedstack", "light_", "-out=traced"])
            torch.cuda.synchronize()
        finally:
            path = trace.stop_device_trace()
        traced_s = time.perf_counter() - t
        launches["traced fusedstack"] = _k1a_only(k1)
        busy = trace.busy_share(path)
        k1_names = sorted(n for n in busy["kernels"]
                          if REGISTER_KERNEL in n or "column_kernel" in n)
        log(f"  traced fusedstack {traced_s:.2f}s (trace written in it), "
            f"trace {os.path.getsize(path) / 1e6:.1f} MB: device busy "
            f"{busy['busy_s']:.3f} s of a {busy['window_s']:.3f} s window "
            f"= {100 * busy['share']:.1f} %, {len(busy['kernels'])} kernel "
            f"names, K1: {k1_names[:2]}")
        timings["traced_busy_share"] = busy["share"]
        checks.update({
            "trace names the K1 kernel": bool(k1_names),
            "traced fusedstack launched K1a":
                launches["traced fusedstack"] > 0,
        })
        for name, good in checks.items():
            log(f"  check {name}: {'ok' if good else 'FAILED'}")
        if not all(checks.values()):
            raise RuntimeError("session checks failed")
        return launches, held, timings
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
    with Phase("multidevice"):
        survey, fused = phase_multidevice(args.seed)
        survey_launches, survey_held, _ = survey
        fused_launches, _, fused_held = fused
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
        with Phase("analysis"):
            phase_analysis(args.seed)
        with Phase("planetary"):
            phase_planetary(args.seed)
        with Phase("formats"):
            formats_launches, _, _ = phase_formats(args.seed, script_root)
        with Phase("live"):
            stackall_launches, _ = phase_live(args.seed, script_root, night)
        del night
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
    with Phase("session"):
        session_launches, probe_held, _ = phase_session(args.seed)
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
                   **drizzle_launches, **formats_launches}.items()},
               "survey (sharded)": survey_launches.get("K1a", 0),
               "fused step (sharded)": sum(
                   c.get("K1a", 0) for c in fused_launches.values()),
               "stackall": stackall_launches.get("K1a", 0),
               **session_launches}
    # the multi-device paths' frame counts keep them on the register path
    col = survey_launches.get("K1col", 0) + stackall_launches.get(
        "K1col", 0) + sum(c.get("K1col", 0) for c in fused_launches.values())
    if col:
        raise RuntimeError(f"the multi-device paths launched K1col {col} "
                           f"times; its rows count only the stack commands")
    k1a["other_sizes"] = k1a.get("other_sizes", []) + survey_held + \
        fused_held + [probe_held]
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
    # call size, with its launches
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    cmd_of = {"winsorized": STACK100_RUNS[0][1],
              "gesdt": STACK100_RUNS[1][1]}
    for r in k1col:
        kernels.append(dict(
            name=f"reject_stack (K1col {r['label']}, N={r['n']}, "
                 f"P={r['p']}; plain version on {r['slice']} pixels)",
            launches=stack100[cmd_of[r["label"]]]["K1col"],
            replaces=f"{tpu}:763", **r))
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
