"""Device-resident compute probe — counterpart of
``siril_tpu/tools/compute_probe.py`` (``STAGE_FEATURES``:53, ``_probe_fn``
:67, ``device_compute_probe``:213, ``device_stage_probe``:245,
``main``:287).

It measures the fused chain's throughput on the card without host I/O:

  * the raw 16-bit frames, the per-frame shifts and the bias, dark and
    flat are made on the device with a ``torch.Generator`` seeded by the
    call's seed;
  * the requested stage subset of the chain — decode → calibrate →
    star-detection statistics / candidates / PSF fit → separable shift
    warp → normalization estimators → rejection stack — runs ``iters``
    times in an eager loop timed with CUDA events (one warm-up loop
    first, with another seed, as the JAX probe compiles on its first
    call);
  * ``t_rtt_s`` is one empty ``torch.cuda.synchronize`` on an idle card
    (there is no tunnel to subtract).

The host's triangle match is left out; the fixed per-frame shifts stand
in for its output.  The rest is the code of the port's fused path:
``ops/calibration.make_calibrate_kernel``, ``ops/statistics``,
``registration/starfinder``, ``ops/interp.warp_translation_batch`` and
the K1 kernel through ``kernels/reject_stack.reject_mean`` (winsorized,
additive+scaling by default) in the ``stack``, ``nodetect`` and ``full``
stages.  ``probe_iteration`` is one iteration on given inputs (tensors
or numpy arrays), with its intermediate results on request.

Stage ladder (cumulative unless noted):

  sum       one streaming read of the raw i16 stack
  calib     decode u16→f32 + bias/dark/flat calibration
  stats     + detection background/noise (medians)
  cand      + local-maxima candidates (max-pool + top-k)
  detect    + patch gather + batched LM PSF fit  (= full detection)
  warp      calib + separable lanczos4 shift warp      (detect skipped)
  est       calib + warp + IKSS normalization estimators
  stack     calib + rejection stack
  nodetect  calib + warp + est + stack
  full      everything
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

# feature sets per stage name; order here is the canonical ladder order
STAGE_FEATURES = {
    "sum": frozenset(),
    "calib": frozenset({"calib"}),
    "stats": frozenset({"calib", "stats"}),
    "cand": frozenset({"calib", "stats", "cand"}),
    "detect": frozenset({"calib", "stats", "cand", "fit"}),
    "warp": frozenset({"calib", "warp"}),
    "est": frozenset({"calib", "warp", "est"}),
    "stack": frozenset({"calib", "stack"}),
    "nodetect": frozenset({"calib", "warp", "est", "stack"}),
    "full": frozenset({"calib", "stats", "cand", "fit", "warp", "est",
                       "stack"}),
}

#: the candidates a frame keeps (the JAX probe's top-k)
MAX_CANDIDATES = 500


def make_inputs(n: int, size: int, seed: int, device) -> tuple:
    """(raw i16 (n, 1, H, W), shifts (n, 2) f32, bias, dark, flat (1, H,
    W)) made on ``device`` from ``seed``: uniform raw words, shifts
    uniform in [−3, 3), a 0.02 bias, a dark ramp and a vignetting flat,
    as the JAX probe makes them."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    H = W = size
    raw = torch.randint(-32768, 32767, (n, 1, H, W), generator=g,
                        device=dev, dtype=torch.int16)
    shifts = torch.rand((n, 2), generator=g, device=dev) * 6.0 - 3.0
    yy = torch.linspace(0.0, 1.0, H, device=dev)[:, None]
    xx = torch.linspace(0.0, 1.0, W, device=dev)[None, :]
    bias = torch.full((1, H, W), 0.02, device=dev)
    dark = 0.004 + 0.001 * (yy * xx)[None]
    flat = 1.0 - 0.2 * ((yy - 0.5) ** 2 + (xx - 0.5) ** 2)[None]
    return raw, shifts, bias, dark, flat


def _default_config(rtype, mode):
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    return (rj.WINSORIZED if rtype is None else rtype,
            ADDITIVE_SCALING if mode is None else mode)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def probe_iteration(i: int, raw, shifts, bias, dark, flat, stage: str,
                    rtype: Optional[int] = None, mode: Optional[int] = None,
                    device=None, parts: Optional[dict] = None
                    ) -> torch.Tensor:
    """One iteration of ``stage`` on the inputs (tensors or numpy
    arrays: raw i16 (n, 1, H, W), shifts (n, 2), bias / dark / flat (1,
    H, W)) on ``device`` (default: the raw tensor's, else CUDA): the
    scalar the JAX probe's ``one_iter`` sums.  ``parts``, when given,
    receives the intermediate results: ``calib`` (the calibrated
    frames), ``stats`` (medians and MADs,
    (2, n)), ``cand`` (candidate values), ``fit`` (the detection's
    stats and packed fits), ``warped``, ``scale`` / ``offset`` and
    ``stack`` (mean, rejected low and high per pixel)."""
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.ops.calibration import make_calibrate_kernel
    from siril_tpu_torch.ops.interp import (
        INTERP_LANCZOS4,
        warp_translation_batch,
    )
    from siril_tpu_torch.ops.statistics import median_rows, norm_estimators
    from siril_tpu_torch.registration.starfinder import (
        StarFinderParams,
        _candidates,
        detection_radius,
        stats_cand_fit,
    )

    if device is None and torch.is_tensor(raw):
        device = raw.device
    dev = resolve_device(device)
    rtype, mode = _default_config(rtype, mode)
    feats = STAGE_FEATURES[stage]
    parts = {} if parts is None else parts
    raw = _tensor(raw, dev, torch.int16)
    n, _, H, W = raw.shape
    # perturb the raw words with the loop index (int16 wraps, as in JAX)
    x16 = raw + torch.tensor(i, dtype=torch.int16, device=dev)
    if not feats:                               # "sum": a streaming read
        return x16.float().sum() * np.float32(1e-9)
    xf = (x16.float() + 32768.0) * np.float32(1.0 / 65535.0)
    calib = make_calibrate_kernel(True, True, True, False, False)
    xf = calib(xf, _tensor(bias, dev, torch.float32),
               _tensor(dark, dev, torch.float32), 1.0,
               _tensor(flat, dev, torch.float32), None)
    parts["calib"] = xf
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    p = StarFinderParams()
    R = detection_radius(H, W, p)
    if "fit" in feats:
        stats, vals, idx, fits = stats_cand_fit(
            xf[:, 0], R, MAX_CANDIDATES, float(p.sigma), int(p.profile))
        parts["fit"] = (stats, fits)
        acc = acc + stats.sum() + fits.sum()
    elif "stats" in feats:
        flat2 = xf[:, 0].reshape(n, -1)
        valid = torch.isfinite(flat2)
        med = median_rows(flat2, valid)
        mad = median_rows(torch.abs(flat2 - med[:, None]), valid)
        parts["stats"] = torch.stack([med, mad])
        acc = acc + med.sum() + mad.sum()
        if "cand" in feats:
            thrs = med + np.float32(p.sigma) * torch.clamp_min(
                1.4826 * mad, 1e-7)
            v = torch.stack([_candidates(xf[f, 0], thrs[f], R,
                                         MAX_CANDIDATES)[0]
                             for f in range(n)])
            parts["cand"] = v
            acc = acc + torch.where(torch.isfinite(v), v, 0.0).sum()
    if "stack" in feats and "warp" not in feats:
        scale = torch.ones(n, dtype=torch.float32, device=dev)
        offset = torch.zeros(n, dtype=torch.float32, device=dev)
        warped = xf
    elif "warp" in feats:
        sh = _tensor(shifts, "cpu", torch.float32).numpy() + \
            np.float32(1e-3) * np.float32(i)
        warped = warp_translation_batch(xf, sh, INTERP_LANCZOS4, clamp=True)
        parts["warped"] = warped
        if "est" in feats:
            est = norm_estimators(warped[:, 0].reshape(n, -1))
            s = est["scale"]
            scale = s[0] / torch.where(s == 0, 1.0, s)
            offset = scale * est["location"] - est["location"][0]
            parts["scale"], parts["offset"] = scale, offset
            if "stack" not in feats:
                return acc + scale.sum() + offset.sum()
        else:
            return acc + warped.sum() * np.float32(1e-9)
    else:                                       # calib / stats / cand / detect
        if "stats" not in feats:
            acc = acc + xf.sum() * np.float32(1e-9)
        return acc
    mean, rl, rh = k1.reject_mean(
        warped.reshape(n, -1).contiguous(), scale.contiguous(),
        offset.contiguous(), torch.ones(n, dtype=torch.float32, device=dev),
        rtype=rtype, mode=mode, siglow=3.0, sighigh=3.0)
    parts["stack"] = (mean, rl, rh)
    return acc + mean.sum() + rl.sum().float() + rh.sum().float()


def _status(msg: str) -> None:
    import sys

    print(f"[compute_probe] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure_rtt(dev: torch.device) -> float:
    """One empty synchronize on an idle device (0 on the CPU)."""
    if dev.type != "cuda":
        return 0.0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _loop(dev, n, size, iters, stage, seed, rtype, mode):
    """``iters`` iterations on inputs made from ``seed``: (checksum,
    seconds of the loop: CUDA events on a card, the host clock on the
    CPU)."""
    inputs = make_inputs(n, size, seed, dev)
    _sync(dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(iters):
        acc = acc + probe_iteration(i, *inputs, stage, rtype, mode, dev)
    if dev.type == "cuda":
        b.record()
        b.synchronize()
        dt = a.elapsed_time(b) * 1e-3
    else:
        dt = time.perf_counter() - t0
    del inputs
    return float(acc), dt


def _run_stage(dev, stage, n, size, iters, t_rtt, rtype, mode, seed):
    t0 = time.perf_counter()
    _loop(dev, n, size, iters, stage, seed, rtype, mode)       # warm-up
    _status(f"[{stage}] warm in {time.perf_counter() - t0:.1f}s")
    chk, t_loop = _loop(dev, n, size, iters, stage, seed + 1, rtype, mode)
    t_compute = max(t_loop - t_rtt, 1e-6)
    mpix = iters * n * size * size / 1e6
    return {
        "compute_mpix_s": round(mpix / t_compute, 2),
        "t_loop_s": round(t_loop, 6),
        "t_rtt_s": round(t_rtt, 6),
        "n": n, "size": size, "iters": iters, "stage": stage,
        "checksum": chk,
    }


def device_compute_probe(n: int = 8, size: int = 4096, iters: int = 3,
                         rtype: Optional[int] = None,
                         mode: Optional[int] = None, stage: str = "full",
                         device=None, seed: int = 0) -> dict:
    """Throughput of one stage on ``device`` (CUDA unless "cpu"):
    ``{"compute_mpix_s", "t_loop_s", "t_rtt_s", "n", "size", "iters",
    "stage", "checksum"}``."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rtype, mode = _default_config(rtype, mode)
    t_rtt = _measure_rtt(dev)
    _status(f"empty synchronize {t_rtt * 1e6:.1f} µs; {stage} probe "
            f"({n}x{size}²×{iters})")
    return _run_stage(dev, stage, n, size, iters, t_rtt, rtype, mode, seed)


def device_stage_probe(stages=tuple(STAGE_FEATURES), n: int = 8,
                       size: int = 4096, iters: int = 3,
                       rtype: Optional[int] = None,
                       mode: Optional[int] = None,
                       deadline_s: Optional[float] = None, device=None,
                       seed: int = 0) -> dict:
    """The stage ladder in one process: ``{"stages_mpix_s": {stage:
    rate}, "details": {stage: record}, "t_rtt_s", "n", "size",
    "iters"}``.  A stage that raises is recorded as ``{"error": …}`` in
    ``details`` (a caller that needs every stage checks for it); the
    ladder stops before a stage once ``deadline_s`` seconds have passed
    (``truncated_at``)."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rtype, mode = _default_config(rtype, mode)
    t_start = time.monotonic()
    t_rtt = _measure_rtt(dev)
    out: dict = {"stages_mpix_s": {}, "details": {},
                 "t_rtt_s": round(t_rtt, 6), "n": n, "size": size,
                 "iters": iters}
    for stage in stages:
        if deadline_s is not None and \
                time.monotonic() - t_start > deadline_s:
            out["truncated_at"] = stage
            _status(f"deadline reached — stopping before [{stage}]")
            break
        try:
            r = _run_stage(dev, stage, n, size, iters, t_rtt, rtype, mode,
                           seed)
        except Exception as e:              # noqa: BLE001
            _status(f"[{stage}] failed: {e}")
            out["details"][stage] = {"error": str(e)[:300]}
            continue
        out["stages_mpix_s"][stage] = r["compute_mpix_s"]
        out["details"][stage] = r
        _status(f"[{stage}] {r['compute_mpix_s']} Mpix/s "
                f"(loop {r['t_loop_s']}s)")
    return out


def main(argv=None):
    import argparse
    import json
    import signal
    import sys

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default="full",
                    help="comma list from: " + ",".join(STAGE_FEATURES))
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    for s in stages:
        if s not in STAGE_FEATURES:
            ap.error(f"unknown stage {s!r}")
    if len(stages) == 1:
        r = device_compute_probe(n=args.n, size=args.size, iters=args.iters,
                                 stage=stages[0], device=args.device,
                                 seed=args.seed)
    else:
        r = device_stage_probe(stages, n=args.n, size=args.size,
                               iters=args.iters, deadline_s=args.deadline,
                               device=args.device, seed=args.seed)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
