"""A planetary video made from a seed on the device and written as a
plain mono 16-bit SER: a banded disc displaced by a global drift and a
local field, blurred by a seeing that changes frame to frame, with
noise.  The scene, the fields and the rendering follow the repository's
bring-up proof (``chip_smoke.py``: ``planet_scene``, ``_gauss_ft``,
``local_fields``, ``_full_field``, ``planet_video``), copied here; the
SER is written by ``gen/serfile.py``, not by the program.

Every frame (drift, seeing, local field and noise) is drawn from the
run's seed.  The alignment-point grid follows the noisy sky at its
threshold, so the work and the device memory move a little with the
seed."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.gen.scene import card_generator
from benchmark.gen.serfile import SerWriter


def planet_scene(x, y, cx: float, cy: float, r: float):
    """The planet at (x, y) (tensors, px): a banded, limb-darkened,
    slightly oblate disc of radius ``r`` centred on (cx, cy), with fine
    belts and a few spots, on a dark sky."""
    u = (x - cx) / r
    v = (y - cy) / (0.93 * r)
    rr = torch.clamp(u * u + v * v, max=1.0)
    mu = torch.sqrt(1.0 - rr)
    lat = torch.asin(torch.clamp(v, -1.0, 1.0))
    bands = 0.14 * torch.sin(7.0 * lat + 0.4) + 0.06 * torch.sin(
        19.0 * lat + 1.1) + 0.03 * torch.sin(23.0 * lat + 1.7 * u)
    for k, (fx, fy, ph) in enumerate(((0.9, 0.4, 0.3), (-0.5, 0.8, 1.9),
                                      (0.2, -1.0, 2.6), (0.7, 0.7, 4.1),
                                      (-0.95, -0.3, 5.3), (0.35, 0.9, 0.8))):
        wl = (8.0 + 6.0 * k) / r
        bands = bands + 0.05 * torch.sin((fx * u + fy * v) * (2 * 3.14159265
                                                               / wl) + ph)
    disc = 0.62 * (0.35 + 0.65 * mu) * (1.0 + bands)
    for sx, sy, sr, a in ((-0.35, 0.28, 0.09, -0.25),
                          (0.22, -0.12, 0.05, 0.2),
                          (0.45, 0.4, 0.04, -0.3),
                          (-0.1, -0.45, 0.07, 0.15)):
        disc = disc * (1.0 + a * torch.exp(-((u - sx) ** 2 + (v - sy) ** 2)
                                           / (2 * sr * sr)))
    edge = torch.sigmoid((1.0 - torch.sqrt(u * u + v * v)) * r / 0.7)
    return 0.02 + edge * disc


def gauss_ft(h: int, w: int, sigma, dev):
    """exp(−2π²σ²f²) on the rfft2 grid, (N, h, w//2+1) for σ of (N,)."""
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    f2 = (fy * fy + fx * fx)[None]
    s = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    return torch.exp(-2.0 * math.pi ** 2 * s[:, None, None] ** 2 * f2)


def local_fields(g, n: int, h: int, w: int, dev, radius: float,
                 largest: float, coherence: float, step: int = 8):
    """(n, 2, h//step, w//step) coarse local displacement fields (dx, dy):
    white noise smoothed to ``coherence`` px, with zero mean over the
    disc and ``largest`` px at its largest there."""
    hc, wc = h // step, w // step
    noise = torch.randn(n, 2, hc, wc, generator=g, device=dev)
    sig = torch.full((n * 2,), coherence / step, device=dev)
    f = torch.fft.irfft2(torch.fft.rfft2(noise.reshape(n * 2, hc, wc))
                         * gauss_ft(hc, wc, sig, dev), s=(hc, wc))
    f = f.reshape(n, 2, hc, wc)
    yy, xx = torch.meshgrid(
        (torch.arange(hc, device=dev) + 0.5) * step - h / 2.0,
        (torch.arange(wc, device=dev) + 0.5) * step - w / 2.0,
        indexing="ij")
    disc = (torch.hypot(xx, yy / 0.93) < radius).float()
    f = f - (f * disc).sum(dim=(2, 3), keepdim=True) / disc.sum()
    peak = (f.abs() * disc).amax(dim=(1, 2, 3), keepdim=True)
    return f * (largest / peak)


def full_field(coarse, h: int, w: int):
    """A coarse (n, 2, hc, wc) field at full resolution (bilinear)."""
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)


def video(cfg, traffic, seed: int, root: str, dev) -> dict:
    """``<traffic['sequence']>.ser`` in ``root``: ``cfg['frames']`` frames
    of ``cfg['width']`` × ``cfg['height']``, drawn from ``seed``.  Returns
    the truth in file order: each frame's drift (dx, dy), seeing σ, and
    coarse local field."""
    gs = card_generator(seed, dev)
    n, w, h = int(cfg["frames"]), int(cfg["width"]), int(cfg["height"])
    r = float(cfg["disc_radius_px"])
    cx, cy = w / 2.0, h / 2.0
    drift = (torch.rand(n, 2, generator=gs, device=dev) * 2 - 1) * \
        float(cfg["drift_px"])
    lo, hi = cfg["seeing_sigma_px"]
    blur = lo + (hi - lo) * torch.rand(n, generator=gs, device=dev)
    coarse = local_fields(gs, n, h, w, dev, r, float(cfg["local_px"]),
                          float(cfg["coherence_px"]))
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    words = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    batch = 50
    for b0 in range(0, n, batch):
        b1 = min(n, b0 + batch)
        field = full_field(coarse[b0:b1], h, w)
        # the content at x comes from the scene at x − displacement
        sx = xx[None] - drift[b0:b1, 0, None, None] - field[:, 0]
        sy = yy[None] - drift[b0:b1, 1, None, None] - field[:, 1]
        f = planet_scene(sx, sy, cx, cy, r)
        f = torch.fft.irfft2(torch.fft.rfft2(f) * gauss_ft(
            h, w, blur[b0:b1], dev), s=(h, w))
        f = f + float(cfg["noise"]) * torch.randn(f.shape, generator=gs,
                                                  device=dev)
        words[b0:b1] = torch.round(torch.clamp(f, 0.0, 1.0) * 65535.0).to(
            torch.int32)
    path = os.path.join(root, traffic["sequence"] + ".ser")
    with SerWriter(path, w, h) as wr:
        for b0 in range(0, n, batch):
            wr.write(words[b0:b0 + batch].cpu().numpy().astype(
                "<u2").tobytes())
    return dict(drift=drift.cpu().numpy().astype(np.float64),
                blur=blur.cpu().numpy().astype(np.float64),
                coarse=coarse, frames=n)
