"""A mono deep-sky night made from a seed on the device and written as
files: the three float32 masters (bias, bias-subtracted dark with hot
pixels, bias-subtracted flat) and either 16-bit dithered lights of a star
field or 16-bit flats.  The sizes and levels come from the
configuration file; what the traffic file names decides which frames.

Every seed draws the same numbers of stars, hot pixels and ray tracks
and the same frame sizes; only their places and the dithers change.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np
import torch

from benchmark.gen import fitsfile
from benchmark.gen.scene import (
    be_words,
    card_generator,
    ray_tracks,
    render,
    star_field,
    vignetting,
)


def _writer():
    return cf.ThreadPoolExecutor(max_workers=4)


def _true_bias(cfg, dev):
    h, w = cfg["height"], cfg["width"]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    return (cfg["bias_level"] + cfg["bias_pattern"]
            * torch.sin(xx * (2 * np.pi / 64))).expand(h, w)


def _true_dark(cfg, rng, dev):
    h, w = cfg["height"], cfg["width"]
    dark = torch.full((h, w), cfg["dark_current"], dtype=torch.float32,
                      device=dev)
    nhot = h * w // cfg["px_per_hot_pixel"]
    hy, hx = rng.integers(2, h - 2, nhot), rng.integers(2, w - 2, nhot)
    dark[torch.as_tensor(hy, device=dev), torch.as_tensor(hx, device=dev)] \
        = torch.as_tensor(rng.uniform(0.1, 0.4, nhot), dtype=torch.float32,
                          device=dev)
    return dark


def masters(cfg, names, seed: int, root: str, dev, pool) -> dict:
    """The masters ``names`` of bias, dark and flat as ``<name>.fit`` in
    ``root``: each the true pattern plus the residual noise of a stack of
    ``master_frames`` frames.  Returns the true patterns."""
    rng = np.random.default_rng([seed, 1])
    g = card_generator(seed * 7 + 1, dev)
    h, w = cfg["height"], cfg["width"]
    bias = _true_bias(cfg, dev)
    dark = _true_dark(cfg, rng, dev)
    vig = vignetting(h, w, dev)
    rest = 1.0 / np.sqrt(cfg["master_frames"])

    def noise(s):
        return s * rest * torch.randn((h, w), generator=g, device=dev)

    made = {"bias": lambda: bias + noise(cfg["read_noise"]),
            "dark": lambda: dark + noise(cfg["read_noise"]),
            "flat": lambda: cfg["flat_level"] * vig + noise(cfg["flat_noise"])}
    futs = [pool.submit(fitsfile.write_float32, os.path.join(root, f"{k}.fit"),
                        made[k]().cpu().numpy()) for k in names]
    for f in futs:
        f.result()
    return dict(bias=bias, dark=dark, vig=vig)


def lights(cfg, traffic, seed: int, root: str, dev) -> dict:
    """``cfg['lights']`` 16-bit lights light_00001.fit … of one star field,
    frame 1 the reference and the others dithered by up to ±dither px,
    with sky, vignetting, bias, dark current, hot pixels, noise and
    cosmic-ray tracks; and the masters.  Returns the truth: the dithers
    (dx, dy) of each frame against frame 1."""
    rng = np.random.default_rng([seed, 2])
    g = card_generator(seed * 7 + 2, dev)
    h, w = cfg["height"], cfg["width"]
    n = int(cfg["lights"])
    nstars = int(round(cfg["stars_per_mpix"] * h * w / 1e6))
    sx, sy, amp = star_field(rng, h, w, nstars)
    nrays = h * w // cfg["px_per_ray_track"]
    d = float(cfg["dither_px"])
    shifts = [(0.0, 0.0)] + [tuple(float(v) for v in rng.uniform(-d, d, 2))
                             for _ in range(n - 1)]
    with _writer() as pool:
        base = masters(cfg, traffic["masters"], seed, root, dev, pool)
        fixed = base["bias"] + base["dark"]
        futs = []
        for k, (dx, dy) in enumerate(shifts):
            f = fixed + base["vig"] * render(h, w, cfg["sky"], sx + dx,
                                             sy + dy, amp, dev)
            f += cfg["light_noise"] * torch.randn((h, w), generator=g,
                                                  device=dev)
            ray_tracks(rng, f, nrays, 1.0)
            futs.append(pool.submit(
                fitsfile.write_be_words,
                os.path.join(root, f"light_{k + 1:05d}.fit"), h, w,
                be_words(f), [("EXPTIME", float(cfg["exposure_s"]))]))
        for f in futs:
            f.result()
    return dict(shifts=np.array(shifts), frames=n)


def flats(cfg, traffic, seed: int, root: str, dev) -> dict:
    """``cfg['flats']`` 16-bit flats flat_00001.fit … at about half scale,
    each its own level (sky flats brighten or fade: ±flat_level_spread),
    with noise and cosmic-ray tracks; and the masters."""
    rng = np.random.default_rng([seed, 3])
    g = card_generator(seed * 7 + 3, dev)
    h, w = cfg["height"], cfg["width"]
    n = int(cfg["flats"])
    nrays = h * w // cfg["px_per_ray_track"]
    spread = float(cfg["flat_level_spread"])
    levels = cfg["flat_level"] * (1.0 + rng.uniform(-spread, spread, n))
    with _writer() as pool:
        base = masters(cfg, traffic["masters"], seed, root, dev, pool)
        futs = []
        for k in range(n):
            f = base["bias"] + float(levels[k]) * base["vig"]
            f += cfg["flat_noise"] * torch.randn((h, w), generator=g,
                                                 device=dev)
            ray_tracks(rng, f, nrays, 1.0)
            futs.append(pool.submit(
                fitsfile.write_be_words,
                os.path.join(root, f"flat_{k + 1:05d}.fit"), h, w,
                be_words(f), [("EXPTIME", float(cfg["flat_exposure_s"]))]))
        for f in futs:
            f.result()
    return dict(levels=levels, frames=n)
