"""Deep-sky scene pieces, made on the device from a seed: a field of
Gaussian stars, its rendering, cosmic-ray tracks, and 16-bit quantization
to the big-endian words a FITS file holds.

The star field, the renderer and the tracks follow the repository's
bring-up proof (``chip_smoke.py``: ``_star_field``, ``_render_torch``,
``_ray_tracks``), copied here so that the inputs owe nothing to code a
later change may edit.
"""

from __future__ import annotations

import numpy as np
import torch


def star_field(rng: np.random.Generator, height: int, width: int,
               nstars: int):
    """Positions (x, y) and amplitudes of ``nstars`` Gaussian stars, at
    least 40 px from the edges; amplitudes 0.02 + a Pareto tail, capped
    at 0.55."""
    m = min(40, min(height, width) // 8)
    sx = rng.uniform(m, width - m, nstars)
    sy = rng.uniform(m, height - m, nstars)
    amp = 0.5 * rng.pareto(1.5, nstars) * 0.02 + 0.02
    return sx, sy, np.minimum(amp, 0.55)


def render(height: int, width: int, sky, cx, cy, amp, dev,
           psf_sigma: float = 1.3) -> torch.Tensor:
    """The sky (a float or an (H, W) tensor) plus the stars centred at
    (cx, cy), each on a 13×13 patch (pixel i covers [i, i+1))."""
    img = torch.zeros(height * width, dtype=torch.float32, device=dev)
    r = 6
    o = torch.arange(-r, r + 1, device=dev)
    cx = torch.as_tensor(np.asarray(cx), device=dev)[:, None, None]
    cy = torch.as_tensor(np.asarray(cy), device=dev)[:, None, None]
    px = torch.floor(cx).long() + o[None, None, :]
    py = torch.floor(cy).long() + o[None, :, None]
    d2 = (px + 0.5 - cx) ** 2 + (py + 0.5 - cy) ** 2
    a = torch.as_tensor(np.asarray(amp), device=dev)[:, None, None]
    val = (a * torch.exp(-d2 / (2 * psf_sigma ** 2))).float()
    px, py = px.expand(val.shape), py.expand(val.shape)
    inb = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    img.index_put_(((py * width + px)[inb],), val[inb], accumulate=True)
    return img.reshape(height, width) + sky


def ray_tracks(rng: np.random.Generator, frame: torch.Tensor, n: int,
               value: float) -> None:
    """``n`` straight tracks of 3-5 pixels at ``value``, in place: a
    single-pixel hit would fit as the brightest star."""
    h, w = frame.shape
    steps = np.array([(0, 1), (1, 0), (1, 1), (1, -1)])
    y0 = rng.integers(5, h - 5, n)
    x0 = rng.integers(5, w - 5, n)
    d = steps[rng.integers(0, 4, n)]
    length = rng.integers(3, 6, n)
    ys, xs = [], []
    for i in range(5):
        on = i < length
        ys.append(y0[on] + i * d[on, 0])
        xs.append(x0[on] + i * d[on, 1])
    idx = torch.as_tensor(np.concatenate(ys) * w + np.concatenate(xs),
                          device=frame.device)
    frame.view(-1)[idx] = value


def be_words(frame: torch.Tensor) -> bytes:
    """A [0, 1] float frame as 16-bit FITS data: round(clip·65535) less
    32768, as big-endian int16, byte-swapped on the device."""
    u = torch.round(frame.clamp(0.0, 1.0) * 65535.0).to(torch.int32)
    s = u - 32768
    swapped = ((s & 0xFF) << 8) | ((s >> 8) & 0xFF)
    return swapped.to(torch.int16).cpu().numpy().tobytes()


def vignetting(height: int, width: int, dev) -> torch.Tensor:
    """1 − 0.3 r² / (2 c²) about the centre, c the half of the larger
    side: 0.7-1.0 over the frame."""
    yy = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    c = max(height, width) / 2.0
    return 1.0 - 0.3 * ((xx + 0.5 - width / 2.0) ** 2
                        + (yy + 0.5 - height / 2.0) ** 2) / (2 * c * c)


def card_generator(seed: int, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    return g
