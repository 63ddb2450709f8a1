"""Background extraction — counterpart of ``siril_tpu/ops/background.py``
(src/algos/background_extraction.c): the sample grid with median boxes
(``generate_samples``:38), the least-squares polynomial of degree 1–4
(``compute_background_poly``:71), the thin-plate-spline RBF with its
smoothing (``compute_background_rbf``:92), and the ``subsky`` command's
subtract / divide application with the optional dither
(``extract_background``:140).

The samples, the polynomial's least squares and the RBF's linear solve are
host numpy, as in the JAX package (the dither's ``default_rng(0xB46)``
too; the layers' samples on host threads at once); the model is evaluated over the whole image, and applied, on
``device`` (CUDA unless "cpu").  The polynomial's terms are float32 powers
taken as JAX's ``integer_pow`` takes them (repeated squaring), also for
the samples' design matrix, which the JAX package builds in float32.  The
RBF evaluation, φ(|g − p|) for every pixel g and sample p, is done in row
blocks of at most ``RBF_BLOCK_ELEMS`` (pixel, sample) pairs, so that the
device memory it takes beyond the image stays bounded (four float32
(pixels, samples) temporaries a block: 1 GiB at the default).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device, synchronize
from siril_tpu_torch.ops.statistics import per_layer

_log = logging.getLogger(__name__)

BKG_POLY = 0
BKG_RBF = 1

SUBTRACT = 0
DIVIDE = 1

#: (pixel, sample) pairs per block of the RBF evaluation
RBF_BLOCK_ELEMS = 1 << 26


@dataclass
class BkgSample:
    x: float
    y: float
    median: float
    valid: bool = True


def generate_samples(layer: np.ndarray, nb_per_line: int = 20,
                     tolerance: float = 1.0) -> List[BkgSample]:
    """Sample grid with median boxes; boxes whose median lies more than
    ``tolerance`` MADs above the layer's median are rejected
    (background_extraction.c sample generation + tolerance filter)."""
    H, W = layer.shape
    size = max(min(H, W) // nb_per_line, 8)
    half = size // 2
    med_g = float(np.median(layer))
    mad_g = float(np.median(np.abs(layer - med_g))) or 1e-6
    samples = []
    ys = np.arange(half, H - half + 1, size)
    xs = np.arange(half, W - half + 1, size)
    for y in ys:
        for x in xs:
            box = layer[y - half:y + half + 1, x - half:x + half + 1]
            m = float(np.median(box))
            valid = (m - med_g) <= tolerance * mad_g * 1.4826 * 3 and m > 0
            samples.append(BkgSample(float(x), float(y), m, valid))
    return samples


def _ipow(x, n: int):
    """x**n for an integer n ≥ 0 by repeated squaring, as XLA's
    integer_pow computes it."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _poly_terms(x: torch.Tensor, y: torch.Tensor, degree: int):
    terms = []
    for total in range(degree + 1):
        for i in range(total + 1):
            terms.append(_ipow(x, i) * _ipow(y, total - i))
    return torch.stack(terms, dim=-1)


def _grid(H: int, W: int, dev: torch.device, dtype=torch.float32):
    """x / W and y / H of every pixel, (H, W) each: the quotient in
    float64, then ``dtype``."""
    xs = torch.arange(W, dtype=torch.float64, device=dev) / W
    ys = torch.arange(H, dtype=torch.float64, device=dev) / H
    return (xs[None, :].expand(H, W).to(dtype),
            ys[:, None].expand(H, W).to(dtype))


def compute_background_poly(samples: List[BkgSample], shape: Tuple[int, int],
                            degree: int = 4,
                            device: DeviceLike = None) -> torch.Tensor:
    """Least-squares 2D polynomial background (computeBackground_Polynom),
    an (H, W) float32 tensor on ``device``."""
    dev = resolve_device(device)
    H, W = shape
    pts = [(s.x / W, s.y / H, s.median) for s in samples if s.valid]
    if len(pts) < (degree + 1) * (degree + 2) // 2:
        raise ValueError("not enough valid background samples")
    xs = torch.tensor([p[0] for p in pts], dtype=torch.float32)
    ys = torch.tensor([p[1] for p in pts], dtype=torch.float32)
    zs = np.array([p[2] for p in pts])
    A = _poly_terms(xs, ys, degree).numpy()
    coef, *_ = np.linalg.lstsq(A, zs, rcond=None)
    gx, gy = _grid(H, W, dev)
    G = _poly_terms(gx, gy, degree)
    return G @ torch.from_numpy(coef.astype(np.float32)).to(dev)


def _rbf_block(G: torch.Tensor, P: torch.Tensor,
               wk: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k·φ(|g − p_k|²) of the pixels ``G`` (n, 2), φ = ½ d²·ln d²."""
    d2 = ((G[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    phi = 0.5 * d2 * torch.log(torch.clamp_min(d2, 1e-12))
    return phi @ wk


def compute_background_rbf(samples: List[BkgSample], shape: Tuple[int, int],
                           smoothing: float = 0.5,
                           device: DeviceLike = None,
                           block_elems: int = RBF_BLOCK_ELEMS
                           ) -> torch.Tensor:
    """Thin-plate-spline RBF background (computeBackground_RBF): φ(r) =
    r²·ln r, a ridge of ``smoothing`` on the kernel's diagonal; evaluated
    in row blocks on ``device``, an (H, W) float32 tensor."""
    dev = resolve_device(device)
    H, W = shape
    pts = [(s.x / W, s.y / H, s.median) for s in samples if s.valid]
    n = len(pts)
    if n < 5:
        raise ValueError("not enough valid background samples")
    P = np.array([[p[0], p[1]] for p in pts])
    z = np.array([p[2] for p in pts])
    d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    K = 0.5 * d2 * np.log(np.maximum(d2, 1e-12))
    lam = smoothing * np.mean(np.abs(K)) * 1e-2 + 1e-9
    A = np.zeros((n + 3, n + 3))
    A[:n, :n] = K + lam * np.eye(n)
    A[:n, n] = 1.0
    A[:n, n + 1:] = P
    A[n, :n] = 1.0
    A[n + 1:, :n] = P.T
    b = np.zeros(n + 3)
    b[:n] = z
    w = np.linalg.solve(A, b)
    wk = torch.from_numpy(w[:n].astype(np.float32)).to(dev)
    c0, cx, cy = w[n], w[n + 1], w[n + 2]
    Pt = torch.from_numpy(P.astype(np.float32)).to(dev)
    gx, gy = _grid(H, W, dev)
    rows = max(1, min(H, block_elems // max(W * n, 1)))
    vals = torch.empty((H, W), dtype=torch.float32, device=dev)
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        G = torch.stack([gx[r0:r1].reshape(-1), gy[r0:r1].reshape(-1)], 1)
        vals[r0:r1] = _rbf_block(G, Pt, wk).reshape(r1 - r0, W)
    # the affine part in float64, as numpy promotes it there (c0, cx and
    # cy are numpy float64 scalars)
    fx, fy = _grid(H, W, dev, torch.float64)
    bkg = vals.double() + float(c0) + float(cx) * fx + float(cy) * fy
    return bkg.float()


def _median(t: torch.Tensor) -> torch.Tensor:
    """np.median of a float32 tensor: the middle value, or the mean of the
    middle pair (float32)."""
    s = torch.sort(t.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def extract_background(img: SirilImage, method: int = BKG_POLY,
                       degree: int = 4, smoothing: float = 0.5,
                       nb_samples: int = 20, tolerance: float = 1.0,
                       correction: int = SUBTRACT, dither: bool = False,
                       device: DeviceLike = None,
                       stages: Optional[dict] = None) -> SirilImage:
    """``subsky``: model the sky background of each layer and remove it
    (subtracted and the model's median added back, or divided and scaled
    by the model's mean), clipped to [0, 1].  ``stages`` receives the
    seconds of the host samples, the model (its fit on the host, its
    evaluation on the device) and the device apply."""
    dev = resolve_device(device)
    data = img.host()
    C, H, W = data.shape
    times = dict(samples=0.0, model=0.0, apply=0.0)
    t = time.perf_counter()
    x = torch.from_numpy(data).to(dev)
    out = torch.empty_like(x)
    rng = np.random.default_rng(0xB46)
    times["apply"] += time.perf_counter() - t
    t = time.perf_counter()
    all_samples = per_layer(
        lambda x: generate_samples(x, nb_samples, tolerance), data)
    times["samples"] = time.perf_counter() - t
    for c, samples in enumerate(all_samples):
        _log.info("Background: channel %d: %d samples", c,
                  sum(1 for s in samples if s.valid))
        t = time.perf_counter()
        if method == BKG_RBF:
            bkg = compute_background_rbf(samples, (H, W), smoothing, dev)
        else:
            bkg = compute_background_poly(samples, (H, W), degree, dev)
        synchronize(dev)
        times["model"] += time.perf_counter() - t
        t = time.perf_counter()
        if correction == DIVIDE:
            mu = float(bkg.double().mean().float())
            res = x[c] / torch.clamp_min(bkg, 1e-6) * mu
        else:
            res = x[c] - bkg + float(_median(bkg))
        if dither:
            res = (res.double() + torch.from_numpy(
                rng.normal(0, 1.0 / 65535.0, res.shape)).to(dev)).float()
        out[c] = torch.clamp(res, 0.0, 1.0)
        synchronize(dev)
        times["apply"] += time.perf_counter() - t
    t = time.perf_counter()
    res_img = img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    times["apply"] += time.perf_counter() - t
    if stages is not None:
        stages.update(times)
    res_img.log_history(
        "Background extraction (%s)" % ("RBF" if method == BKG_RBF
                                        else f"Polynomial deg {degree}"))
    return res_img
