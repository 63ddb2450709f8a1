"""NL-Bayes patch denoiser — counterpart of ``siril_tpu/ops/nlbayes.py``:
the noise estimate (``estimate_noise_sigma``:37, host numpy), the patch
matrix (``_unfold``:46), one pass (``_nlb_pass``:58) and the ``denoise``
pipeline (``nlbayes_denoise``:132: two passes, the Anscombe VST and SOS
boosting).

One pass, on ``device`` (CUDA unless "cpu"): every stride-s reference
patch gathers its search window's candidates, ranks them by the L2
distance in the JAX package's expanded form, keeps the M nearest (ties to
the lower candidate index, as ``lax.top_k``: a stable sort), fits a
Gaussian model to the group and Wiener-filters it with a batched solve,
then scatter-averages the filtered patches back.  The JAX package does
the whole reference grid at once (at 4096², stride 3, the candidate
patches alone would be 31 GB); here the grid goes in blocks of reference
rows, each block unfolding only the image rows its search windows reach,
so a pass holds about ``REF_BLOCK`` groups at a time.  The solve is
``linalg.solve_ex``, which returns what LU gives for a singular group
where ``linalg.solve`` would raise (``jnp.linalg.solve`` returns it
silently).  The aggregation adds with ``index_add_``: on the card in
atomics, so its order changes from run to run.  Every matmul is float32:
on the card the pass refuses to run when PyTorch has TF32 matmuls on.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.stretch import finish, upload
from siril_tpu_torch.ops.wavelets import anscombe, anscombe_inverse_exact

#: reference patches (groups) filtered at a time
REF_BLOCK = 1 << 16


def estimate_noise_sigma(layer: np.ndarray) -> float:
    """Robust noise σ from the MAD of the Laplacian residual."""
    d = np.asarray(layer, np.float32)
    lap = (4 * d[1:-1, 1:-1] - d[:-2, 1:-1] - d[2:, 1:-1]
           - d[1:-1, :-2] - d[1:-1, 2:])
    mad = np.median(np.abs(lap - np.median(lap)))
    return float(1.4826 * mad / math.sqrt(20.0))


def _unfold(x: torch.Tensor, k: int) -> torch.Tensor:
    """[H,W] → [(H-k+1)·(W-k+1), k²] patch matrix (column dy·k + dx)."""
    return x.unfold(0, k, 1).unfold(1, k, 1).reshape(-1, k * k)


def _check_matmul(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("NL-Bayes needs float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is set")


class _Clock:
    """Seconds per stage, each ended by a device synchronization, when
    ``stages`` is a dict; nothing otherwise."""

    def __init__(self, stages: Optional[dict], device: torch.device):
        self.stages, self.device = stages, device
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.stages is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + t - self.t
        self.t = t


def candidate_offsets(search: int, device) -> tuple:
    """(oy, ox) of the search window, row-major (W² each)."""
    half = search // 2
    offs = torch.arange(-half, half + 1, device=device)
    return offs.repeat_interleave(search), offs.repeat(search)


def _nlb_pass(noisy: torch.Tensor, guide: torch.Tensor, sigma: float,
              k: int, M: int, search: int, stride: int,
              guide_is_noisy: bool = True, top: Optional[torch.Tensor] = None,
              stages: Optional[dict] = None) -> torch.Tensor:
    """One NL-Bayes pass.  ``guide`` drives grouping + statistics (pass
    1: the noisy image — its covariance holds the noise, so the signal
    covariance is C−σ²I; pass 2: the basic estimate — the covariance is
    the signal model and the Wiener denominator adds σ²I).  ``top``
    [Nr, M] fixes each reference's selection (indices into its W²
    candidates) instead of ranking them."""
    dev = noisy.device
    _check_matmul(dev)
    clock = _Clock(stages, dev)
    H, W = noisy.shape
    hp, wp = H - k + 1, W - k + 1
    ry = torch.arange(0, hp, stride, device=dev)
    rx = torch.arange(0, wp, stride, device=dev)
    oy, ox = candidate_offsets(search, dev)
    half = search // 2
    kk = k * k
    s32 = np.float32(sigma)
    s2 = float(s32 * s32)
    eye = torch.eye(kk, device=dev, dtype=noisy.dtype)[None]
    tap = torch.arange(kk, device=dev)
    tap_y, tap_x = tap // k, tap % k
    out = torch.zeros(H * W, device=dev, dtype=noisy.dtype)
    wgt = torch.zeros_like(out)
    rows = max(1, REF_BLOCK // rx.numel())
    for b0 in range(0, ry.numel(), rows):
        by = ry[b0:b0 + rows]
        p0 = max(int(by[0]) - half, 0)
        p1 = min(int(by[-1]) + half, hp - 1)
        Pg = _unfold(guide[p0:p1 + k], k)
        Pn = _unfold(noisy[p0:p1 + k], k)
        ref_y = by.repeat_interleave(rx.numel())
        ref_x = rx.repeat(by.numel())
        cy = torch.clamp(ref_y[:, None] + oy[None, :], 0, hp - 1) - p0
        cx = torch.clamp(ref_x[:, None] + ox[None, :], 0, wp - 1)
        cand = cy * wp + cx                                 # [Nb, W²]
        if top is None:
            g_ref = Pg[(ref_y - p0) * wp + ref_x]           # [Nb, k²]
            g_cand = Pg[cand]                               # [Nb, W², k²]
            d2 = ((g_cand * g_cand).sum(-1)
                  - 2.0 * (g_cand * g_ref[:, None, :]).sum(-1)
                  + (g_ref * g_ref).sum(-1)[:, None])
            del g_cand
            t = torch.sort(d2, dim=1, stable=True).indices[:, :M]
        else:
            t = top[b0 * rx.numel():(b0 + by.numel()) * rx.numel()]
        sel = torch.gather(cand, 1, t)                      # [Nb, M]
        clock.lap("search")
        Gg = Pg[sel]                                        # [Nb, M, k²]
        Gn = Pn[sel]
        mu = Gg.mean(dim=1, keepdim=True)
        Xc = Gg - mu
        C = torch.bmm(Xc.transpose(1, 2), Xc) / max(M - 1, 1)
        if guide_is_noisy:
            A = C + 1e-8 * eye
            Cs = C - s2 * eye
        else:
            A = C + s2 * eye
            Cs = C
        rhs = (Gn - mu).transpose(1, 2)                     # [Nb, k², M]
        sol = torch.linalg.solve_ex(A, rhs).result
        flt = (mu.transpose(1, 2) + torch.bmm(Cs, sol)).transpose(1, 2)
        clock.lap("solve")
        py = sel // wp + p0
        px = sel % wp
        idx = ((py[:, :, None] + tap_y) * W + px[:, :, None] + tap_x)
        idx = idx.reshape(-1)
        out.index_add_(0, idx, flt.reshape(-1))
        wgt.index_add_(0, idx, torch.ones_like(idx, dtype=out.dtype))
        clock.lap("aggregate")
    out = out.reshape(H, W)
    wgt = wgt.reshape(H, W)
    return torch.where(wgt > 0, out / torch.clamp_min(wgt, 1e-9), noisy)


def nlbayes_tensor(chan: torch.Tensor, s: float, k: int = 5, M: int = 24,
                   search: int = 13, stride: int = 3, use_vst: bool = False,
                   sos_iters: int = 0, sos_rho: float = 0.3,
                   stages: Optional[dict] = None) -> torch.Tensor:
    """One (H, W) layer through the two passes (and SOS), clipped to
    [0, 1]."""
    x = chan
    if use_vst:
        x = anscombe(x * 400.0) / 40.0   # scale into Poisson-ish range
    kw = dict(k=k, M=M, search=search, stride=stride, stages=stages)
    basic = _nlb_pass(x, x, s, guide_is_noisy=True, **kw)
    y = _nlb_pass(x, basic, s, guide_is_noisy=False, **kw)
    for _ in range(sos_iters):
        # SOS boosting (Romano & Elad): strengthen the signal with the
        # previous estimate, operate, subtract it back
        z = x + sos_rho * y
        y = _nlb_pass(z, z, s, guide_is_noisy=True, **kw) - sos_rho * y
    if use_vst:
        y = anscombe_inverse_exact(y * 40.0) / 400.0
    return torch.clamp(y, 0.0, 1.0)


def nlbayes_denoise(img: SirilImage, sigma: Optional[float] = None,
                    k: int = 5, M: int = 24, search: int = 13,
                    stride: int = 3, use_vst: bool = False,
                    sos_iters: int = 0, sos_rho: float = 0.3,
                    device: DeviceLike = None,
                    stages: Optional[dict] = None) -> SirilImage:
    """The `denoise` command's pipeline: optional Anscombe VST → two-pass
    NL-Bayes → optional SOS boosting → inverse VST, a layer at a time.
    ``stages`` (a dict) gathers the seconds of search, solve and
    aggregate."""
    from siril_tpu_torch.ops.statistics import per_layer

    d = upload(img, device)
    sigmas = [sigma] * d.shape[0] if sigma is not None else \
        per_layer(estimate_noise_sigma, img.host())
    out = torch.empty_like(d)
    for c in range(d.shape[0]):
        out[c] = nlbayes_tensor(d[c], float(sigmas[c]), k, M, search, stride,
                                use_vst, sos_iters, sos_rho, stages)
    return finish(img, out, "NL-Bayes denoise (sigma="
                  f"{'auto' if sigma is None else sigma}"
                  f"{', VST' if use_vst else ''}"
                  f"{f', SOS x{sos_iters}' if sos_iters else ''})")
