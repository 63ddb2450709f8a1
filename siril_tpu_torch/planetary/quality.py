"""Planetary frame quality — counterpart of
``siril_tpu/planetary/quality.py`` (``quality_core``:20,
``quality_batch``:62, ``rank_sequence_quality``:67, ``barycentre``:97;
reference ``src/algos/quality.c`` QualityEstimate:39 and the barycentre
:313).

The score of a frame is the mean squared gradient of its 3×3-box-smoothed
image (the box pads with ``edge``, torch's ``replicate``), on the frame
subsampled by 2 and by 3, averaged: one batched pass over (N, H, W) on
the frames' device.  The gradient sums are float32, in torch's order, so
the scores agree with XLA's to about 1e-6 relative, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.device import DeviceLike, resolve_device

QSUBSAMPLE_MIN = 2
QSUBSAMPLE_MAX = 3


def quality_core(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W) float32 → (N,) quality scores (higher = sharper)."""

    def one_scale(x, sub):
        xs = x[:, ::sub, ::sub]
        p = F.pad(xs[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        h, w = xs.shape[1], xs.shape[2]
        sm = 0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sm = sm + p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        sm = sm / 9.0
        gx = sm[:, :, 1:] - sm[:, :, :-1]
        gy = sm[:, 1:, :] - sm[:, :-1, :]
        g2 = (gx[:, :-1, :] ** 2).sum(dim=(1, 2)) + \
            (gy[:, :, :-1] ** 2).sum(dim=(1, 2))
        return g2 / (h * w)

    x = frames.float()
    q = 0
    for s in range(QSUBSAMPLE_MIN, QSUBSAMPLE_MAX + 1):
        q = q + one_scale(x, s)
    return q / (QSUBSAMPLE_MAX - QSUBSAMPLE_MIN + 1)


def quality_batch(frames, device: DeviceLike = None) -> np.ndarray:
    """(N, H, W) float32 frames (an array, or a tensor on its device) →
    (N,) scores."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.as_tensor(np.asarray(frames, np.float32)).to(
            resolve_device(device))
    return quality_core(frames).cpu().numpy()


def rank_sequence_quality(seq, layer: int = 0, batch: int = 32,
                          device: DeviceLike = None) -> np.ndarray:
    """The quality of every selected frame of ``seq`` on ``device``, in
    chunks of ``batch``, stored in regdata.quality normalised to best = 1
    (the reference writes them to the ``.seq`` the same way)."""
    from siril_tpu_torch.planetary.source import frame_chunks

    dev = resolve_device(device)
    indices = seq.selected_indices()
    reg = seq.reg(layer)
    parts = [quality_core(frames) for _, frames in
             frame_chunks(seq, indices, layer, batch, dev)]
    idx = np.asarray(indices, int)
    if parts:
        q = torch.cat(parts).cpu().numpy()
        reg.quality[idx] = q[:len(indices)].astype(reg.quality.dtype)
    reg.valid[idx] = True
    valid = reg.valid & seq.incl
    if valid.any():
        qmax = reg.quality[valid].max()
        if qmax > 0:
            reg.quality[valid] = reg.quality[valid] / qmax
    return reg.quality


def barycentre(layer: np.ndarray, threshold: Optional[float] = None):
    """Full-disc barycentre (quality.c:313) for planetary framing (host)."""
    if threshold is None:
        threshold = float(layer.mean()) * 1.5
    m = np.where(layer > threshold, layer, 0.0)
    tot = m.sum()
    if tot <= 0:
        h, w = layer.shape
        return w / 2.0, h / 2.0
    yy, xx = np.mgrid[0:layer.shape[0], 0:layer.shape[1]]
    return float((m * xx).sum() / tot), float((m * yy).sum() / tot)
