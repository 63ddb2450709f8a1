"""Multipoint planetary processing (MPP) — counterpart of
``siril_tpu/planetary/mpp.py`` (``MPPArgs``:44, ``MPPState``:60-95,
``_shift_core``:106, ``mpp_analyze``:135, ``_place_aps``:206,
``_shift_stage_fn``:241, ``mpp_compute_shifts``:290,
``_stack_stage_fn``:369, ``mpp_stack``:402, ``mpp_full``:482; reference
``src/registration/mpp/``, the three stages of mpp.h:130-155).

Stage A (``mpp_analyze``): the quality of every frame, the phase
correlation of every frame against the best one, the reference (the mean
of the best R % globally aligned frames, summed a chunk of
``frame_batch`` frames at a time on the device, so that the sums are
grouped as the JAX package groups them), and the AP grid where the
reference has structure (host numpy: ``np.gradient``, ``np.percentile``).

Stage B (``mpp_compute_shifts``), one device pass a chunk of frames: the
Fourier shift by the global shift, the blur, an ``edge`` pad by E, the
per-AP window cut, MultiLevelCorrelation (``planetary/mlc.py``) and the
AP patches' quality; only the (B, A) results come back.

Stage C (``mpp_stack``): per AP, the best N % frames by their patch
quality (numpy's argsort on the host), each patch cut at its solved
integer origin and shifted by its sub-pixel residue, summed per AP on
the device; the Hann-weighted assembly in float64 on the host, and
``-scale`` through ``ops/interp.resize`` with lanczos4.

The ``.mpp`` sidecar is ``np.savez_compressed`` with the JAX package's
keys, so each package reads the other's.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.stacking import StageClock

_log = logging.getLogger(__name__)


@dataclass
class MPPArgs:
    layer: int = 0
    ap_size: int = 48                 # alignment point box (px)
    ap_overlap: float = 0.5           # grid step = ap_size·(1−overlap)
    structure_threshold: float = 0.1  # relative gradient energy for AP
    global_best_pct: float = 25.0     # frames for the reference mean
    stack_best_pct: float = 50.0      # per-AP frames stacked
    frame_batch: int = 64
    max_frames: int = 0               # 0 = all
    scale: float = 1.0                # output scale (1–3)
    search_width: int = 14            # alignment_points_search_width
    gauss_width: int = 7              # frames_gauss_width
    penalty_factor: float = 0.00025   # alignment_points_penalty_factor


@dataclass
class MPPState:
    """Analyze + shift state (the ``.mpp`` sidecar content)."""

    quality: np.ndarray                # (N,)
    global_shifts: np.ndarray          # (N, 2) dx, dy frame → ref
    reference: np.ndarray              # (H, W) mean reference
    ap_xy: np.ndarray                  # (A, 2) AP centres
    ap_shifts: Optional[np.ndarray] = None    # (N, A, 2)
    ap_quality: Optional[np.ndarray] = None   # (N, A)
    args: Optional[MPPArgs] = None

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez_compressed(
                f, quality=self.quality, global_shifts=self.global_shifts,
                reference=self.reference, ap_xy=self.ap_xy,
                ap_shifts=self.ap_shifts if self.ap_shifts is not None
                else np.zeros(0),
                ap_quality=self.ap_quality if self.ap_quality is not None
                else np.zeros(0),
                ap_size=self.args.ap_size if self.args else 48)

    @staticmethod
    def load(path: str) -> "MPPState":
        z = np.load(path)
        st = MPPState(quality=z["quality"], global_shifts=z["global_shifts"],
                      reference=z["reference"], ap_xy=z["ap_xy"])
        if z["ap_shifts"].size:
            st.ap_shifts = z["ap_shifts"]
        if z["ap_quality"].size:
            st.ap_quality = z["ap_quality"]
        a = MPPArgs()
        a.ap_size = int(z["ap_size"])
        st.args = a
        return st


def _shift_core(frames: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Fourier phase-ramp shift of (N, H, W) frames by (N, 2) (dx, dy):
    ``fftfreq(H)`` and ``rfftfreq(W)`` float32, the angle float32 as in
    the JAX package, its cosine and sine rounded from float64 (the same
    on every device), the ramp complex64, the inverse ``_irfft2``."""
    H, W = frames.shape[1], frames.shape[2]
    dev = frames.device
    fy = torch.fft.fftfreq(H, device=dev)[None, :, None]
    fx = torch.fft.rfftfreq(W, device=dev)[None, None, :]
    Fr = torch.fft.rfft2(frames)
    arg = shifts[:, 0, None, None] * fx + shifts[:, 1, None, None] * fy
    theta = (arg * torch.tensor(np.float32(-2.0 * np.pi), device=dev)
             ).double()
    phase = torch.complex(torch.cos(theta).float(), torch.sin(theta).float())
    return _irfft2(Fr * phase, H, W)


def _irfft2(X: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``irfft2`` of a spectrum that need not be Hermitian in its first
    and Nyquist columns (a phase ramp makes them complex): the inverse
    over the rows, then the real inverse over the columns with those two
    bins' imaginary parts dropped, as pocketfft and XLA do.  cuFFT's 2-D
    inverse leaves them to the algorithm it picks by the batch
    (``scripts/fft_inverse_check.py``)."""
    Y = torch.fft.ifft(X, dim=-2)
    cols = [0] + ([W // 2] if W % 2 == 0 else [])
    Y[..., cols] = Y[..., cols].real.to(Y.dtype)
    return torch.fft.irfft(Y, n=W, dim=-1)


def _cut_patches(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                 size: int) -> torch.Tensor:
    """(B, A, size, size) windows of (B, H, W) ``x`` at origins (oy, ox),
    each (A,) for every frame or (B, A) per frame."""
    r = torch.arange(size, device=x.device)
    B = x.shape[0]
    if oy.dim() == 1:
        oy, ox = oy[None].expand(B, -1), ox[None].expand(B, -1)
    b = torch.arange(B, device=x.device)[:, None, None, None]
    rows = (oy[:, :, None] + r)[:, :, :, None]
    cols = (ox[:, :, None] + r)[:, :, None, :]
    return x[b, rows, cols]


# ---------------------------------------------------------------------------
# Stage A
# ---------------------------------------------------------------------------


def mpp_analyze(seq, args: Optional[MPPArgs] = None,
                device: DeviceLike = None, stages=None) -> MPPState:
    """Stage A; ``stages`` (a dict) takes the seconds of quality, global
    and reference (the upload of a resident video within quality)."""
    from siril_tpu_torch.planetary.quality import quality_core
    from siril_tpu_torch.planetary.source import frame_chunks
    from siril_tpu_torch.registration.shift import (
        decode_phasecorr_peaks,
        phase_correlate_device,
    )

    dev = resolve_device(device)
    clock = StageClock(dev, "mpp.", stages)
    args = args or MPPArgs()
    with clock("quality"):
        layer = args.layer
        indices = seq.selected_indices()
        if args.max_frames:
            indices = indices[: args.max_frames]
        n = len(indices)
        H, W = seq.ry, seq.rx
        if H == 0:
            img0 = seq.read_frame(int(indices[0]))
            H, W = img0.height, img0.width
            seq.ry, seq.rx = H, W
        pos_of = {int(i): p for p, i in enumerate(indices)}

        # 1. the quality of every frame
        qual = torch.cat([quality_core(fr) for _, fr in frame_chunks(
            seq, indices, layer, args.frame_batch, dev)]).cpu().numpy()
        qual = qual[:n].astype(np.float64)
    with clock("global"):
        best = int(np.argmax(qual))
        _log.info("MPP analyze: best frame %d (q=%.3g)", indices[best],
                  qual[best])

        # 2. the global shifts against the best frame (read on the host)
        ref0 = seq.read_frame(int(indices[best])).host()[layer]
        ref_dev = torch.from_numpy(np.ascontiguousarray(ref0)).to(dev)
        packed = torch.cat([phase_correlate_device(ref_dev, fr) for _, fr in
                            frame_chunks(seq, indices, layer, args.frame_batch,
                                         dev)])
        gshifts = decode_phasecorr_peaks(packed[:n], H, W)
    # 3. the reference: the mean of the best R % globally aligned frames
    with clock("reference"):
        n_best = max(int(round(n * args.global_best_pct / 100.0)), 1)
        best_idx = np.argsort(-qual)[:n_best]
        acc = None
        for chunk, frames in frame_chunks(seq, indices[best_idx], layer,
                                          args.frame_batch, dev):
            pos = [pos_of[int(i)] for i in chunk]
            sh = torch.from_numpy(gshifts[pos].astype(np.float32)).to(dev)
            part = _shift_core(frames, sh).sum(dim=0)
            acc = part if acc is None else acc + part
        reference = (acc.cpu().numpy() / n_best).astype(np.float32)

    # 4. the AP grid where the reference has structure
    aps = _place_aps(reference, args)
    step = max(int(args.ap_size * (1.0 - args.ap_overlap)), 8)
    _log.info("MPP analyze: %d alignment points (box %d, step %d)",
              len(aps), args.ap_size, step)
    return MPPState(quality=qual, global_shifts=gshifts,
                    reference=reference, ap_xy=np.asarray(aps, float),
                    args=args)


def _place_aps(reference: np.ndarray, args: MPPArgs) -> np.ndarray:
    """AP grid auto-placement (mpp_ap.cpp): the grid cells whose mean
    gradient energy reaches ``structure_threshold · 0.1`` of the 75th
    percentile of the cells' energies (host numpy)."""
    H, W = reference.shape
    gy, gx = np.gradient(reference)
    energy = gx * gx + gy * gy
    step = max(int(args.ap_size * (1.0 - args.ap_overlap)), 8)
    half = args.ap_size // 2
    cells = []
    for y in range(half, H - half + 1, step):
        for x in range(half, W - half + 1, step):
            cells.append((x, y, energy[y - half:y + half,
                                       x - half:x + half].mean()))
    if cells:
        es = np.array([c[2] for c in cells])
        ref_e = float(np.percentile(es[es > 0], 75)) if (es > 0).any() \
            else 1.0
        thr = args.structure_threshold * 0.1 * ref_e
        aps = [(x, y) for x, y, e in cells if e >= thr]
    else:
        aps = []
    if not aps:
        aps = [(W // 2, H // 2)]
    return np.array(aps, float)


# ---------------------------------------------------------------------------
# Stage B
# ---------------------------------------------------------------------------


def stage_b_windows(frames: torch.Tensor, gshifts: torch.Tensor,
                    oy: torch.Tensor, ox: torch.Tensor, args: MPPArgs):
    """Stage B before MLC: the frames shifted by their global shifts, and
    the (B·A, S+2E, S+2E) windows of the blurred, ``edge``-padded frames
    around each AP box (frame-major)."""
    from siril_tpu_torch.planetary.mlc import blur_gauss, mlc_window_extent

    S = args.ap_size
    E = mlc_window_extent(args.search_width)
    B, A = frames.shape[0], oy.shape[0]
    aligned = _shift_core(frames, gshifts)
    padded = F.pad(blur_gauss(aligned, args.gauss_width)[:, None],
                   (E, E, E, E), mode="replicate")[:, 0]
    big = _cut_patches(padded, oy, ox, S + 2 * E).reshape(
        B * A, S + 2 * E, S + 2 * E)
    return aligned, big


def stage_b_mlc(args: MPPArgs):
    """The MLC solver of stage B for ``args``' geometry."""
    from siril_tpu_torch.planetary.mlc import mlc_core

    sw2 = 4
    sw1 = (args.search_width - sw2) // 2
    return mlc_core(args.ap_size, sw1, sw2, int(args.gauss_width),
                    float(args.penalty_factor), True)


def shift_stage(frames: torch.Tensor, gshifts: torch.Tensor,
                ref_full: torch.Tensor, ref_p1: torch.Tensor,
                oy: torch.Tensor, ox: torch.Tensor, args: MPPArgs):
    """One chunk of stage B on the frames' device: the global Fourier
    shift, the blur, the ``edge`` pad, the window cut, MLC and the AP
    patches' quality; (dy, dx, success, quality), each (B, A)."""
    from siril_tpu_torch.planetary.quality import quality_core

    S = args.ap_size
    B, A = frames.shape[0], oy.shape[0]
    aligned, big = stage_b_windows(frames, gshifts, oy, ox, args)
    tidx = torch.arange(A, device=frames.device).repeat(B)
    dy, dx, ok = stage_b_mlc(args)(big, ref_full, ref_p1, tidx)
    del big
    q = quality_core(_cut_patches(aligned, oy, ox, S).reshape(B * A, S, S))
    return (dy.reshape(B, A), dx.reshape(B, A), ok.reshape(B, A),
            q.reshape(B, A))


def mpp_compute_shifts(seq, state: MPPState,
                       args: Optional[MPPArgs] = None,
                       device: DeviceLike = None, stages=None) -> MPPState:
    """Stage B — the MultiLevelCorrelation shift of every (frame, AP),
    one device pass a chunk of frames (``stages``: its seconds, as
    shifts)."""
    from siril_tpu_torch.planetary.mlc import blur_gauss
    from siril_tpu_torch.planetary.source import frame_chunks

    dev = resolve_device(device)
    clock = StageClock(dev, "mpp.", stages)
    with clock("shifts"):
        args = args or state.args or MPPArgs()
        layer = args.layer
        indices = seq.selected_indices()[: len(state.quality)]
        n = len(indices)
        A = len(state.ap_xy)
        S = args.ap_size
        half = S // 2
        H, W = state.reference.shape

        # the blurred reference boxes, cut once (mpp_shift.cpp:93-95)
        refb = blur_gauss(torch.from_numpy(np.ascontiguousarray(
            state.reference, np.float32)).to(dev)[None],
            args.gauss_width)[0].cpu().numpy()
        origins = [(int(np.clip(int(y) - half, 0, H - S)),
                    int(np.clip(int(x) - half, 0, W - S)))
                   for x, y in state.ap_xy]
        ref_boxes = np.stack([refb[y0:y0 + S, x0:x0 + S]
                              for (y0, x0) in origins]).astype(np.float32)
        ref_d = torch.from_numpy(ref_boxes).to(dev)
        ref_p1_d = torch.from_numpy(np.ascontiguousarray(
            ref_boxes[:, ::2, ::2])).to(dev)
        oy = torch.tensor([o[0] for o in origins], dtype=torch.int64,
                          device=dev)
        ox = torch.tensor([o[1] for o in origins], dtype=torch.int64,
                          device=dev)

        ap_shifts = np.zeros((n, A, 2))
        ap_qual = np.zeros((n, A))
        for chunk, frames in frame_chunks(seq, indices, layer,
                                          args.frame_batch, dev):
            pos = [int(np.nonzero(indices == i)[0][0]) for i in chunk]
            gsh = torch.from_numpy(
                state.global_shifts[pos].astype(np.float32)).to(dev)
            dy, dx, ok, q = (t.cpu().numpy() for t in shift_stage(
                frames, gsh, ref_d, ref_p1_d, oy, ox, args))
            for k, p in enumerate(pos):
                # failed solves fall back to the global shift alone
                ap_shifts[p, :, 0] = np.where(ok[k], dx[k], 0.0)
                ap_shifts[p, :, 1] = np.where(ok[k], dy[k], 0.0)
                ap_qual[p] = q[k]
        state.ap_shifts = ap_shifts
        state.ap_quality = ap_qual
    _log.info("MPP shifts: %d frames × %d APs (multilevel correlation, "
              "sw=%d)", n, A, args.search_width)
    return state


# ---------------------------------------------------------------------------
# Stage C
# ---------------------------------------------------------------------------


def stack_stage(acc_ap: torch.Tensor, frames: torch.Tensor,
                gshifts: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                resid: torch.Tensor, selmask: torch.Tensor) -> torch.Tensor:
    """One chunk of stage C: the global Fourier shift, each (frame, AP)
    patch cut at its integer origin and moved by −resid, the selected
    ones summed into the (A, S, S) ``acc_ap``."""
    B, A = iy.shape
    S = acc_ap.shape[-1]
    aligned = _shift_core(frames, gshifts)
    patches = _cut_patches(aligned, iy, ix, S).reshape(B * A, S, S)
    del aligned
    shifted = _shift_core(patches, -resid.reshape(-1, 2))
    shifted = shifted.reshape(B, A, S, S) * selmask[:, :, None, None]
    return acc_ap + shifted.sum(dim=0)


def mpp_stack(seq, state: MPPState, args: Optional[MPPArgs] = None,
              device: DeviceLike = None, stages=None) -> SirilImage:
    """Stage C (``stages``: the seconds of stack and assembly)."""
    from siril_tpu_torch.planetary.source import frame_chunks

    dev = resolve_device(device)
    clock = StageClock(dev, "mpp.", stages)
    with clock("stack"):
        args = args or state.args or MPPArgs()
        layer = args.layer
        indices = seq.selected_indices()[: len(state.quality)]
        n = len(indices)
        A = len(state.ap_xy)
        S = args.ap_size
        half = S // 2
        H, W = state.reference.shape

        n_keep = max(int(round(n * args.stack_best_pct / 100.0)), 1)
        # per-AP frame selection by local quality: numpy's (unstable) sort
        sel = np.argsort(-state.ap_quality, axis=0)[:n_keep]  # (n_keep, A)
        selm = np.zeros((n, A), np.float32)
        np.put_along_axis(selm, sel, 1.0, axis=0)

        xs = state.ap_xy[None, :, 0]
        ys = state.ap_xy[None, :, 1]
        acc_ap = torch.zeros((A, S, S), device=dev)
        for chunk, frames in frame_chunks(seq, indices, layer,
                                          args.frame_batch, dev):
            pos = [int(np.nonzero(indices == i)[0][0]) for i in chunk]
            # local content at ref position x sits at x − lx in the
            # globally aligned frame
            cx = xs - state.ap_shifts[pos, :, 0]
            cy = ys - state.ap_shifts[pos, :, 1]
            ix = np.clip(np.round(cx) - half, 0, W - S).astype(np.int64)
            iy = np.clip(np.round(cy) - half, 0, H - S).astype(np.int64)
            resid = np.stack([cx - (ix + half), cy - (iy + half)],
                             -1).astype(np.float32)
            acc_ap = stack_stage(
                acc_ap, frames,
                torch.from_numpy(state.global_shifts[pos].astype(
                    np.float32)).to(dev),
                torch.from_numpy(iy).to(dev), torch.from_numpy(ix).to(dev),
                torch.from_numpy(resid).to(dev),
                torch.from_numpy(np.ascontiguousarray(selm[pos])).to(dev))

        # the assembly on the host, in float64
        ap_sums = acc_ap.cpu().numpy().astype(np.float64)
    with clock("assembly"):
        win = (np.hanning(S)[:, None] *
               np.hanning(S)[None, :]).astype(np.float64)
        acc = np.zeros((H, W), np.float64)
        wacc = np.zeros((H, W), np.float64)
        counts = selm.sum(0)
        for a in range(A):
            x, y = state.ap_xy[a].astype(int)
            y0 = int(np.clip(y - half, 0, H - S))
            x0 = int(np.clip(x - half, 0, W - S))
            acc[y0:y0 + S, x0:x0 + S] += ap_sums[a] * win
            wacc[y0:y0 + S, x0:x0 + S] += win * counts[a]

        out = np.where(wacc > 1e-6, acc / np.maximum(wacc, 1e-6),
                       state.reference).astype(np.float32)
        if args.scale != 1.0:
            from siril_tpu_torch.ops.interp import INTERP_LANCZOS4, resize

            out = resize(torch.from_numpy(out[None]).to(dev),
                         int(W * args.scale), int(H * args.scale),
                         INTERP_LANCZOS4, clamp=True)[0].cpu().numpy()
        img = SirilImage(data=np.clip(out, 0.0, 1.0)[None])
    img.log_history(
        f"MPP stack ({n_keep}/{n} frames per AP, {A} APs, box {S})")
    _log.info("MPP stack done: %d APs, best %d/%d frames each", A, n_keep,
              n)
    return img


def mpp_full(seq, args: Optional[MPPArgs] = None,
             sidecar: Optional[str] = None,
             device: DeviceLike = None, stages=None) -> SirilImage:
    """The ``mpp`` command: the three stages, the sidecar between them."""
    args = args or MPPArgs()
    state = mpp_analyze(seq, args, device, stages)
    state = mpp_compute_shifts(seq, state, args, device, stages)
    if sidecar:
        with StageClock(resolve_device(device), "mpp.", stages)("sidecar"):
            state.save(sidecar)
    return mpp_stack(seq, state, args, device, stages)
