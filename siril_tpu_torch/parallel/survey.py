"""Survey-scale multi-device stacking — counterpart of
``siril_tpu/parallel/survey.py``: BASELINE config 5, plate solve +
photometric colour calibration + rejection stack of 1000 × 61 MP frames,
sharded (``plan_survey_rows``:58, ``_estimator_pass``:94,
``coeffs_from_estimators``:131, ``survey_stack_sharded``:151,
``survey_platesolve_pcc_stack``:220).  The JAX package pads the pixel
axis to a multiple of the device count (``_pad_pix``:119); here the
shards are uneven runs.

- **Frames are streamed.**  1000 × 61 MP float32 is ~244 GB, so the
  stack runs in row blocks (``stack_get_max_number_of_rows``,
  median_and_mean.c:1234): rows [y0, y1) of all N frames form one
  (N, rows·W) block, its height set by the per-device memory budget.
- **Pixels are sharded.**  Rank p of the mesh's ``pix`` dimension holds
  its run of the block's columns (``sharding.split_sizes``: uneven tails
  are uneven runs, no padding) with all N values, and stacks them with
  K1 (``ops.stacking.make_block_kernel``, the block kernel this module's
  ``_sharded_block_kernel``:74 twins).  The block's means are gathered
  over ``pix``; a rank of another frame group repeats its group's work.
- **Estimators stream frame by frame** (pass 1): one frame resident at a
  time, the lite median / MAD of its pixel shards by counts reduced over
  ``pix`` (``sharding.sharded_lite_estimators``): exact, so k ranks give
  the 1-rank result bit for bit.  A rank reads the row blocks that meet
  its shard of the frame.
- ``read_rows`` is called on whole row blocks (a reader seeded by its
  block, as the tests' is, must see the same calls on every rank), and a
  rank keeps its columns; the next frame or block is read on a thread
  into pinned memory while the current one is computed, and uploaded
  without blocking.

Plate solve and PCC then run on the stacked image on every rank
(astrometry_solver.c:881, photometric_cc.c:811).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from siril_tpu_torch.core.processing import check_cancelled
from siril_tpu_torch.parallel.sharding import (
    mesh_device,
    shard_range,
    sharded_lite_estimators,
    split_sizes,
)

_log = logging.getLogger(__name__)


def plan_survey_rows(n_frames: int, width: int, n_devices: int,
                     budget_bytes_per_dev: Optional[int] = None,
                     device: Optional[torch.device] = None) -> int:
    """Rows per streamed block: one device's part of the block is
    (N, rows·W/ndev)·4 B plus ~3× sort and loop scratch; keep it under the
    per-device budget (half of ``utils.devmem.memory_budget_bytes`` by
    default)."""
    if budget_bytes_per_dev is None:
        from siril_tpu_torch.utils.devmem import memory_budget_bytes

        budget_bytes_per_dev = memory_budget_bytes(
            device or torch.device("cpu")) // 2
    per_row_per_dev = n_frames * width * 4 * 4 // max(n_devices, 1)
    return max(int(budget_bytes_per_dev // max(per_row_per_dev, 1)), 8)


def coeffs_from_estimators(loc: np.ndarray, sca: np.ndarray, mode: int,
                           ref_pos: int, equalize_rgb: bool = False):
    """compute_factors_from_estimators (normalization.c:146) through the
    single implementation in ``ops.normalization``, as float32 (offset,
    scale, mul) of shape (L, n)."""
    from siril_tpu_torch.ops.normalization import factors_from_estimators

    offset, scale, mul = factors_from_estimators(
        loc, sca, mode, ref_pos, equalize_rgb=equalize_rgb)
    return (offset.astype(np.float32), scale.astype(np.float32),
            mul.astype(np.float32))


def _estimator_pass(read_rows: Callable[[int, int, int, int], np.ndarray],
                    rows: int, H: int, W: int, n: int, L: int, mesh,
                    lo: int, hi: int, prefetch: bool = True):
    """Pass 1: lite location / scale of every (channel, frame), one frame
    resident at a time, over the pixel shards [lo, hi) of ``pix``: the
    row blocks that meet [lo, hi) are read into a pinned buffer on a
    thread while the previous frame's estimators run."""
    dev = mesh_device(mesh)
    group = mesh.get_group("pix")
    jobs = [(k, c) for k in range(n) for c in range(L)]
    pin = dev.type == "cuda"
    bufs = [torch.empty(hi - lo, dtype=torch.float32, pin_memory=pin)
            for _ in range(2)]

    def fill(j):
        k, c = jobs[j]
        out = bufs[j % 2].numpy()
        for y0 in range(0, H, rows):
            a, b = y0 * W, min(y0 + rows, H) * W
            if b <= lo or a >= hi:
                continue
            blk = read_rows(k, c, y0, min(y0 + rows, H)).reshape(-1)
            s0, s1 = max(a, lo), min(b, hi)
            out[s0 - lo:s1 - lo] = blk[s0 - a:s1 - a]
        return bufs[j % 2]

    loc = np.zeros((L, n), np.float32)
    sca = np.zeros((L, n), np.float32)
    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        fut = pool.submit(fill, 0) if prefetch else None
        for j, (k, c) in enumerate(jobs):
            check_cancelled("survey stack")
            host = fut.result() if prefetch else fill(j)
            x = host.to(dev, non_blocking=True)[None]
            if prefetch and j + 1 < len(jobs):
                fut = pool.submit(fill, j + 1)
            e = sharded_lite_estimators(x, group)
            loc[c, k] = float(e["location"][0])
            sca[c, k] = float(e["scale"][0])
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return loc, sca


@dataclass
class SurveyStackResult:
    data: np.ndarray                    # (L, H, W) f32
    total_rejected: Tuple[int, int]
    elapsed_s: float
    rows_per_block: int
    n_blocks: int
    #: seconds per stage: estimators, read (waiting for a block), upload,
    #: kernel, fetch (the means gathered and copied to the host)
    stage_s: dict = field(default_factory=dict)


def _gather_pix(mesh, mean: torch.Tensor, sizes) -> torch.Tensor:
    """This rank's means → the whole block's, over ``pix`` (runs padded to
    the longest for ``all_gather``)."""
    if len(sizes) == 1:
        return mean
    m = max(sizes)
    buf = torch.zeros(m, dtype=mean.dtype, device=mean.device)
    buf[:mean.numel()] = mean
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf, group=mesh.get_group("pix"))
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def survey_stack_sharded(read_rows: Callable[[int, int, int, int],
                                             np.ndarray],
                         n: int, L: int, H: int, W: int, mesh,
                         rtype: int, mode: int,
                         siglow: float = 3.0, sighigh: float = 3.0,
                         ref_pos: int = 0,
                         budget_bytes_per_dev: Optional[int] = None,
                         prefetch: bool = True) -> SurveyStackResult:
    """Streamed, pixel-sharded rejection stack on every rank of ``mesh``.

    ``read_rows(frame, chan, y0, y1) → (y1 − y0, W) float32`` is the host
    reader (a partial FITS read, or a synthetic generator).  Every rank
    returns the whole (L, H, W) result."""
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.stacking import make_block_kernel

    t0 = time.perf_counter()
    dev = mesh_device(mesh)
    ndev = mesh.size()
    npix = mesh.size(1)
    me = mesh.get_local_rank("pix")
    rows = min(plan_survey_rows(n, W, ndev, budget_bytes_per_dev, dev), H)
    stages = {}

    def add(name, t):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t

    max_outliers, critical = 0, None
    if rtype == rj.GESDT:
        max_outliers = rj.gesdt_max_outliers(n, siglow)
        critical = rj.gesdt_critical_values(n, sighigh, max_outliers)

    t = time.perf_counter()
    lo, hi = shard_range(H * W, npix, me)
    loc, sca = _estimator_pass(read_rows, rows, H, W, n, L, mesh, lo, hi,
                               prefetch)
    offset, scale, mul = coeffs_from_estimators(loc, sca, mode, ref_pos)
    add("estimators", t)

    kernel = make_block_kernel(rtype, mode, float(siglow), float(sighigh),
                               n, max_outliers, critical)
    out = np.zeros((L, H, W), np.float32)
    tot = torch.zeros(2, dtype=torch.int64, device=dev)
    blocks = [(c, y0, min(y0 + rows, H))
              for c in range(L) for y0 in range(0, H, rows)]
    pin = dev.type == "cuda"

    def assemble(block):
        c, y0, y1 = block
        a, b = shard_range((y1 - y0) * W, npix, me)
        buf = torch.empty((n, b - a), dtype=torch.float32, pin_memory=pin)
        view = buf.numpy()
        for k in range(n):
            view[k] = read_rows(k, c, y0, y1).reshape(-1)[a:b]
        return buf

    pool = cf.ThreadPoolExecutor(max_workers=1)
    f32 = dict(dtype=torch.float32, device=dev)
    try:
        fut = pool.submit(assemble, blocks[0]) if prefetch else None
        for bi, block in enumerate(blocks):
            check_cancelled("survey stack")    # between blocks
            c, y0, y1 = block
            t = time.perf_counter()
            host = fut.result() if prefetch else assemble(block)
            add("read", t)
            if prefetch and bi + 1 < len(blocks):
                fut = pool.submit(assemble, blocks[bi + 1])
            t = time.perf_counter()
            x = host.to(dev, non_blocking=True)
            add("upload", t)
            t = time.perf_counter()
            if x.shape[1]:
                mean, rl, rh = kernel(x, torch.as_tensor(scale[c], **f32),
                                      torch.as_tensor(offset[c], **f32),
                                      torch.as_tensor(mul[c], **f32))
                tot += torch.stack([rl, rh])
            else:
                mean = torch.zeros(0, **f32)
            add("kernel", t)
            t = time.perf_counter()
            full = _gather_pix(mesh, mean, split_sizes((y1 - y0) * W, npix))
            out[c, y0:y1] = full.cpu().numpy().reshape(y1 - y0, W)
            add("fetch", t)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if npix > 1:
        dist.all_reduce(tot, group=mesh.get_group("pix"))
    tot = tot.tolist()
    res = SurveyStackResult(out, (int(tot[0]), int(tot[1])),
                            time.perf_counter() - t0, rows, len(blocks),
                            stages)
    _log.info("survey stack: %d×%d×%d×%d in %.1fs (%d blocks of %d rows, "
              "%d ranks)", n, L, H, W, res.elapsed_s, len(blocks), rows,
              ndev)
    return res


def survey_platesolve_pcc_stack(read_rows, n: int, L: int, H: int, W: int,
                                mesh, catalog, solve_args,
                                rtype: Optional[int] = None,
                                mode: Optional[int] = None,
                                siglow: float = 3.0, sighigh: float = 3.0,
                                budget_bytes_per_dev: Optional[int] = None):
    """The config-5 chain: the streamed sharded rejection stack, a plate
    solve of the result, then photometric colour calibration against the
    catalogue (three channels).  Returns (SirilImage with its WCS, the
    solve, the SurveyStackResult)."""
    from siril_tpu_torch.astrometry.pcc import photometric_color_calibration
    from siril_tpu_torch.astrometry.solver import solve_image
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    dev = mesh_device(mesh)
    rtype = rj.WINSORIZED if rtype is None else rtype
    mode = ADDITIVE_SCALING if mode is None else mode
    sres = survey_stack_sharded(read_rows, n, L, H, W, mesh, rtype, mode,
                                siglow, sighigh,
                                budget_bytes_per_dev=budget_bytes_per_dev)
    img = SirilImage(data=np.clip(sres.data, 0.0, 1.0))
    t = time.perf_counter()
    solve = solve_image(img, catalog, solve_args, device=dev)
    sres.stage_s["solve"] = time.perf_counter() - t
    img.wcs = solve.wcs if solve is not None else None
    if L == 3 and img.wcs is not None:
        t = time.perf_counter()
        pcc_img = photometric_color_calibration(img, catalog, device=dev)
        sres.stage_s["pcc"] = time.perf_counter() - t
        if pcc_img is not None:
            img = pcc_img
    return img, solve, sres
