"""Multi-device stacking over ``torch.distributed`` — counterpart of
``siril_tpu/parallel/sharding.py`` (``make_mesh``:32, ``full_stack_step``
:43, ``sharded_rejection_kernel``:111, ``fused_pipeline_step``:127).

The mesh has two dimensions, as the JAX package's:

  - ``frame``: the data-parallel axis of per-frame work (calibration,
    estimators, warps): each frame group owns a block of frames;
  - ``pix``: the sharded pixel axis of the stack: every rank holds all N
    values of its pixel columns, so rejection never crosses ranks (the
    row-block design of ``median_and_mean.c:1384``).

XLA inserts the collectives of the JAX package from sharding
annotations; here each step is a plain function of the rank's own shard
and its collectives are explicit, on the mesh's sub-groups:

  - the (N,) estimators: exact order statistics by counts reduced over
    ``pix`` (``sharded_lite_estimators``), or frame-local estimators
    gathered over ``pix`` and ``frame`` (a sum of zero-filled vectors,
    one writer per slot, so exact);
  - the frame-sharded → pixel-sharded reshard of the fused step
    (``sharding.py:243``): ``all_to_all_single`` over ``pix`` inside a
    frame group, then ``all_gather`` over ``frame``;
  - the rejection totals: a sum over ``pix``.

Each rank stacks its pixel columns with ``ops.stacking.make_block_kernel``:
kernel K1 on a CUDA tensor, its plain version on the CPU.  A column's
result depends on its own column only, so k ranks give the 1-rank result
bit for bit.

The caller starts the process group (``torchrun --nproc-per-node=K``, or
``torch.distributed.init_process_group`` with its address, world size and
rank); ``make_mesh`` raises without one.  NCCL takes one card a rank; gloo
runs the same code on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops.normalization import (
    ADDITIVE,
    ADDITIVE_SCALING,
    MULTIPLICATIVE,
    MULTIPLICATIVE_SCALING,
)

#: |shift| bound of the separable translation warp (sharding.py:156)
MARGIN = 8

_INV_U16 = float(np.float32(1.0 / 65535.0))
_KEY_MAX = torch.iinfo(torch.int32).max


def make_mesh(n_frame_groups: int = 1, n_pix_shards: Optional[int] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape (n_frame_groups, n_pix_shards) with the
    dimensions ("frame", "pix") over the started process group: on
    ``device_type``, by default "cuda" where the group has NCCL (one card
    a rank), else "cpu" (gloo).  A group started with
    ``backend="cuda:nccl,cpu:gloo"`` takes a mesh of either kind."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a started torch.distributed process group "
            "(torchrun, or init_process_group with its address, world size "
            "and rank)")
    world = dist.get_world_size()
    if n_pix_shards is None:
        n_pix_shards = world // n_frame_groups
    if n_frame_groups * n_pix_shards != world:
        raise ValueError(f"a {n_frame_groups}×{n_pix_shards} mesh needs "
                         f"{n_frame_groups * n_pix_shards} ranks, the "
                         f"group has {world}")
    kind = device_type or ("cuda" if "nccl" in dist.get_backend()
                           else "cpu")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, (n_frame_groups, n_pix_shards),
                            mesh_dim_names=("frame", "pix"))


def mesh_device(mesh) -> torch.device:
    """The torch device of this rank's shard of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def split_sizes(total: int, parts: int) -> List[int]:
    """``total`` items in ``parts`` contiguous runs, the first
    ``total % parts`` one longer (``torch.tensor_split``'s sizes)."""
    q, r = divmod(int(total), int(parts))
    return [q + (1 if i < r else 0) for i in range(parts)]


def shard_range(total: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of run ``index`` of ``split_sizes(total, parts)``."""
    sizes = split_sizes(total, parts)
    start = sum(sizes[:index])
    return start, start + sizes[index]


def local_pixels(mesh, p: int) -> Tuple[int, int]:
    """This rank's columns of a P-pixel stack (split over ``pix``)."""
    return shard_range(p, mesh.size(1), mesh.get_local_rank("pix"))


def local_frames(mesh, n: int) -> Tuple[int, int]:
    """This rank's frames of an N-frame fused step: frame group f owns
    frames [f·N/F, (f+1)·N/F), split over its ``pix`` ranks."""
    F = mesh.size(0)
    if n % F:
        raise ValueError(f"{n} frames do not split over {F} frame groups")
    g = n // F
    a, b = shard_range(g, mesh.size(1), mesh.get_local_rank("pix"))
    f0 = mesh.get_local_rank("frame") * g
    return f0 + a, f0 + b


# ---------------------------------------------------------------------------
# exact order statistics over pixel shards
# ---------------------------------------------------------------------------


def _ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys in the order of the float32 values (−0 just below +0)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _key_values(k: torch.Tensor) -> torch.Tensor:
    """float32 values of int32 keys (the inverse of ``_ordered_keys``)."""
    k = k.to(torch.int32)
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


#: the bisection's split of an interval per pass (8 passes cover 2³²)
WAYS = 16


def sharded_order_stat(x: torch.Tensor, valid: torch.Tensor,
                       ranks: List[torch.Tensor],
                       group=None) -> List[torch.Tensor]:
    """The ``ranks``-th smallest valid values (1-based, (R,) int64 each)
    of the rows of ``x`` (R, P_local) over every shard of ``group``.

    A WAYS-way bisection in key space: each pass counts, on the
    locally sorted keys, the values at or below WAYS − 1 thresholds
    of every interval, and sums the counts over the group as int64; the
    extremes are a MIN and a MAX.  Integer counts reduce without
    rounding, so the result is the same order statistic on any number of
    shards — the sorted value itself (the sort-based ``median_rows``).
    The JAX package's ``hist_median_jax`` (statistics.py:344) bisects in
    value space for the TPU; a key bisection ends on a sample."""
    R = x.shape[0]
    dev = x.device
    keys = torch.where(valid, _ordered_keys(x),
                       torch.tensor(_KEY_MAX, dtype=torch.int32,
                                    device=dev))
    keys = torch.sort(keys, dim=-1).values
    pad = torch.full((R, 1), _KEY_MAX, dtype=torch.int32, device=dev)
    lo = torch.cat([keys, pad], -1).min(-1).values.long()
    top = torch.where(valid, _ordered_keys(x),
                      torch.tensor(-_KEY_MAX - 1, dtype=torch.int32,
                                   device=dev))
    hi = torch.cat([top, -pad - 1], -1).max(-1).values.long()
    ext = torch.stack([lo, -hi])
    _all_reduce(ext, dist.ReduceOp.MIN, group)
    lo, hi = ext[0], -ext[1]
    frac = torch.arange(1, WAYS, dtype=torch.int64, device=dev)
    los = [lo.clone() for _ in ranks]
    his = [hi.clone() for _ in ranks]
    while True:
        open_ = [h > lw for lw, h in zip(los, his)]
        if not bool(torch.stack(open_).any()):
            break
        thr = [lw[:, None] + ((h - lw)[:, None] * frac) // WAYS
               for lw, h in zip(los, his)]
        cnt = torch.searchsorted(keys, torch.cat(thr, -1).to(torch.int32),
                                 right=True).long()
        _all_reduce(cnt, dist.ReduceOp.SUM, group)
        for j, k in enumerate(ranks):
            c = cnt[:, j * (WAYS - 1):(j + 1) * (WAYS - 1)]
            t = thr[j]
            below = (c < k[:, None]).sum(-1)       # thresholds under rank
            first = torch.clamp(below, max=WAYS - 2)
            take = below < WAYS - 1
            new_hi = torch.where(take, t.gather(-1, first[:, None])[:, 0],
                                 his[j])
            prev = torch.clamp(below - 1, min=0)
            new_lo = torch.where(below > 0,
                                 t.gather(-1, prev[:, None])[:, 0] + 1,
                                 los[j])
            his[j] = torch.where(open_[j], new_hi, his[j])
            los[j] = torch.where(open_[j], new_lo, los[j])
    return [_key_values(h) for h in his]


def sharded_median(x: torch.Tensor, valid: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Median of the valid values of each row over the shards of
    ``group``: the lower-median sample, the middle pair averaged for an
    even count, 0 for an empty row (``statistics.median_rows``)."""
    n = valid.sum(-1, dtype=torch.int64)
    _all_reduce(n, dist.ReduceOp.SUM, group)
    k_lo = torch.clamp((n + 1) // 2, min=1)
    k_hi = torch.clamp(n // 2 + 1, max=torch.clamp(n, min=1))
    v_lo, v_hi = sharded_order_stat(x, valid, [k_lo, k_hi], group)
    med = torch.where(n % 2 == 0, 0.5 * (v_lo + v_hi), v_lo)
    return torch.where(n > 0, med, 0.0)


def sharded_lite_estimators(x: torch.Tensor, group=None) -> dict:
    """Lite normalization estimators of the rows of ``x`` (R, P_local)
    over the pixel shards of ``group``: median and MAD of the non-zero
    finite pixels, location = median, scale = 1.5·MAD
    (``norm_estimators_hist_jax(…, lite=True)``, statistics.py:413)."""
    valid = (x != 0.0) & torch.isfinite(x)
    med = sharded_median(x, valid, group)
    mad = sharded_median(torch.abs(x - med[:, None]), valid, group)
    return {"median": med, "mad": mad, "location": med, "scale": 1.5 * mad}


# ---------------------------------------------------------------------------
# normalization coefficients of the sharded steps (sharding.py:70-84)
# ---------------------------------------------------------------------------


def _step_coeffs(loc: torch.Tensor, sca: torch.Tensor, ref_pos: int,
                 mode: int):
    """(scale, offset, mul) of the sharded steps: per-frame factors
    against the reference frame's estimators, as K1 takes them."""
    loc0, sca0 = loc[ref_pos], sca[ref_pos]
    one = torch.ones_like(loc)
    if mode in (ADDITIVE_SCALING, MULTIPLICATIVE_SCALING):
        scale = torch.where(sca == 0.0, 1.0,
                            sca0 / torch.where(sca == 0, 1.0, sca))
    else:
        scale = one
    offset = torch.zeros_like(loc)
    mul = one
    if mode in (ADDITIVE, ADDITIVE_SCALING):
        offset = scale * loc - loc0
    elif mode in (MULTIPLICATIVE, MULTIPLICATIVE_SCALING):
        mul = torch.where(loc == 0.0, 1.0,
                          loc0 / torch.where(loc == 0, 1.0, loc))
    return scale, offset, mul


def _stack_local(block: torch.Tensor, scale, offset, mul, rtype: int,
                 mode: int, siglow: float, sighigh: float, n_frames: int,
                 want_maps: bool):
    """K1 (or its plain version on the CPU) over this rank's columns."""
    from siril_tpu_torch.ops.stacking import make_block_kernel

    critical, max_outliers = None, 0
    if rtype == rj.GESDT:
        max_outliers = rj.gesdt_max_outliers(n_frames, siglow)
        critical = rj.gesdt_critical_values(n_frames, sighigh, max_outliers)
    p = block.shape[1]
    if p == 0:
        z = torch.zeros(0, dtype=torch.int32, device=block.device)
        zero = torch.zeros((), dtype=torch.int64, device=block.device)
        return (torch.zeros(0, device=block.device),
                *((z, z) if want_maps else (zero, zero)))
    run = make_block_kernel(rtype, mode, float(siglow), float(sighigh),
                            n_frames, max_outliers, critical,
                            want_maps=want_maps)
    return run(block, scale, offset, mul)


def full_stack_step(mesh, rtype: int, mode: int, siglow: float,
                    sighigh: float, n_frames: int):
    """The multi-device stack step (sharding.py:43):

      frames (N/F, P/Pn) on rank (f, p)
        → lite median/MAD estimators       [pixel shards, counts over pix]
        → the (N,) estimators              [gathered over frame]
        → the frame group's blocks gathered [all_gather over frame]
        → normalize + reject + mean        [K1 on the rank's columns]

    Returns ``step(stack_local, ref_pos) → (mean, rej_low, rej_high)`` on
    the rank's pixel columns; ``stack_local`` is this rank's frames
    (``N/F`` of them, frame group f's) × its columns (``local_pixels``)."""
    fgroup, pgroup = mesh.get_group("frame"), mesh.get_group("pix")
    F = mesh.size(0)

    def step(stack_local: torch.Tensor, ref_pos: int):
        x = stack_local.float()
        est = sharded_lite_estimators(x, pgroup)
        parts = [torch.empty_like(x) for _ in range(F)]
        pair = torch.stack([est["location"], est["scale"]])
        pairs = [torch.empty_like(pair) for _ in range(F)]
        dist.all_gather(pairs, pair, group=fgroup)
        dist.all_gather(parts, x, group=fgroup)
        loc = torch.cat([q[0] for q in pairs])
        sca = torch.cat([q[1] for q in pairs])
        scale, offset, mul = _step_coeffs(loc, sca, ref_pos, mode)
        return _stack_local(torch.cat(parts), scale, offset, mul, rtype,
                            mode, siglow, sighigh, n_frames, True)

    return step


def sharded_rejection_kernel(mesh, rtype: int, siglow: float,
                             sighigh: float, n_frames: int):
    """Rejection only, on a normalized stack already sharded by pixel
    columns (sharding.py:111): ``step(stack_local (N, P/Pn)) → (mean,
    rej_low, rej_high)`` per column."""
    from siril_tpu_torch.ops.normalization import NO_NORM

    def step(stack_local: torch.Tensor):
        x = stack_local.float()
        ones = torch.ones(x.shape[0], device=x.device)
        return _stack_local(x, ones, torch.zeros_like(ones), ones, rtype,
                            NO_NORM, siglow, sighigh, n_frames, True)

    return step


# ---------------------------------------------------------------------------
# the fused step (sharding.py:127)
# ---------------------------------------------------------------------------


def shift_frames(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Separable bilinear translation of (n, H, W) frames by (n, 2) ``d``:
    out(x) = in(x − d), |d| ≤ MARGIN, 0 outside (``_shift_one``,
    sharding.py:158-172; the real pipeline's fast path)."""
    n, H, W = p.shape
    pad = MARGIN + 2
    big = torch.nn.functional.pad(p, (pad, pad, pad, pad))
    out = torch.empty_like(p)
    for i in range(n):
        sx = -d[i, 0]
        sy = -d[i, 1]
        ix = torch.clamp(torch.floor(sx), -MARGIN, MARGIN)
        iy = torch.clamp(torch.floor(sy), -MARGIN, MARGIN)
        fx = sx - ix
        fy = sy - iy
        y0, x0 = pad + int(iy), pad + int(ix)
        base = big[i, y0:y0 + H + 1, x0:x0 + W + 1]
        gy = (1.0 - fy) * base[:H] + fy * base[1:H + 1]
        out[i] = (1.0 - fx) * gy[:, :W] + fx * gy[:, 1:W + 1]
    return out


def _warp(x: torch.Tensor, Hinvs: torch.Tensor, height: int, width: int,
          interp_method: int, shift_warp: bool, rot_warp: bool,
          aff_warp: bool, persp_warp: int) -> torch.Tensor:
    """The per-frame warp of the fused step (sharding.py:184-238); no
    cross-rank traffic.  An FFT rung takes one frame a call, so that a
    frame's FFTs do not depend on the frames that share its rank
    (pocketfft's batched transforms round differently from single ones)."""
    from siril_tpu_torch.ops import interp

    n = x.shape[0]
    if shift_warp:
        return shift_frames(x, Hinvs)
    if not (rot_warp or aff_warp or persp_warp):
        hv = Hinvs.detach().cpu().numpy().astype(np.float32)
        return torch.stack([
            interp._warp_body(x[i][None], hv[i].reshape(3, 3), height,
                              width, interp_method, False)[0]
            for i in range(n)]) if n else x
    out = torch.empty_like(x)
    for i in range(n):
        h, fr = Hinvs[i:i + 1], x[i:i + 1, None]
        if rot_warp:
            w = interp.rot_shear_core(fr, h[:, 0], h[:, 1], h[:, 2:4],
                                      h[:, 4] > 0.5, clamp=False)
        elif aff_warp:
            w = interp.affine_czt_core(
                fr, h[:, :4].reshape(-1, 2, 2), h[:, 4:6], h[:, 6] > 0.5,
                (h[:, 7], h[:, 8]), (h[:, 9], h[:, 10]), clamp=False)
        else:
            w = interp.perspective_czt_core(
                fr, h[:, :4].reshape(-1, 2, 2), h[:, 4:6],
                h[:, 6:15].reshape(-1, 3, 3), h[:, 15] > 0.5,
                (h[:, 16], h[:, 17]), (h[:, 18], h[:, 19]),
                D=int(persp_warp), clamp=False)
        out[i] = w[0, 0]
    return out


def reshard_frames_to_pixels(mesh, warped: torch.Tensor,
                             n_frames: int) -> torch.Tensor:
    """(n_local, P) frames of this rank → (N, P/Pn) all frames of its
    pixel columns: ``all_to_all_single`` over ``pix`` (uneven frame and
    column counts as split sizes) gathers the frame group's frames, then
    ``all_gather`` over ``frame`` the other groups' — the all_to_all XLA
    inserts at sharding.py:243."""
    Pn, F = mesh.size(1), mesh.size(0)
    P = warped.shape[1]
    g = n_frames // F
    fr_sizes = split_sizes(g, Pn)
    px_sizes = split_sizes(P, Pn)
    me = mesh.get_local_rank("pix")
    n_loc = fr_sizes[me]
    edges = np.cumsum([0] + px_sizes)
    send = torch.cat([warped[:, edges[j]:edges[j + 1]].reshape(-1)
                      for j in range(Pn)]) if Pn > 1 else warped.reshape(-1)
    recv = torch.empty(g * px_sizes[me], dtype=warped.dtype,
                       device=warped.device)
    dist.all_to_all_single(recv, send.contiguous(),
                           [px_sizes[me] * c for c in fr_sizes],
                           [n_loc * s for s in px_sizes],
                           group=mesh.get_group("pix"))
    block = recv.reshape(g, px_sizes[me])
    if F == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(F)]
    dist.all_gather(parts, block, group=mesh.get_group("frame"))
    return torch.cat(parts)


def gather_frame_values(mesh, v: torch.Tensor, n_frames: int,
                        start: int) -> torch.Tensor:
    """(n_local,) per-frame values of this rank's frames [start, …) → the
    (N,) vector on every rank: zero-filled vectors summed over ``pix``
    then ``frame`` (one writer per slot, so the sum is exact).  Every
    ``pix`` rank of a frame group holds different frames, every group
    the same vector after the first sum."""
    full = torch.zeros(n_frames, dtype=v.dtype, device=v.device)
    full[start:start + v.shape[0]] = v
    _all_reduce(full, dist.ReduceOp.SUM, mesh.get_group("pix"))
    if mesh.size(0) > 1:
        g = n_frames // mesh.size(0)
        f = mesh.get_local_rank("frame")
        own = torch.zeros_like(full)
        own[f * g:(f + 1) * g] = full[f * g:(f + 1) * g]
        full = _all_reduce(own, dist.ReduceOp.SUM, mesh.get_group("frame"))
    return full


def fused_pipeline_step(mesh, rtype: int, mode: int, siglow: float,
                        sighigh: float, n_frames: int, height: int,
                        width: int, interp_method: int = 1,
                        shift_warp: bool = False, rot_warp: bool = False,
                        aff_warp: bool = False, persp_warp: int = 0,
                        lite_norm: bool = True):
    """The multi-device fused calibrate → warp → stack step
    (sharding.py:127):

      raw i16 frames of this rank (``local_frames``)
        → decode + dark/flat calibration            [frame-local]
        → per-frame estimators, pre-warp            [frame-local]
        → per-frame warp                            [frame-local]
        → (N,) estimators                           [sum over pix, frame]
        → reshard (n_local, H·W) → (N, H·W/Pn)      [all_to_all, all_gather]
        → normalize + reject + mean                 [K1 on the columns]

    Returns ``step(raw_local, Hinvs_local, dark, flat, ref_pos) → (mean,
    rej_low, rej_high)``: the mean of the rank's columns (``local_pixels``
    of H·W) and the rejection totals over the whole image.  ``Hinvs_local``
    holds the rank's frames' warp parameters in the JAX package's layouts:
    (n, 3, 3) inverse homographies, (n, 2) translations with
    ``shift_warp``, (n, 5) rotations with ``rot_warp``, (n, 11) affines
    with ``aff_warp``, (n, 20) perspective splits with ``persp_warp`` = D."""
    from siril_tpu_torch.ops.statistics import norm_estimators

    pgroup = mesh.get_group("pix")

    def step(raw_i16, Hinvs, dark, flat, ref_pos: int):
        start, _ = local_frames(mesh, n_frames)
        x = (raw_i16.float() + 32768.0) * _INV_U16
        x = x - dark[None]
        fl = torch.where(flat == 0.0, 1.0, flat)[None]
        x = torch.where(flat[None] == 0.0, 0.0, x / fl)
        n = x.shape[0]
        est = norm_estimators(x.reshape(n, height * width), lite=lite_norm)
        warped = _warp(x, Hinvs, height, width, interp_method, shift_warp,
                       rot_warp, aff_warp, persp_warp)
        loc = gather_frame_values(mesh, est["location"], n_frames, start)
        sca = gather_frame_values(mesh, est["scale"], n_frames, start)
        block = reshard_frames_to_pixels(
            mesh, warped.reshape(n, height * width), n_frames)
        scale, offset, mul = _step_coeffs(loc, sca, ref_pos, mode)
        mean, rl, rh = _stack_local(block, scale, offset, mul, rtype, mode,
                                    siglow, sighigh, n_frames, False)
        tot = torch.stack([rl, rh]).to(torch.int64)
        _all_reduce(tot, dist.ReduceOp.SUM, pgroup)
        return mean, tot[0], tot[1]

    return step

