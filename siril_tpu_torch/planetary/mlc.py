"""MultiLevelCorrelation, the MPP per-AP shift solver — counterpart of
``siril_tpu/planetary/mlc.py`` (``gaussian_kernel1d``:40,
``_subpixel_design``:50, ``penalty_matrix``:60, ``blur_gauss``:69-96,
``_tm_ccoeff_normed``:99, ``mlc_core``:143,
``multilevel_correlation_batch``:252; reference
``src/registration/mpp/mpp_align.cpp:269-408`` and the first-phase
penalty matrix of ``mpp_stack.cpp:216-231``).

Per (frame, AP) box, batched over all boxes on their device:
  phase 1 — the stride-2 window around the box, blurred again,
    TM_CCOEFF_NORMED against the stride-2 reference box, times the
    penalty matrix; the argmax (the first of equal maxima) is the even
    coarse shift, and a hit on the search border fails the solve;
  phase 2 — the full-resolution ±sw2 window around the coarse shift
    against the full reference box; a border hit keeps the coarse shift
    and fails;
  sub-pixel — a least-squares quadratic through the 3×3 neighbourhood of
    the phase-2 peak (a float32 pseudo-inverse, applied as nine
    multiply-adds in order), its vertex subtracted unless it lies more
    than a pixel away.

TM_CCOEFF_NORMED takes its window sums as direct sums over each offset,
not from an integral image (whose differences moved sub-pixel peaks by up
to 0.06 px against the golden, ``siril_tpu/planetary/mlc.py:111-115``),
in the JAX package's float32 summation order: one multiply-add over all
boxes and offsets per pixel of the box.  No matrix product is used, so
TF32 cannot round an input.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int) -> np.ndarray:
    """OpenCV getGaussianKernel semantics with sigma=0 → derived sigma
    0.3·((ksize−1)/2 − 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _subpixel_design() -> np.ndarray:
    """Pseudo-inverse of the quadratic design a·y²+b·x²+c·xy+d·x+e·y+f on
    the 3×3 grid centred at (0,0) — rows order (a,b,c,d,e,f)."""
    rows = []
    for y in (-1, 0, 1):
        for x in (-1, 0, 1):
            rows.append([y * y, x * x, x * y, x, y, 1.0])
    return np.linalg.pinv(np.asarray(rows)).astype(np.float32)  # (6, 9)


def penalty_matrix(sw1: int, penalty_factor: float) -> np.ndarray:
    """stack_build_first_phase_weight_matrix: (2·sw1+1)² with centre 1.0
    and quadratic off-centre penalty."""
    t = np.arange(2 * sw1 + 1, dtype=np.float32) / sw1 - 1.0
    return (1.0 - penalty_factor * (t[:, None] ** 2 + t[None, :] ** 2)
            ).astype(np.float32)


def blur_gauss(x: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur over the trailing two axes, reflect-padded
    (OpenCV's BORDER_REFLECT_101, torch's ``reflect``), as shifted
    weighted sums in the JAX package's order (frame_mono_blurred prep,
    cfg.frames_gauss_width)."""
    k = gaussian_kernel1d(int(ksize))
    p = int(ksize) // 2
    H, W = x.shape[-2:]
    lead = x.shape[:-2]
    xp = F.pad(x.reshape(-1, 1, H, W), (p, p, p, p), mode="reflect")[:, 0]
    out = 0.0
    for i in range(len(k)):
        out = out + float(k[i]) * xp[:, i:i + H, :]
    out2 = 0.0
    for i in range(len(k)):
        out2 = out2 + float(k[i]) * out[:, :, i:i + W]
    return out2.reshape(*lead, H, W)


def _tiles(n: int):
    """XLA:CPU's split of a reduced axis of ``n`` (its tree-reduction
    rewrite): past 32 the axis is padded evenly to a multiple of 32 and
    cut into tiles of 32; the (start, stop) of each tile's real part."""
    if n <= 32:
        return [(0, n)]
    before = (-(-n // 32) * 32 - n) // 2
    return [(max(t, 0), min(t + 32, n)) for t in range(-before, n, 32)]


def _box_sums(terms, h: int, w: int, fused: bool):
    """Σ over an h × w box, in XLA:CPU's order, of each term: each tile
    row-major from its first value, the tiles summed along a row of
    tiles, then the rows.  A term is ``(a, b)``: called once for a group
    of tiles (their origins and shape), each returns the function of
    (i, j) that gives the tensors whose product is summed there (``b``
    None for a plain sum).  ``fused`` contracts each product into its sum
    with one rounding (XLA:CPU's fused multiply-add: an exact float64
    product, the sum rounded to float32), else the product is rounded
    first.  Tiles of one shape are summed together, each step one
    operation over all of them."""
    rows_t, cols_t = _tiles(h), _tiles(w)
    grid = [(r, c) for r in rows_t for c in cols_t]
    parts = {}
    for shape in sorted({(r1 - r0, c1 - c0) for (r0, r1), (c0, c1) in grid}):
        group = [(r0, c0) for (r0, r1), (c0, c1) in grid
                 if (r1 - r0, c1 - c0) == shape]
        fns = [(a(group, shape), None if b is None else b(group, shape))
               for a, b in terms]
        accs = [None] * len(terms)
        for i in range(shape[0]):
            for j in range(shape[1]):
                for k, (a, b) in enumerate(fns):
                    v = a(i, j)
                    if b is not None:
                        v = v * b(i, j)
                    if fused and b is not None:
                        v = v if accs[k] is None else v + accs[k].double()
                        accs[k] = v.float()
                    else:
                        accs[k] = v if accs[k] is None else accs[k] + v
        for n, key in enumerate(group):
            parts[key] = [acc[n] for acc in accs]
    out = []
    for k in range(len(terms)):
        total = None
        for r0, _ in rows_t:
            row = None
            for c0, _ in cols_t:
                v = parts[(r0, c0)][k]
                row = v if row is None else row + v
            total = row if total is None else total + row
        out.append(total)
    return out


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's float32 sqrt on the
    CPU is not)."""
    return torch.sqrt(x.double()).float()


def _tm_ccoeff_normed(windows: torch.Tensor, templ: torch.Tensor,
                      tidx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched TM_CCOEFF_NORMED: windows (B, Hw, Ww) against templ (B, h,
    w) — or (T, h, w) taken as ``templ[tidx[b]]`` for box b — →
    (B, Hw−h+1, Ww−w+1): the zero-mean template's correlation over the
    window's deviation norm at each offset, 0 where that product is 0.

    The sums at every offset are direct, and run in the JAX package's
    float32 order (``_box_sums``): Σ I·t and Σ I² with the product
    contracted into the sum where the box fits one tile of 32 (XLA:CPU's
    fused multiply-add), the product rounded first where it is tiled;
    1/area a multiplication by its float32 reciprocal, and ``s2 −
    s1²·(1/area)`` one fused multiply-add.  That difference cancels most
    of its digits, so only the same order keeps the two packages'
    correlations and sub-pixel peaks together: bit-equal on the same
    inputs where the box is tiled (phase 2 at the default 48 px), within
    about an ULP of the template's norm where it is not."""
    B, Hw, Ww = windows.shape
    h, w = templ.shape[1], templ.shape[2]
    ny, nx = Hw - h + 1, Ww - w + 1
    fused = h <= 32 and w <= 32
    inv = torch.tensor(np.float32(1.0 / (h * w)), device=windows.device)
    tb = templ if tidx is None else templ.index_select(0, tidx)
    x = windows.double() if fused else windows
    xsq = None if fused else windows * windows

    def tap(a, last=False):
        """The value at (i, j) of each tile of (B, h, w) ``a``: (T, B),
        or (T, B, 1, 1) with ``last``."""
        def prep(group, shape):
            st = torch.stack([a[:, r:r + shape[0], c:c + shape[1]]
                              for r, c in group])
            if last:
                return lambda i, j: st[:, :, i, j, None, None]
            return lambda i, j: st[:, :, i, j]
        return prep

    def win(a):
        """The (ny, nx) windows at (i, j) of each tile: (T, B, ny, nx)."""
        def prep(group, shape):
            st = torch.stack([a[:, r:r + shape[0] + ny - 1,
                                c:c + shape[1] + nx - 1] for r, c in group])
            return lambda i, j: st[:, :, i:i + ny, j:j + nx]
        return prep

    (tsum,) = _box_sums([(tap(tb), None)], h, w, False)
    t = tb - (tsum * inv)[:, None, None]
    tt = t.double() if fused else t
    (tn,) = _box_sums([(tap(tt), tap(tt))], h, w, fused)
    tnorm = _sqrt(tn)

    c, s1, s2 = _box_sums([(win(x), tap(tt, last=True)), (win(windows), None),
                           (win(x), win(x)) if fused else (win(xsq), None)],
                          h, w, fused)
    # s2 − (s1²)·inv with one rounding, as XLA:CPU contracts it
    ivar = (s2.double() - (s1 * s1).double() * inv.double()).float()
    denom = tnorm[:, None, None] * _sqrt(torch.clamp(ivar, min=0.0))
    return torch.where(denom > 1e-12, c / torch.clamp(denom, min=1e-12),
                       torch.zeros((), device=c.device))


def _cut(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
         size: int) -> torch.Tensor:
    """(B, size, size) windows of (B, H, W) ``x`` at per-box origins."""
    r = torch.arange(size, device=x.device)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, (y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def mlc_core(box: int, sw1: int, sw2: int, gauss_width: int,
             penalty_factor: float, subpixel: bool):
    """The batched two-phase solver for one geometry: ``run(big,
    ref_full, ref_p1, tidx=None, surfaces=False)`` on big windows
    (B, box+2·E, box+2·E) (E = 2·sw1 + sw2) cut from the BLURRED frame
    around each AP box and the reference boxes (B, box, box) and their
    stride-2 versions (or (T, …) with the box → template map ``tidx``),
    returning (dy, dx, success), each (B,) on the windows' device, and
    with ``surfaces`` the two phases' correlation surfaces after them."""
    index_ext = 2 * sw1
    E = index_ext + sw2
    pen_np = penalty_matrix(sw1, penalty_factor)
    design_np = _subpixel_design()

    def run(big, ref_full, ref_p1, tidx=None, surfaces=False):
        dev = big.device
        B = big.shape[0]
        pen = torch.from_numpy(pen_np).to(dev)
        design = torch.from_numpy(design_np).to(dev)
        zero = torch.zeros((), device=dev)
        # phase 1: stride 2 and a blur, the penalty-weighted argmax
        w1 = big[:, sw2:sw2 + box + 2 * index_ext,
                 sw2:sw2 + box + 2 * index_ext]
        w1b = blur_gauss(w1[:, ::2, ::2].contiguous(), gauss_width)
        ccr1 = _tm_ccoeff_normed(w1b, ref_p1, tidx) * pen[None]
        n1 = ccr1.shape[1]
        am1 = torch.argmax(ccr1.reshape(B, -1), dim=1)
        my1, mx1 = am1 // n1, am1 % n1
        sy1 = (sw1 - my1) * 2
        sx1 = (sw1 - mx1) * 2
        ok1 = (sy1.abs() != index_ext) & (sx1.abs() != index_ext)

        # phase 2: full resolution, ±sw2 around the coarse shift
        w2 = _cut(big, E - sy1 - sw2, E - sx1 - sw2, box + 2 * sw2)
        ccr2 = _tm_ccoeff_normed(w2, ref_full, tidx)
        n2 = 2 * sw2 + 1
        am2 = torch.argmax(ccr2.reshape(B, -1), dim=1)
        my2, mx2 = am2 // n2, am2 % n2
        sy2 = sw2 - my2
        sx2 = sw2 - mx2
        ok2 = (sy2.abs() != sw2) & (sx2.abs() != sw2)
        y_tot = (sy1 + torch.where(ok2, sy2, 0)).float()
        x_tot = (sx1 + torch.where(ok2, sx2, 0)).float()

        if subpixel:
            interior = ok2 & (my2 > 0) & (my2 < n2 - 1) & \
                (mx2 > 0) & (mx2 < n2 - 1)
            cy = torch.clamp(my2, 1, n2 - 2)
            cx = torch.clamp(mx2, 1, n2 - 2)
            patch = _cut(ccr2, cy - 1, cx - 1, 3).reshape(B, 9)
            # the design product as nine multiply-adds in order: the same
            # on every device (cuBLAS picks its kernel, and its rounding,
            # by the batch)
            co = patch[:, :1] * design[None, :, 0]
            for k in range(1, 9):
                co = co + patch[:, k:k + 1] * design[None, :, k]
            a_f, b_f, c_f, d_f, e_f = (co[:, 0], co[:, 1], co[:, 2],
                                       co[:, 3], co[:, 4])
            one = torch.ones((), device=dev)
            denom_y = c_f * c_f - 4.0 * a_f * b_f
            has_y = denom_y.abs() > 1e-10
            yc = torch.where(has_y, (2.0 * a_f * e_f - c_f * d_f)
                             / torch.where(has_y, denom_y, one), zero)
            has_a = a_f.abs() > 1e-10
            has_c = c_f.abs() > 1e-10
            xc_a = (-c_f * yc - d_f) / torch.where(has_a, 2.0 * a_f, one)
            xc_c = (-2.0 * b_f * yc - e_f) / torch.where(has_c, c_f, one)
            use_a = has_y & has_a
            use_c = has_y & ~has_a & has_c
            xc = torch.where(use_a, xc_a, torch.where(use_c, xc_c, zero))
            good = interior & (use_a | use_c) & (yc.abs() <= 1.0) & \
                (xc.abs() <= 1.0)
            y_tot = y_tot - torch.where(good, yc, zero)
            x_tot = x_tot - torch.where(good, xc, zero)

        success = ok1 & ok2
        y_tot = torch.where(ok1, y_tot, zero)
        x_tot = torch.where(ok1, x_tot, zero)
        if surfaces:
            return y_tot, x_tot, success, ccr1, ccr2
        return y_tot, x_tot, success

    return run


def multilevel_correlation_batch(big_windows, ref_boxes, *,
                                 search_width: int = 14,
                                 gauss_width: int = 7,
                                 penalty_factor: float = 0.00025,
                                 subpixel: bool = True, device=None):
    """Per-box shifts of a batch: ``big_windows`` (B, box+2·E, box+2·E)
    of the BLURRED frame around each AP box, ``ref_boxes`` (B, box, box)
    of the blurred reference; (dy, dx, success) numpy arrays, each (B,)."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    sw2 = 4
    sw1 = (search_width - sw2) // 2
    box = int(ref_boxes.shape[1])
    refs = torch.as_tensor(np.asarray(ref_boxes, np.float32)).to(dev)
    run = mlc_core(box, sw1, sw2, int(gauss_width), float(penalty_factor),
                   bool(subpixel))
    dy, dx, ok = run(torch.as_tensor(np.asarray(big_windows, np.float32)
                                     ).to(dev),
                     refs, refs[:, ::2, ::2].contiguous())
    return dy.cpu().numpy(), dx.cpu().numpy(), ok.cpu().numpy()


def mlc_window_extent(search_width: int = 14) -> int:
    """Half-extent E to add around the AP box when cutting frame windows:
    index_ext (phase 1) + sw2 (phase 2)."""
    sw2 = 4
    sw1 = (search_width - sw2) // 2
    return 2 * sw1 + sw2
