"""The guided filter's box mean at full size: the JAX package's float32
integral image (``siril_tpu/ops/filters.py:_box``) and the port's float64
one (``siril_tpu_torch/ops/filters.py:box_mean``) against an exact float64
box, on a 2048² sky of 0.1 with noise σ 0.01, r = 8 (the guided filter's
default radius).  Runs on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/box_departure.py [--size 2048]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--radius", type=int, default=8)
    a = ap.parse_args()
    import torch

    from siril_tpu.ops.filters import _box
    from siril_tpu_torch.ops.filters import box_mean

    rng = np.random.default_rng(0)
    x = (0.1 + 0.01 * rng.standard_normal((1, a.size, a.size))).astype(
        np.float32)
    r = a.radius
    c = np.pad(np.pad(x[0].astype(np.float64), r, mode="edge").cumsum(0)
               .cumsum(1), ((1, 0), (1, 0)))
    n = 2 * r + 1
    exact = ((c[n:, n:] - c[:-n, n:] - c[n:, :-n] + c[:-n, :-n])
             / (n * n))[None]
    for name, got in (("JAX package (float32 integral image)",
                       np.asarray(_box(x, a.radius), np.float64)),
                      ("port (float64 integral image)",
                       box_mean(torch.from_numpy(x), a.radius).double()
                       .numpy())):
        err = np.abs(got - exact)
        far = err[:, a.size // 2:, a.size // 2:].mean()
        print(f"{name}: max |Δ| {err.max():.3g}, mean {err.mean():.3g}, "
              f"far quarter mean {far:.3g}")


if __name__ == "__main__":
    main()
