"""Standalone FITS comparator — counterpart of
``siril_tpu/tools/compare_fits.py`` (the reference's
``tests/compare_fits.c``): the golden-diff gate.  Exit code 0: identical
within the tolerance; 1: pixels differ; 2: shapes differ, or usage.

Usage: python -m siril_tpu_torch.tools.compare_fits a.fit b.fit [abs_tol]
"""

from __future__ import annotations

import sys

import numpy as np


def compare(path_a: str, path_b: str, tol: float = 0.0) -> int:
    from siril_tpu_torch.io.fits_io import read_fits

    a = read_fits(path_a)
    b = read_fits(path_b)
    if a.host().shape != b.host().shape:
        print(f"DIFFER: shapes {a.host().shape} vs {b.host().shape}")
        return 2
    da = a.host().astype(np.float64)
    db = b.host().astype(np.float64)
    diff = np.abs(da - db)
    nbad = int((diff > tol).sum())
    if nbad:
        idx = np.unravel_index(int(np.argmax(diff)), diff.shape)
        print(f"DIFFER: {nbad} px exceed tol={tol:g}; max |Δ|="
              f"{diff.max():.3e} at {idx} "
              f"(a={da[idx]:.6f}, b={db[idx]:.6f}); "
              f"mean |Δ|={diff.mean():.3e}")
        return 1
    print(f"IDENTICAL within tol={tol:g} "
          f"(max |Δ|={diff.max():.3e}, mean |Δ|={diff.mean():.3e})")
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    tol = float(argv[2]) if len(argv) > 2 else 0.0
    return compare(argv[0], argv[1], tol)


if __name__ == "__main__":
    sys.exit(main())
