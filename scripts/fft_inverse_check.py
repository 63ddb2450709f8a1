"""The Fourier shift of MPP (``planetary/mpp._shift_core``) on the card
against the CPU, by batch size, with its inverse taken two ways:
``torch.fft.irfft2`` of the phase-ramped spectrum, whose first and
Nyquist columns are not Hermitian, and ``mpp._irfft2``, which drops their
imaginary parts after the inverse over the rows, as pocketfft does.

    python3 scripts/fft_inverse_check.py [--size 256] [--batches 8,12,16,32]

Prints one JSON line: for each batch, the largest |card − CPU| of the
shifted frames each way.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from siril_tpu_torch.planetary import mpp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batches", default="8,12,16,32")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    n = max(int(b) for b in a.batches.split(","))
    frames = torch.from_numpy(rng.random((n, a.size, a.size),
                                         dtype=np.float32))
    shifts = torch.from_numpy(rng.uniform(-10, 10, (n, 2)).astype(
        np.float32))
    plain = mpp._irfft2
    out = {"card": torch.cuda.get_device_name(0), "size": a.size}
    for b in (int(v) for v in a.batches.split(",")):
        row = {}
        for name, inverse in (("irfft2", lambda X, H, W:
                               torch.fft.irfft2(X, s=(H, W))),
                              ("mpp._irfft2", plain)):
            mpp._irfft2 = inverse
            try:
                c = mpp._shift_core(frames[:b].cuda(), shifts[:b].cuda())
                h = mpp._shift_core(frames[:b], shifts[:b])
            finally:
                mpp._irfft2 = plain
            row[name] = float((c.cpu() - h).abs().max())
        out[str(b)] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
