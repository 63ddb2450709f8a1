"""How far the -disto route leaves stars from their undistorted places, by
the size of the distortion, on one CUDA card.

    python3 scripts/disto_residual.py [--scales S[,S...]] [--seeds N[,N...]]

For each seed, a field of 4000 stars (chip_smoke.py's ``_star_field`` at
its SIZE, 4096²) on chip_smoke.py's sky WCS, written as a KStars
catalogue; for each scale, chip_smoke.py's ``disto_lights`` renders
DISTO_LIGHTS lights through DISTO_SIP × the scale, and ``disto_correct``
runs the port's ``platesolve -order=3`` of the first (the master),
``register -noout`` and ``seqapplyreg -disto=master`` and centroids the
stars.  Prints the card's name and power limit first, then a JSON line
per (seed, scale): the stars' largest displacement in the field before
correction, the master's distortion, and the largest and mean distance of
the DISTO_STARS brightest isolated stars from their undistorted places
after it, over all the frames.  chip_smoke.py's DISTO_TOL is set from
these readings.  Needs CUDA (the port's star finder and warps run on the
card).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    from siril_tpu_torch.astrometry.kstars_local import (
        write_kstars_catalogue,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", default="0.4,1,1.2")
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    sky = cs.sky_wcs(cs.SIZE)
    for seed in (int(v) for v in args.seeds.split(",")):
        rng = np.random.default_rng(seed)
        sx, sy, amp = cs._star_field(rng, cs.SIZE, 4000)
        ra, dec = sky.pix2world(sx, sy)
        for scale in (float(v) for v in args.scales.split(",")):
            root = tempfile.mkdtemp(prefix="disto_residual_")
            try:
                write_kstars_catalogue(os.path.join(root, "field.dat"), ra,
                                       dec, cs.star_mags(amp))
                dist = os.path.join(root, "disto")
                os.makedirs(dist)
                observed = cs.disto_lights(dist, sky, ra, dec, amp, rng,
                                           scale)
                ux, uy = sky.world2pix(ra, dec)
                ox, oy = observed[0]
                inside = (ox >= 0) & (ox < cs.SIZE) & (oy >= 0) & \
                    (oy < cs.SIZE)
                dc = cs.disto_correct({}, dist, "../field.dat", ra, dec,
                                      amp, observed)
                after = np.concatenate(dc["after"])
                print(json.dumps(dict(
                    seed=seed, scale=scale,
                    displacement_max_px=float(np.hypot(
                        ox - ux, oy - uy)[inside].max()),
                    master_distortion_max_px=float(dc["dmax"]),
                    before_max_px=float(dc["before"].max()),
                    after_max_px=float(after.max()),
                    after_mean_px=float(after.mean()))), flush=True)
            finally:
                shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
