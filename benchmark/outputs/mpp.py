"""What the check reads from a finished ``mpp`` session."""

from __future__ import annotations

import os


def read(ctx, workdir: str, traffic: dict) -> dict:
    """The stacked image's path and the ``.mpp`` sidecar's path."""
    return {"image": os.path.join(workdir, traffic["output"]),
            "sidecar": os.path.join(workdir, traffic["sidecar"])}
