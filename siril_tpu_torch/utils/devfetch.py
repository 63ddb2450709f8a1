"""Device-result collection for chunked sweeps — counterpart of
``siril_tpu/utils/devfetch.py`` (``DeviceCollector``:23).

A sweep in chunks that fetches each chunk's small result to the host
waits for the device once a chunk.  ``DeviceCollector`` keeps the
per-chunk tensors on their device and fetches them once, concatenated
(``torch.cat(...).cpu()``), at the end of the sweep.

The JAX collector also drains its queue every few chunks, because a
queued XLA program pins its input buffers; PyTorch's caching allocator
frees a chunk's inputs when the sweep drops them and reuses the memory
in stream order, so nothing is pinned and no drain is needed.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceCollector:
    """Collect per-chunk device tensors; ``concat()`` fetches once."""

    def __init__(self):
        self.parts = []

    def append(self, t: torch.Tensor) -> None:
        self.parts.append(t)

    def concat(self, dim: int = 0) -> np.ndarray:
        if not self.parts:
            return np.zeros((0,), np.float32)
        if len(self.parts) == 1:
            return self.parts[0].cpu().numpy()
        return torch.cat(self.parts, dim).cpu().numpy()
