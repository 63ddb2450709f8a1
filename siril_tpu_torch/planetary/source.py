"""Planetary frame source — counterpart of ``siril_tpu/planetary/source.py``
(``ser_device_store``:37, ``frame_chunks``:73).

Every MPP stage sweeps the whole video.  A mono 16-bit SER whose frames
fit in 0.35 of the device's memory budget (``utils/devmem``: 0.9 of the
card's memory, 6 GiB on the CPU, as the JAX package's budget there) is
uploaded once, as its raw 16-bit words, and each chunk is gathered and
decoded on the device: ``raw · float32(1 / maxval)``.  Otherwise each
frame is read on the host by ``SerFile.read_frame`` (``raw /
float32(maxval)``) and uploaded.  The two decodes differ by one ULP on
some values; each is kept where the JAX package uses it.  The tail chunk
is not padded (the JAX package pads it to one compiled shape; its frames
are the same).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device

#: the share of the memory budget the resident video may take
STORE_SHARE = 0.35


def ser_device_store(seq, layer: int = 0, device: DeviceLike = None
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(the video's raw words as int16 on ``device``, float32(1/maxval))
    for a mono 16-bit SER that fits, else None; cached on the sequence,
    so that every stage gathers its frames from one upload."""
    from siril_tpu_torch.core.sequence import SEQ_SER
    from siril_tpu_torch.utils.devmem import fused_budget_bytes

    if getattr(seq, "seq_type", None) != SEQ_SER:
        return None
    ser = getattr(seq, "_ser", None)
    if ser is None or ser.header.planes != 1 or ser._dtype.itemsize != 2:
        return None
    dev = resolve_device(device)
    cached = getattr(seq, "_planetary_store", None)
    if cached is not None and cached[0].device == dev:
        return cached
    need = int(ser.header.frame_count) * ser.height * ser.width * 2
    if need > STORE_SHARE * fused_budget_bytes(dev):
        return None
    raw = np.ascontiguousarray(np.asarray(ser._mm[:, :, :, 0]).astype("<u2"))
    store = torch.from_numpy(raw.view(np.int16)).to(dev)
    inv_max = torch.tensor(np.float32(1.0 / ((1 << ser.header.bit_depth) - 1)),
                           device=dev)
    seq._planetary_store = (store, inv_max)
    return seq._planetary_store


def decode_store(store: torch.Tensor, idx, inv_max: torch.Tensor
                 ) -> torch.Tensor:
    """Frames ``idx`` of the resident store as float32 on its device."""
    i = torch.as_tensor(np.asarray(idx, np.int64)).to(store.device)
    s = store.index_select(0, i).to(torch.int32) & 0xFFFF
    return s.float() * inv_max


def frame_chunks(seq, indices, layer: int, batch: int,
                 device: DeviceLike = None
                 ) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """Yield (chunk_indices, frames): ``frames`` float32 [B, H, W] on
    ``device``, gathered from the resident store where it applies, else
    read on the host and uploaded."""
    dev = resolve_device(device)
    store = ser_device_store(seq, layer, dev)
    for start in range(0, len(indices), batch):
        chunk = indices[start:start + batch]
        if store is not None:
            yield chunk, decode_store(store[0], chunk, store[1])
        else:
            host = np.stack([seq.read_frame(int(i)).host()[layer]
                             for i in chunk])
            yield chunk, torch.from_numpy(host).to(dev)
