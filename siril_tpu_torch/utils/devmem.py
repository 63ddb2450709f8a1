"""Device memory budget — counterpart of ``siril_tpu/utils/devmem.py:17-91``
and ``siril_tpu/pipeline.py:49`` (``_hbm_budget_bytes``).

The budget is the card's memory from ``torch.cuda.mem_get_info`` scaled
by the active preferences (``core/settings.get_settings``, which are the
session's: ``setmem``, ``set memory_ratio=…``), as
``siril_tpu/utils/devmem.py:64-80`` does: ``memory_ratio`` (0.9 by
default, settings.h:402-404; held to [0.05, 1]) of it, or
``memory_amount`` GiB when ``mem_mode`` is 1.  On the CPU the fused path
keeps the JAX package's fixed 6 GiB working-set budget and the resident
stack path its 4 GiB cap; ``memory_budget_bytes`` (the survey stack's
row planner) takes the host's available memory there.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

CPU_BUDGET_BYTES = 6 << 30


def scaled_budget(total: int) -> int:
    """``total`` bytes under the active preferences' memory settings."""
    from siril_tpu_torch.core.settings import get_settings

    prefs = get_settings()
    if getattr(prefs, "mem_mode", 0) == 1:
        return int(getattr(prefs, "memory_amount", 4.0) * (1 << 30))
    ratio = float(getattr(prefs, "memory_ratio", 0.9))
    return int(total * max(min(ratio, 1.0), 0.05))


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """Total memory of a CUDA device, or None for the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def fused_budget_bytes(device: torch.device) -> int:
    """Working-set budget of the fused pipeline on ``device``."""
    total = device_memory_bytes(device)
    if total is None:
        return CPU_BUDGET_BYTES
    return scaled_budget(total)


def resident_budget_bytes(device: torch.device) -> int:
    """Raw bytes the resident stack path may hold: a third of the memory
    budget, since decode and sort scratch peak near 3× the raw size
    (``resident_stack_budget``, siril_tpu/utils/devmem.py:91)."""
    total = device_memory_bytes(device)
    if total is None:
        return 4 << 30
    return scaled_budget(total) // 3


def host_available_bytes() -> int:
    """get_available_memory (OS_utils.c:671): MemAvailable, else half the
    physical memory."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) // 2
    except (ValueError, OSError):
        return 4 << 30


def memory_budget_bytes(device: torch.device) -> int:
    """The compute-memory budget of ``device`` (memory_budget_bytes,
    siril_tpu/utils/devmem.py:64): the card's memory, or the host's
    available memory on the CPU, under the ``setmem`` settings."""
    total = device_memory_bytes(device)
    if total is None:
        total = host_available_bytes()
    return scaled_budget(total)
