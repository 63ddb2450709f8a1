"""Frame filters — counterpart of ``siril_tpu/core/filtering.py``
(``parse_filter_flag``:39, ``apply_filters``:59; sequence_filtering.c):
select frames by their registration data — FWHM, weighted FWHM,
roundness, quality, background, star count — each as an absolute
threshold, the best p % (``-filter-fwhm=90%``) or the best k frames
(``-filter-round=5k``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# criterion: (RegData attribute, lower is better)
_CRITERIA = {
    "fwhm": ("fwhm", True),
    "wfwhm": ("weighted_fwhm", True),
    "round": ("roundness", False),
    "roundness": ("roundness", False),
    "quality": ("quality", False),
    "bkg": ("background_lvl", True),
    "background": ("background_lvl", True),
    "nbstars": ("number_of_stars", False),
}


@dataclass
class FilterSpec:
    criterion: str               # key of _CRITERIA, or "incl"
    value: float = 0.0
    is_percent: bool = False     # keep the best value %
    is_count: bool = False       # keep the best value frames


def parse_filter_flag(key: str, value) -> Optional[FilterSpec]:
    """The spec of a ``-filter-<criterion>=<value>[%|k]`` flag (or
    ``-filter-incl``), None for an unknown criterion."""
    key = key.replace("filter-", "")
    if key in ("incl", "included"):
        return FilterSpec("incl")
    if key not in _CRITERIA:
        return None
    s = str(value)
    if s.endswith("%"):
        return FilterSpec(key, float(s[:-1]), is_percent=True)
    if s.endswith("k"):
        return FilterSpec(key, float(s[:-1]), is_count=True)
    return FilterSpec(key, float(s))


def filter_specs(flags: dict) -> List[FilterSpec]:
    """The specs of every known ``-filter-*`` flag of a command."""
    specs = (parse_filter_flag(k, v) for k, v in flags.items()
             if k.startswith("filter-"))
    return [s for s in specs if s is not None]


def apply_filters(seq, specs: List[FilterSpec],
                  layer: int = 0) -> np.ndarray:
    """The absolute indices of the included frames that pass every spec;
    a percentage or count keeps at least one frame."""
    mask = seq.incl.copy()
    reg = seq.reg(layer) if layer in seq.regparam else None
    for spec in specs:
        if spec.criterion == "incl" or reg is None:
            continue
        attr, lower_better = _CRITERIA[spec.criterion]
        vals = np.asarray(getattr(reg, attr), float)
        valid = reg.valid & mask
        if spec.is_percent or spec.is_count:
            n_valid = int(valid.sum())
            k = int(round(n_valid * spec.value / 100.0)) if spec.is_percent \
                else int(spec.value)
            k = max(min(k, n_valid), 1)
            order = vals.copy() if lower_better else -vals
            order[~valid] = np.inf
            keep = np.zeros_like(mask)
            keep[np.argsort(order, kind="stable")[:k]] = True
            mask &= keep
        elif lower_better:
            mask &= valid & (vals <= spec.value)
        else:
            mask &= valid & (vals >= spec.value)
    return np.nonzero(mask)[0]
