"""Percent of detection's fitted candidates kept as stars: 100 × the
program's counter ``detect.stars`` over ``detect.candidates`` (finite
candidates fitted), summed over the window's sessions; nothing where no
candidate was counted."""

from benchmark.metrics import _record


def read(run):
    stars, _ = _record.counter_total(run, "detect.stars")
    cands, _ = _record.counter_total(run, "detect.candidates")
    if stars is None or not cands:
        return None
    return 100.0 * stars / cands
