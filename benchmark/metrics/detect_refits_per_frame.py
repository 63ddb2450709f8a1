"""Blended refits a frame: the program's counter ``detect.refits`` (the
stars that detection fits a second time on a smaller crop) over the
window's input frames; 0 where detection ran (``detect.candidates`` was
counted) and refitted nothing, nothing where it did not run or the
program keeps no span record."""

from benchmark.metrics import _record


def read(run):
    have = _record.entries(run.sessions)
    if not have or any("detect.candidates" not in e.get("counters", {})
                       for _, e in have):
        return None
    frames = sum(s.frames for s, _ in have)
    refits = sum(e["counters"].get("detect.refits", 0) for _, e in have)
    return refits / frames if frames else None
