"""What a run measured, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.harness.trace import Trace


@dataclass
class Session:
    """One session: the cell's command run on the cell's files."""

    wall_s: float                  # host clock, the whole CLI call
    stages: Dict[str, float]       # the command's stage seconds
    frames: int                    # input frames the command took
    pixels: int                    # input pixels (frames × H × W)
    peak_bytes: int = 0            # device memory at the session's peak
    launches: Dict[str, int] = field(default_factory=dict)   # K1 variants
    host: list = field(default_factory=list)   # harness/host.py's COLUMNS


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    sessions: List[Session]        # the measured window, whole sessions
    trace: Optional[Trace] = None  # one more session, profiled
    traced: Optional[Session] = None

    def mean_wall(self) -> Optional[float]:
        """The window's mean session wall, seconds."""
        return self.total("wall_s") / len(self.sessions) \
            if self.sessions else None

    def total(self, key: str) -> float:
        return float(sum(getattr(s, key) for s in self.sessions))

    def stage_total(self, name: str) -> Optional[float]:
        """Seconds of stage ``name`` over the window; None where no
        session has it."""
        have = [s.stages[name] for s in self.sessions if name in s.stages]
        return float(sum(have)) if have else None

    def stage_ms_per_frame(self, name: str) -> Optional[float]:
        t = self.stage_total(name)
        return None if t is None else 1e3 * t / self.total("frames")
