"""Kernel K1's share of its bandwidth bound, percent, in the profiled
session: the bytes the session's stack must move, counted once (the
N·P float32 values read and the P-pixel mean written), at the H100's
3.35 TB/s, over the summed time of K1's kernel events
(``register_kernel`` and ``column_kernel``).  The card's power limit is
printed beside every run.  Nothing where no K1 kernel ran."""

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
K1_NAMES = ("register_kernel", "column_kernel")


def stack_bytes(n_frames: int, pixels: int) -> int:
    return 4 * n_frames * pixels + 4 * pixels


def read(run):
    t, s = run.trace, run.traced
    if t is None or s is None:
        return None
    k1 = sum(b - a for name, kind, a, b in t.kernels()
             if any(k in name for k in K1_NAMES))
    if k1 <= 0:
        return None
    need = stack_bytes(s.frames, s.pixels // s.frames) / HBM_BYTES_PER_S
    return 100.0 * need / k1
