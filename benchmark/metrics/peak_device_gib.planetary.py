"""The device memory at the window's peak in a planetary cell, GiB: the
largest ``torch.cuda.max_memory_allocated`` of a session (the program
resets the peak at each command's start).  Apart from the deep-sky
cells' peak because the alignment-point grid, and so the memory, moves
with the seed's frames."""


def read(run):
    if not run.sessions:
        return None
    return max(s.peak_bytes for s in run.sessions) / 2 ** 30
