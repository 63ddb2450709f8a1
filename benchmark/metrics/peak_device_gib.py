"""The device memory at the window's peak, GiB: the largest
``torch.cuda.max_memory_allocated`` of a session (the program resets the
peak at each command's start)."""


def read(run):
    if not run.sessions:
        return None
    return max(s.peak_bytes for s in run.sessions) / 2 ** 30
