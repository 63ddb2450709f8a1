"""Megapixels of input frames taken from files to the written stack, per
second: all the window's whole sessions' pixels over all their time."""


def read(run):
    wall = run.total("wall_s")
    return run.total("pixels") / 1e6 / wall if wall > 0 else None
