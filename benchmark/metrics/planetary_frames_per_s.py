"""SER frames taken to the written image, per second: all the window's
whole sessions' frames over all their time."""


def read(run):
    wall = run.total("wall_s")
    return run.total("frames") / wall if wall > 0 else None
