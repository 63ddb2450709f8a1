"""Seconds a session spends outside the command's stages: the session
object, the sequence load, the masters' reads and the result's write
(the session's wall less the sum of its stage seconds), the mean over
the window's sessions."""


def read(run):
    if not run.sessions:
        return None
    rest = [s.wall_s - sum(s.stages.values()) for s in run.sessions]
    return sum(rest) / len(rest)
