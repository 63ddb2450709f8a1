"""Set-up seconds: from the process's start through the inputs made and
written and one warm-up session (host clock)."""


def read(run):
    return run.setup_s
