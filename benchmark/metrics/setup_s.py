"""setup_s: seconds from the process's start to the window's first
instant (imports, kernel library and native runtime loads, the voice,
the warm-up)."""


def read(run):
    return run.setup_s
