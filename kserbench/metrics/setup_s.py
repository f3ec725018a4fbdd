"""Seconds from the run's start to the window's: the DB made on the card,
the program's tables and family universe, the server, the request bodies
and the warm-up (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
