"""setup_s: process start to the window's first request (imports, the
kernel library's load, the problem build, the warm-up solves that capture
the graphs), by the host's clock."""

SOURCE = "host_clock"
UNIT = "s"
MOVES = None


def read(run):
    return run.setup_s
