"""solves_per_s: MPC solves completed in the window over the window's
seconds, by the host's clock. A solve is one problem instance solved."""

SOURCE = "host_clock"
UNIT = "solves/s"
MOVES = None


def read(run):
    if not run.solves or run.window_s <= 0:
        return None
    return len(run.solves) / run.window_s
