"""solve_ms_p95: the 95th percentile over every request of the window, from
the call to its return with the policy on the host, recovery solves
included, by the host's clock."""

from mpcbench.harness import percentile

SOURCE = "host_clock"
UNIT = "ms"
MOVES = None


def read(run):
    if not run.solves:
        return None
    return percentile([s.wall_s for s in run.solves], 95) * 1e3
