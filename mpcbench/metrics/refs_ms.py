"""refs_ms: the mean host time of the reference pipeline a solve
(`SolveStats.reference_time`: `MotionManager.pre_solve` and the node
params), over the window's solves. Layer: the MPC runtime's reference
pipeline."""

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"


def read(run):
    if not run.solves:
        return None
    return 1e3 * sum(s.refs_s for s in run.solves) / len(run.solves)
