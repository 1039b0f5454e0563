"""recovery_pct: the share of the window's solves that ran the recovery
solve (`SolveStats.recovery`, 12 SQP iterations). Layer: the MPC runtime's
two-level recovery."""

SOURCE = "program_counter"
UNIT = "%"
MOVES = "solve_ms_p95"


def read(run):
    if not run.solves:
        return None
    return 100.0 * sum(bool(s.recovery) for s in run.solves) / len(run.solves)
