"""sqp_iter_ms: the host time of one SQP iteration of the compiled solve,
sum of `SolveStats.solve_time` over sum of `SolveStats.iterations` in the
window. Layer: the compiled solve."""

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"


def read(run):
    iterations = sum(s.iterations for s in run.solves)
    if iterations == 0:
        return None
    return 1e3 * sum(s.solve_s for s in run.solves) / iterations
