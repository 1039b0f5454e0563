"""ladder_b_pct: the share of the window's SQP iterations that replayed
graph B (the filter line search's lower ladder, run when some instance
accepted neither top step), from the replay counts of the program's own
trace (`wb_humanoid_mpc_tpu_torch/utils/trace.py`). Layer: the compiled
solve's filter ladder."""

from mpcbench import program_trace

SOURCE = "program_counter"
UNIT = "%"
MOVES = "solves_per_s"


def read(run):
    records = program_trace.window_records(run, device=False)
    if records is None:
        return None
    iterations = sum(r.iterations for r in records)
    if iterations == 0:
        return None
    return 100.0 * sum(r.replays.get("B", 0) for r in records) / iterations
