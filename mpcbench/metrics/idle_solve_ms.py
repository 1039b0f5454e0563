"""idle_solve_ms: the mean device idle time a solve inside the compiled
solve's span (`solve`, its children included: the graph launches, `load`,
`ladder_read`, `stats_read`), over the window's solves that timed the
device, from the program's own trace
(`wb_humanoid_mpc_tpu_torch/utils/trace.py`). Layer: the compiled
solve."""

from mpcbench import program_trace

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"


def read(run):
    records = program_trace.window_records(run)
    if records is None:
        return None
    return 1e3 * sum(r.idle_within("solve") for r in records) / len(records)
