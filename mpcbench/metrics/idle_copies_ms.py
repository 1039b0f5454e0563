"""idle_copies_ms: the mean device idle time a solve inside the runtime's
spans around the solve (`warm_start`: the recovery decision, the shift and
the uploads; `readback`: xs, us to numpy; `policy`), over the window's
solves that timed the device, from the program's own trace
(`wb_humanoid_mpc_tpu_torch/utils/trace.py`). Layer: the MPC runtime's
warm start and copies."""

from mpcbench import program_trace

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"
SPANS = ("warm_start", "readback", "policy")


def read(run):
    records = program_trace.window_records(run)
    if records is None:
        return None
    return 1e3 * sum(r.idle_within(s) for r in records for s in SPANS) / len(records)
