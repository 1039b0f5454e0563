"""idle_refs_ms: the mean device idle time a solve inside the reference
pipeline's span (`refs`: `MotionManager.pre_solve` and the node params),
over the window's solves that timed the device, from the program's own
trace (`wb_humanoid_mpc_tpu_torch/utils/trace.py`: CUDA events around each
graph replay and the eager copies, placed on the host's clock). The node
params' eager kernels count as idle. Layer: the MPC runtime's reference
pipeline."""

from mpcbench import program_trace

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"


def read(run):
    records = program_trace.window_records(run)
    if records is None:
        return None
    return 1e3 * sum(r.idle_within("refs") for r in records) / len(records)
