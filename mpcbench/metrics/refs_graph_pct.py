"""refs_graph_pct: the share of the window's solves whose record of the
program's own trace (`wb_humanoid_mpc_tpu_torch/utils/trace.py`) holds a
replay of the node params' graph (piece `params`, inside span `refs`):
how often the reference pipeline's device work ran as one CUDA graph.
Layer: the MPC runtime's reference pipeline."""

from mpcbench import program_trace

SOURCE = "program_counter"
UNIT = "%"
MOVES = "solves_per_s"


def read(run):
    records = program_trace.window_records(run, device=False)
    if records is None:
        return None
    return 100.0 * sum(r.replays.get("params", 0) > 0 for r in records) / len(records)
