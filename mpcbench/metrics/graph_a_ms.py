"""graph_a_ms: the mean device time of one replay of graph A (`A`, or `AC`
on the merit path: the LQ approximation, the projection, K1 and the top
of the line search), over the window's solves that timed the device: CUDA
events around each replay, from the program's own trace
(`wb_humanoid_mpc_tpu_torch/utils/trace.py`). Layer: the compiled
solve."""

from mpcbench import program_trace

SOURCE = "program_span"
UNIT = "ms"
MOVES = "solves_per_s"
PIECES = ("A", "AC")


def read(run):
    records = program_trace.window_records(run)
    if records is None:
        return None
    times = [(iv.end_ns - iv.start_ns) * 1e-6 for r in records for iv in r.device
             if iv.name in PIECES]
    return sum(times) / len(times) if times else None
