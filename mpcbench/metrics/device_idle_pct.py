"""device_idle_pct: the share of the traced run's window in which the card
ran none of the program's CUDA graphs: one minus the device time of every
graph replay (CUDA events recorded around each `CUDAGraph.replay`, on its
stream) over the window's length. Kernels launched outside a graph (the
node params' upload, the host copies) count as idle. The profiler's trace
is not used here: its kernel tracing delays each graph launch (PERF.md)."""

SOURCE = "device_trace"
UNIT = "%"
MOVES = "solves_per_s"


def read(run):
    if run.replay_busy_s is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.replay_busy_s / run.window_s)
