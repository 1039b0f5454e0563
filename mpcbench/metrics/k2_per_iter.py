"""k2_per_iter: the forward-kinematics + velocity tree pass's launches (K2,
`ops/fkvel.py`) over the SQP iterations of the window's solves, from the
launch counts of the program's own trace
(`wb_humanoid_mpc_tpu_torch/utils/trace.py`: `Record.launches`, what each
call's replays and eager launches ran). Whole-body cells only (the
centroidal flow map has no such pass). A program whose records carry no
launch counts reads nothing. Layer: the kernels."""

from mpcbench import program_trace

SOURCE = "program_counter"
UNIT = "launches"
MOVES = "solves_per_s"
WRAPPER = "fkvel"    # K2's wrapper module, as the records name it


def read(run):
    records = program_trace.window_records(run, device=False)
    if records is None or any(getattr(r, "launches", None) is None for r in records):
        return None
    iterations = sum(r.iterations for r in records)
    if iterations == 0:
        return None
    return sum(r.launches.get(WRAPPER, 0) for r in records) / iterations
