"""k2_roofline_pct: the forward-kinematics + velocity tree pass's share of
its roofline, from the device trace, at the row counts the traced window's
launches carried (one row a block: the grid's x). Its bound is the least
time the card could take for the work `roofline.fkvel_work` counts over
the configuration's joints; the share is the bound of every launch over
their device time. Whole-body cells only (the centroidal flow map has no
such pass). The kernels that implement it are named below, as data."""

from mpcbench import roofline

SOURCE = "device_trace"
UNIT = "%"
MOVES = "solves_per_s"
KERNELS = ("fkvel_kernel",)


def read(run):
    if run.trace is None:
        return None
    c = run.config
    itemsize = 4 if c["dtype"] == "float32" else 8
    bound = spent = 0.0
    for name in KERNELS:
        for dur, grid in run.trace.kernels(name):
            rows = int(grid[0]) if grid else 1
            nbytes, ops = roofline.fkvel_work(rows, c["n_joints"], itemsize)
            bound += roofline.bound_s(nbytes, ops, itemsize)
            spent += dur
    return None if spent <= 0 else 100.0 * bound / spent
