"""k1_roofline_pct: the LQ solve's share of its roofline, from the device
trace. The operation is the Riccati solve and rollout of one SQP iteration
at the configuration's (N, nx, nu - n_eq): the projection path solves the
reduced LQ. Its bound is the least time the card could take for the work
`roofline.riccati_work` counts; the share is the bound of every launch in
the traced window over their device time. The kernels that implement the
operation are named below, as data; a window with none of them reads
nothing."""

from mpcbench import roofline

SOURCE = "device_trace"
UNIT = "%"
MOVES = "solves_per_s"
KERNELS = ("riccati_rollout_kernel",)


def read(run):
    if run.trace is None:
        return None
    c = run.config
    itemsize = 4 if c["dtype"] == "float32" else 8
    bound = spent = 0.0
    for name in KERNELS:
        for dur, grid in run.trace.kernels(name):
            batch = int(grid[0]) if grid else 1
            nbytes, ops = roofline.riccati_work(batch, c["n_nodes"], c["nx"],
                                                c["nu"] - c["n_eq"], itemsize)
            bound += roofline.bound_s(nbytes, ops, itemsize)
            spent += dur
    return None if spent <= 0 else 100.0 * bound / spent
