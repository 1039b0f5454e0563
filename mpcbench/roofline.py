"""The yardstick of the kernels' roofline shares: the card's published peaks
and the operations and bytes each operation needs, from its shapes.

Peaks: NVIDIA's data sheet for one H100 SXM (dense rates, at the full
700 W power limit): 67 TFLOP/s in float32 and 34 TFLOP/s in float64
outside the tensor cores, 3.35 TB/s of HBM bandwidth. A roofline share is
the least time the card could take (the larger of operations over the peak
rate and bytes over the peak bandwidth) over the measured device time.

The counts are frozen copies of the ones the port's kernel checks used
(`chip_smoke.py::riccati_work`, `fkvel_work`), so a share reads the same
work whatever implements the operation.
"""

from __future__ import annotations

PEAK_FLOPS = {4: 67e12, 8: 34e12}   # bytes per value -> FLOP/s
PEAK_BYTES = 3.35e12                # bytes/s


def bound_s(nbytes: float, ops: float, itemsize: int) -> float:
    """The least time the card could take for (bytes, operations)."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS[itemsize])


def riccati_work(batch: int, N: int, nx: int, nu: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of the LQ solve, backward Riccati recursion and
    forward rollout, of `batch` instances of N stages: every stage's A, B,
    d, Qxx, Quu, Qux, qx, qu and QN, qN, dx0 read once, K, k, dxs, dus
    written once; per stage P A, A'PA (2 nx^3 each), P B, B'PA (2 nx^2 nu
    each), B'PB (2 nx nu^2), the elimination (2 nu^2 (nu + nx + 1)),
    Qux_h'K (2 nx^2 nu), the vector products (4 nx^2 + 4 nx nu) and the
    rollout (2 nx^2 + 4 nx nu)."""
    w = nu + nx + 1
    stage = (4 * nx ** 3 + 6 * nx ** 2 * nu + 2 * nx * nu ** 2 + 2 * nu ** 2 * w
             + 6 * nx ** 2 + 8 * nx * nu)
    inputs = N * (2 * nx * nx + nx * nu + nu * nu + nu * nx + 2 * nx + nu) + nx * nx + 2 * nx
    outputs = N * (nu * nx + nu + nu) + (N + 1) * nx
    return batch * (inputs + outputs) * itemsize, batch * N * float(stage)


def fkvel_work(rows: int, n_j: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of the forward-kinematics + velocity/bias tree
    pass over `rows` configurations of a floating-base tree of n_j joints:
    q and v read once, the bodies' R, p, twist and bias, the joint axes and
    E written once; per joint 278 operations (Rodrigues matrix 81, two 3x3
    products 90, three 3x3 mat-vecs 45, four cross products 36, the
    twist/bias updates 24, sin and cos 2), 71 for the base."""
    nq, n_b = 6 + n_j, n_j + 1
    values = rows * (2 * nq + n_b * (9 + 3 + 12) + 3 * n_j + 9)
    return values * itemsize, rows * (278.0 * n_j + 71.0)
