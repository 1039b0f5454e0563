"""The records of the program's own trace
(`wb_humanoid_mpc_tpu_torch/utils/trace.py`: one record a call of
`MpcRuntime.advance`) that belong to a run's window, for the metrics that
read them.

A run calls `advance` once a solve: the window's solves, then in a traced
run `traced_solves` more. So the window's records are the first
`len(run.solves)` of the ring's last `len(run.solves) + run.traced_solves`,
and each must match its solve: the same SQP iterations and recovery flag,
and an `advance` span no longer than the solve's wall time and within
`MATCH_S` of it. The recorder times the device on a sample of its
records (`trace.DEVICE_EVERY`); the device's metrics are means over the
window's records that carry device intervals. A program without the
recorder, or with it off, keeps no such records: the metrics are then
left out."""

from __future__ import annotations

MATCH_S = 2e-3


def window_records(run, device: bool = True) -> list | None:
    """The trace records of the window's solves, in order, or None where
    the ring does not hold them one for one; with `device`, only those
    that carry device intervals, and None where none does (a run off a
    CUDA device)."""
    try:
        from wb_humanoid_mpc_tpu_torch.utils import trace
    except ImportError:
        return None
    n = len(run.solves)
    ring = trace.records()
    k = n + int(getattr(run, "traced_solves", 0) or 0)
    if n == 0 or len(ring) < k:
        return None
    window = ring[len(ring) - k:][:n]
    for rec, s in zip(window, run.solves):
        if rec.iterations != s.iterations or rec.recovery != bool(s.recovery):
            return None
        if not s.wall_s - MATCH_S <= rec.advance.seconds <= s.wall_s:
            return None
    if device:
        window = [rec for rec in window if rec.device is not None]
    return window or None
