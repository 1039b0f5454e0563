"""MPC observation logging + inspection (Python tooling layer).

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/tools/observation_logger.py`
(host numpy; matplotlib is imported only when a plot is made).

Port of the reference's `humanoid_common_mpc_pyutils`:
- `ObservationLogger` ~ `mpc_observation_logger.py:39-160` (row buffer + CSV)
- `plot_observation_log` ~ `mpc_observation_inspector` (matplotlib figures)

Instead of subscribing to a DDS topic, the logger is called in-process by the
MRT/sim loops (the framework's data plane is in-memory, SURVEY.md §2.5 item 4).
"""

from __future__ import annotations

import csv
import dataclasses

import numpy as np


@dataclasses.dataclass
class ObservationRecord:
    time: float
    state: np.ndarray
    input: np.ndarray
    mode: int = 3


class ObservationLogger:
    def __init__(self, state_labels: list[str] | None = None,
                 input_labels: list[str] | None = None):
        self.records: list[ObservationRecord] = []
        self.state_labels = state_labels
        self.input_labels = input_labels

    def log(self, time: float, state, input_=None, mode: int = 3) -> None:
        self.records.append(ObservationRecord(
            time=float(time),
            state=np.asarray(state, dtype=float).copy(),
            input=(np.zeros(0) if input_ is None
                   else np.asarray(input_, dtype=float).copy()),
            mode=int(mode),
        ))

    def __len__(self) -> int:
        return len(self.records)

    def to_arrays(self):
        t = np.array([r.time for r in self.records])
        x = np.stack([r.state for r in self.records]) if self.records else np.zeros((0, 0))
        u = np.stack([r.input for r in self.records]) if self.records else np.zeros((0, 0))
        m = np.array([r.mode for r in self.records])
        return t, x, u, m

    def dump_csv(self, path: str) -> None:
        """(reference `mpc_observation_logger.py:149-167`)"""
        t, x, u, m = self.to_arrays()
        nx = x.shape[1] if x.size else 0
        nu = u.shape[1] if u.size else 0
        s_labels = self.state_labels or [f"state_{i}" for i in range(nx)]
        u_labels = self.input_labels or [f"input_{i}" for i in range(nu)]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time", "mode"] + s_labels[:nx] + u_labels[:nu])
            for i in range(len(t)):
                w.writerow([t[i], m[i]] + list(x[i]) + list(u[i]))

    @staticmethod
    def load_csv(path: str):
        with open(path) as f:
            rows = list(csv.reader(f))
        header = rows[0]
        data = np.array([[float(v) for v in r] for r in rows[1:]])
        return header, data


def plot_observation_log(path_or_logger, state_indices=None, out_path=None):
    """Matplotlib inspector (reference `mpc_observation_inspector`). Saves a
    figure if `out_path` is given; otherwise returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(path_or_logger, str):
        header, data = ObservationLogger.load_csv(path_or_logger)
        t = data[:, 0]
        cols = data[:, 2:]
        labels = header[2:]
    else:
        t, x, u, _ = path_or_logger.to_arrays()
        cols = np.hstack([x, u]) if u.size else x
        labels = ([f"state_{i}" for i in range(x.shape[1])]
                  + [f"input_{i}" for i in range(u.shape[1] if u.size else 0)])

    idx = state_indices if state_indices is not None else range(min(12, cols.shape[1]))
    n = len(list(idx))
    fig, axes = plt.subplots(n, 1, figsize=(10, 2 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for ax, i in zip(axes, idx):
        ax.plot(t, cols[:, i])
        ax.set_ylabel(labels[i] if i < len(labels) else str(i))
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
    return fig
