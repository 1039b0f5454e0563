"""Native MRT runtime core: `csrc/mrt_core.cpp` bound with `ctypes`.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/native/__init__.py`: policy
interpolation, the PD + feed-forward torque law, the fused 500 Hz control
tick and the seqlock latest-value buffer, in host C++.

The library is built on first use with `g++ -O3 -shared -fPIC -std=c++17`
into `wb_humanoid_mpc_tpu_torch/_build/` (listed in `.gitignore`), under a
name that hashes the source and the flags, so an edited source rebuilds. A
build that fails raises: there is no fallback. The numpy functions below
are the plain twins of the C functions, run only when a caller asks for
`backend="plain"` (the tests hold the native functions against them).
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mrt_core.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_state: dict = {}

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_I, _D = ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "mrt_evaluate_policy": ([_DP, _DP, _I, _I, _I, _D, _D, _D, _DP, _DP], None),
    "mrt_joint_torques": ([_DP] * 7 + [_I, _DP], None),
    "tsbuf_create": ([_I], ctypes.c_void_p),
    "tsbuf_destroy": ([ctypes.c_void_p], None),
    "tsbuf_write": ([ctypes.c_void_p, _DP, _I], None),
    "tsbuf_read": ([ctypes.c_void_p, _DP, _I], ctypes.c_uint64),
    "mrt_control_tick": ([_DP, _DP, _I, _I, _I, _D, _D, _D, _I, _I, _I, _IP, _I, _DP,
                          _D, _D, _D, _D, _DP, _DP, _I, _DP], None),
}


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"MRT core build failed:\n$ {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, so)   # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The MRT core library, built from `csrc/mrt_core.cpp` on first use."""
    with _lock:
        lib = _state.get("lib")
        if lib is not None:
            return lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        so = BUILD_DIR / f"libmrt_core_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the library is built and loaded (builds it if it is not)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _check_backend(backend: str) -> None:
    if backend not in ("native", "plain"):
        raise ValueError(f"unknown MRT core backend {backend!r}")


def _check_policy(xs: np.ndarray, us: np.ndarray) -> None:
    """The C functions read xs [N+1, nx] and us [N, nu], N >= 1."""
    if xs.ndim != 2 or us.ndim != 2 or us.shape[0] < 1 or xs.shape[0] != us.shape[0] + 1:
        raise ValueError(f"policy arrays xs {xs.shape} and us {us.shape}: expected "
                         f"[N+1, nx] and [N, nu] with N >= 1")


def _evaluate_plain(xs, us, t0, dt, t):
    N = us.shape[0]
    s = min(max((t - t0) / dt, 0.0), float(N))
    k = min(int(s), N - 1)
    a = min(max(s - k, 0.0), 1.0)
    return (1.0 - a) * xs[k] + a * xs[k + 1], us[k].copy()


def evaluate_policy(xs, us, t0: float, dt: float, t: float, backend: str = "native"):
    """(x, u) at time t: xs [N+1, nx] interpolated linearly, us [N, nu] held
    (zero-order hold); s = (t - t0) / dt clamped to [0, N]."""
    _check_backend(backend)
    xs, us = _f64(xs), _f64(us)
    _check_policy(xs, us)
    if backend == "plain":
        return _evaluate_plain(xs, us, t0, dt, t)
    N, nx, nu = us.shape[0], xs.shape[1], us.shape[1]
    x_out, u_out = np.empty(nx), np.empty(nu)
    library().mrt_evaluate_policy(_dp(xs), _dp(us), N, nx, nu, t0, dt, t, _dp(x_out),
                                  _dp(u_out))
    return x_out, u_out


def joint_torques(q_des, qd_des, kp, kd, ff, q, qd, backend: str = "native"):
    """kp (q_des - q) + kd (qd_des - qd) + ff (reference `getTotalFeedbackTorque`)."""
    _check_backend(backend)
    arrs = [_f64(a) for a in (q_des, qd_des, kp, kd, ff, q, qd)]
    if any(a.shape != (len(arrs[0]),) for a in arrs):
        raise ValueError(f"joint_torques takes 7 vectors of one length, got shapes "
                         f"{[a.shape for a in arrs]}")
    if backend == "plain":
        q_des, qd_des, kp, kd, ff, q, qd = arrs
        return kp * (q_des - q) + kd * (qd_des - qd) + ff
    out = np.empty(len(arrs[0]))
    library().mrt_joint_torques(*[_dp(a) for a in arrs], len(arrs[0]), _dp(out))
    return out


def control_tick(xs, us, t0: float, dt: float, t: float, q_off: int, qd_src: int,
                 qd_off: int, mpc_joint_idx, ff, kp: float, kd: float, kp_fixed: float,
                 kd_fixed: float, q_full, qd_full, backend: str = "native"):
    """One fused control tick: the policy at t, its joint angles (state rows
    from `q_off`) and joint velocity references (rows from `qd_off` of the
    state, qd_src 0, or of the input, qd_src 1) mapped onto the full joint
    vector at `mpc_joint_idx`, PD + ff torques there (ff may be None) and
    soft gains holding zero on the other joints. Returns tau [n_full]."""
    _check_backend(backend)
    xs, us = _f64(xs), _f64(us)
    q_full, qd_full = _f64(q_full), _f64(qd_full)
    idx = np.ascontiguousarray(mpc_joint_idx, dtype=np.int32)
    ff = None if ff is None else _f64(ff)
    n_full, n_mpc = q_full.shape[0], idx.shape[0]
    _check_policy(xs, us)
    qd_rows = xs.shape[1] if qd_src == 0 else us.shape[1]
    if (qd_src not in (0, 1) or qd_full.shape != (n_full,) or idx.ndim != 1
            or (n_mpc and not 0 <= idx.min() <= idx.max() < n_full)
            or not 0 <= q_off <= xs.shape[1] - n_mpc or not 0 <= qd_off <= qd_rows - n_mpc
            or (ff is not None and ff.shape != (n_mpc,))):
        raise ValueError("control_tick: joint indices, row offsets or vector sizes do not fit "
                         f"the policy (nx {xs.shape[1]}, nu {us.shape[1]}) and {n_full} joints")
    if backend == "plain":
        x, u = _evaluate_plain(xs, us, t0, dt, t)
        tau = kp_fixed * (0.0 - q_full) + kd_fixed * (0.0 - qd_full)
        qd_base = x if qd_src == 0 else u
        for i, j in enumerate(idx):
            tau[j] = (kp * (x[q_off + i] - q_full[j]) + kd * (qd_base[qd_off + i] - qd_full[j])
                      + (0.0 if ff is None else ff[i]))
        return tau
    tau = np.empty(n_full)
    library().mrt_control_tick(
        _dp(xs), _dp(us), us.shape[0], xs.shape[1], us.shape[1], t0, dt, t, q_off, qd_src,
        qd_off, idx.ctypes.data_as(_IP), idx.shape[0], None if ff is None else _dp(ff),
        kp, kd, kp_fixed, kd_fixed, _dp(q_full), _dp(qd_full), n_full, _dp(tau))
    return tau


class ThreadSafeBuffer:
    """Seqlock latest-value exchange of n doubles (reference `ThreadSafe<T>` /
    `RobotHWInterfaceBase` double buffering): one writer that never blocks,
    readers that retry while a write is in progress."""

    def __init__(self, n: int):
        self.n = n
        self._lib = library()
        self._h = self._lib.tsbuf_create(n)

    def write(self, data) -> None:
        data = _f64(data)
        if data.shape != (self.n,):
            raise ValueError(f"ThreadSafeBuffer of {self.n} values got shape {data.shape}")
        self._lib.tsbuf_write(self._h, _dp(data), self.n)

    def read(self) -> np.ndarray:
        out = np.empty(self.n)
        self._lib.tsbuf_read(self._h, _dp(out), self.n)
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.tsbuf_destroy(h)
            self._h = None
