"""PyTorch port, the native MRT core (`wb_humanoid_mpc_tpu_torch/native`):
the C functions of `csrc/mrt_core.cpp` against their numpy twins and against
the JAX package's own build of its `native/mrt_core.cpp` on the same seeded
inputs (1e-12), the seqlock buffer under a concurrent writer, and a build
that fails raising instead of falling back."""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest

from wb_humanoid_mpc_tpu import native as jax_native
from wb_humanoid_mpc_tpu_torch import native

TOL = dict(rtol=0.0, atol=1e-12)
TIMES = [0.0, 0.013, 0.05, 0.099, 0.2, -0.1]   # tests/test_native.py's


def _policy(rng, N=10, nx=7, nu=5):
    return rng.standard_normal((N + 1, nx)), rng.standard_normal((N, nu))


@pytest.mark.parametrize("t", TIMES)
def test_evaluate_policy(t):
    xs, us = _policy(np.random.default_rng(0))
    got = native.evaluate_policy(xs, us, 0.0, 0.01, t)
    for ref in (native.evaluate_policy(xs, us, 0.0, 0.01, t, backend="plain"),
                jax_native.evaluate_policy(xs, us, 0.0, 0.01, t)):
        np.testing.assert_allclose(got[0], ref[0], **TOL)
        np.testing.assert_allclose(got[1], ref[1], **TOL)


def test_joint_torques():
    args = [np.random.default_rng(1).standard_normal(23) for _ in range(7)]
    got = native.joint_torques(*args)
    np.testing.assert_allclose(got, native.joint_torques(*args, backend="plain"), **TOL)
    np.testing.assert_allclose(got, jax_native.joint_torques(*args), **TOL)


def _jax_control_tick(xs, us, t0, dt, t, q_off, qd_src, qd_off, idx, ff, kp, kd, kp_f, kd_f,
                      q_full, qd_full):
    """The JAX package's `mrt_control_tick` (built by its own module, which
    binds it but wraps it in no Python function)."""
    import ctypes

    lib = jax_native._load()
    assert lib is not None, "the JAX package's MRT core did not build"
    xs, us, q_full, qd_full = (np.ascontiguousarray(a, dtype=np.float64)
                               for a in (xs, us, q_full, qd_full))
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    ff_p = None if ff is None else jax_native._dp(np.ascontiguousarray(ff, dtype=np.float64))
    tau = np.empty(q_full.shape[0])
    lib.mrt_control_tick(jax_native._dp(xs), jax_native._dp(us), us.shape[0], xs.shape[1],
                         us.shape[1], t0, dt, t, q_off, qd_src, qd_off,
                         idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), idx.shape[0], ff_p,
                         kp, kd, kp_f, kd_f, jax_native._dp(q_full), jax_native._dp(qd_full),
                         q_full.shape[0], jax_native._dp(tau))
    return tau


@pytest.mark.parametrize("qd_src", [0, 1], ids=["qd_from_state", "qd_from_input"])
@pytest.mark.parametrize("with_ff", [True, False], ids=["ff", "no_ff"])
def test_control_tick(qd_src, with_ff):
    """WB layout (q from state row 6, qd from the state's velocity rows) and
    centroidal layout (qd from the input's joint rows), 5 of 8 joints driven
    by the MPC, the rest held by the soft gains."""
    rng = np.random.default_rng(2 + qd_src)
    n_mpc, n_full = 5, 8
    xs, us = _policy(rng, N=6, nx=6 + 2 * n_mpc + 6, nu=12 + n_mpc)
    q_off, qd_off = (6, 12 + n_mpc) if qd_src == 0 else (6, 12)
    idx = np.array([0, 2, 3, 5, 7])
    ff = rng.standard_normal(n_mpc) if with_ff else None
    q_full, qd_full = rng.standard_normal(n_full), rng.standard_normal(n_full)
    for t in (0.0, 0.031, 0.07, 0.5):
        args = (xs, us, 0.01, 0.02, t, q_off, qd_src, qd_off, idx, ff, 1200.0, 10.0, 100.0,
                1.0, q_full, qd_full)
        got = native.control_tick(*args)
        np.testing.assert_allclose(got, native.control_tick(*args, backend="plain"), **TOL)
        np.testing.assert_allclose(got, _jax_control_tick(*args), **TOL)


def test_threadsafe_buffer_concurrent():
    """tests/test_native.py's torn-read test on the port's buffer: one writer
    filling the buffer with one value per write, more readers than cores
    (the C calls run without the interpreter lock), none of which may see
    two values in one snapshot; a short switch interval interleaves the
    threads' Python code too."""
    buf = native.ThreadSafeBuffer(64)
    stop = threading.Event()
    errors, reads = [], []
    n_readers = (os.cpu_count() or 2) + 1
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def writer():
        i = 0
        while not stop.is_set():
            buf.write(np.full(64, float(i)))
            i += 1

    def reader():
        for _ in range(500):
            v = buf.read()
            reads.append(v[0])
            if not np.all(v == v[0]):
                errors.append(v.copy())

    wt = threading.Thread(target=writer)
    rts = [threading.Thread(target=reader) for _ in range(n_readers)]
    wt.start()
    try:
        for r in rts:
            r.start()
        for r in rts:
            r.join(timeout=60)
    finally:
        stop.set()
        wt.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not wt.is_alive() and not any(r.is_alive() for r in rts)
    assert not errors, f"torn reads detected: {errors[:1]}"
    assert len(reads) == 500 * n_readers


def test_wrong_shapes_raise():
    """Sizes are checked before any pointer reaches the C code."""
    xs, us = _policy(np.random.default_rng(0), N=4, nx=6, nu=3)
    with pytest.raises(ValueError, match="policy arrays"):
        native.evaluate_policy(xs[:-1], us, 0.0, 0.01, 0.0)
    with pytest.raises(ValueError, match="one length"):
        native.joint_torques(*[np.zeros(3)] * 6, np.zeros(4))
    q = np.zeros(5)
    ok = (xs, us, 0.0, 0.01, 0.0, 0, 0, 3, np.array([0, 4]), None, 1.0, 1.0, 1.0, 1.0, q, q)
    native.control_tick(*ok)
    for i, bad in ((8, np.array([0, 5])), (5, 5), (7, 5), (6, 2), (9, np.zeros(3))):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError, match="control_tick"):
            native.control_tick(*args)


def test_buffer_refuses_a_wrong_size():
    buf = native.ThreadSafeBuffer(4)
    with pytest.raises(ValueError, match="4 values"):
        buf.write(np.zeros(3))


def test_unknown_backend_raises():
    xs, us = _policy(np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown"):
        native.evaluate_policy(xs, us, 0.0, 0.01, 0.0, backend="numpy")


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output; no
    numpy fallback is taken and nothing is left loaded."""
    bad = tmp_path / "mrt_core.cpp"
    bad.write_text("extern \"C\" void mrt_evaluate_policy( { }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_state", {})
    with pytest.raises(RuntimeError, match="MRT core build failed"):
        native.evaluate_policy(*_policy(np.random.default_rng(0)), 0.0, 0.01, 0.0)
    with pytest.raises(RuntimeError, match="MRT core build failed"):
        native.ThreadSafeBuffer(8)
    assert not native.available()
    assert native._state == {}
