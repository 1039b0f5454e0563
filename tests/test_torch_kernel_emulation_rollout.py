"""PyTorch port, K3's CUDA source on the CPU: `csrc/rollout.cu` compiled by the
host C++ compiler against the host-thread shim of
tests/test_torch_kernel_emulation.py, then held against the plain version
and the Pallas kernel in interpret mode.

The kernel's card-only primitives sit in one marked block of the source;
this test replaces that block by name with host versions over the shim's
cluster part: the CTAs of one cluster run at once as host threads (a
`std::thread` per CUDA thread), the DSMEM mapping is a pointer into the peer
CTA's shared buffer, the mbarrier a counter of arrivals and of bytes to come
with a condition variable, the cluster barrier a `std::barrier` over all the
cluster's threads. A bulk copy (which must be 16-byte aligned, as on the
card) or a `cp.async` is queued on the mbarrier it completes on and lands
only when a thread waits on that mbarrier, so a stage read before its wait
reads NaN: shared memory starts as NaN bytes. A wait on the hand-off
mbarrier that never completes fails the launch after a minute instead of
hanging. Clusters run one after another.

Cases: (7, 12, 5) with C = 2, 4 and 7 (one stage a rank), and at the
kernel's own plan (C = 1: 8 KB of stage data); (15, 35, 35) with its own
plan and with C = 2 through a ring of 2 slots; (28, 58, 35) in f32 (C = 8,
four slots) and f64 (C = 8, a ring of 3 slots: four stages do not fit in
227 KB); (28, 58, 21) at its plan; a batch of 2 instances; inputs 1 and 3
values off 16-byte alignment; two launches giving the same bits (the
emulated CTAs' timing varies from run to run, which stages a rank folds
must not); ranks without stages refused. Forced geometries go through the
`_ex` entry points, which the tests alone use. The test says nothing about
speed or about what `nvcc` accepts: the card tier (tests/test_torch_cuda.py)
covers that.

Tolerances as tests/test_torch_rollout.py: f32 atol 1e-5 x max(1, max|dxs|),
f64 rtol = atol = 1e-12."""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import DTYPES, assert_close, jax_mode, to_numpy
from tests.test_torch_kernel_emulation import build_host_library
from wb_humanoid_mpc_tpu.ops.rollout import pallas_forward_rollout
from wb_humanoid_mpc_tpu_torch.ops import _lib, rollout

FIELDS = ("A", "B", "d", "K", "k", "dx0")
BLOCK = re.compile(r"// ---- card-only primitives .*?// ---- end of card-only primitives ----",
                   re.S)

HOST_PRIMITIVES = r"""
inline thread_local std::vector<EmuCopy> emu_open;   // this thread's cp.async since its last arrive
inline unsigned cluster_rank() { return emu_rank; }
template <typename T> T* peer_shared(T* p, unsigned rank) {
  return static_cast<T*>(emu_peer(p, rank));
}
inline void mbar_init(unsigned long long* bar, unsigned count) { emu_mbar_init(bar, count); }
inline void mbar_init_fence() {}
inline void mbar_arrive_peer(unsigned long long* bar, unsigned rank) {
  emu_mbar_arrive(emu_peer(bar, rank));
}
inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  emu_mbar_expect_tx(bar, bytes);
}
inline void mbar_wait(unsigned long long* bar, unsigned phase) { emu_mbar_wait(bar, phase); }
inline void mbar_wait_cluster(unsigned long long* bar, unsigned phase) {
  emu_mbar_wait(bar, phase);
}
inline void cluster_arrive() { emu_cluster_arrive(); }
inline void cluster_wait() { emu_cluster_wait(); }
inline void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | bytes) & 15)
    std::abort();   // the card refuses a bulk copy off 16 bytes
  emu_mbar_copy(bar, {dst, src, bytes}, true);
}
template <typename T> void cp_async(T* dst, const T* src) {
  emu_open.push_back({dst, src, sizeof(T)});
}
inline void cp_async_arrive(unsigned long long* bar) {
  for (const EmuCopy& c : emu_open) emu_mbar_copy(bar, c, false);
  emu_open.clear();
  emu_mbar_arrive(bar);
}
inline void fence_proxy_async() {}
template <typename T> cudaError_t prepare_kernel(size_t) { return cudaSuccess; }
template <typename T> cudaError_t max_active_clusters(int, size_t, int* out) {
  *out = 1;
  return cudaSuccess;
}
template <typename T>
cudaError_t launch_clusters(int n_clusters, int n_ranks, size_t smem, cudaStream_t, const T* A,
                            const T* B, const T* d, const T* K, const T* k, const T* dx0, T* dxs,
                            T* dus, int N, int nx, int nu, int n_slots) {
  return emu_launch_clusters(forward_rollout_kernel<T>, n_clusters, n_ranks, kThreads, smem, A,
                             B, d, K, k, dx0, dxs, dus, N, nx, nu, n_ranks, n_slots);
}
"""

ENTRY_POINTS = ("wbmpc_forward_rollout_f32", "wbmpc_forward_rollout_f64",
                "wbmpc_forward_rollout_ex_f32", "wbmpc_forward_rollout_ex_f64",
                "wbmpc_forward_rollout_plan")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K3's C entry points, built from csrc/rollout.cu for the host."""
    block = BLOCK.search((_lib.CSRC / "rollout.cu").read_text())
    assert block is not None, "csrc/rollout.cu lost its card-only block"
    edits = (("#include <cuda_runtime.h>", '#include "emu_shim.h"\n#include <cstring>'),
             (block.group(0), HOST_PRIMITIVES),
             ("extern __shared__ __align__(16) unsigned char smem_raw[];",
              "unsigned char* smem_raw = emu_smem;"))
    return build_host_library(tmp_path_factory.mktemp("k3_host"), "rollout.cu", edits, None, "",
                              ENTRY_POINTS)


def _data(seed, N, nx, nu, batch=None):
    rng = np.random.default_rng(seed)
    parts = [rollout.random_stage_data(rng, N, nx, nu, dtype=np.float64)
             for _ in range(batch or 1)]
    return {f: np.stack([p[f] for p in parts]) if batch else parts[0][f] for f in FIELDS}


def _plan(lib, N, nx, nu, dtype):
    out = (ctypes.c_int * 5)()
    code = lib.wbmpc_forward_rollout_plan(N, nx, nu, 4 if dtype == "f32" else 8, out)
    return code, dict(cluster=out[0], slots=out[1], smem_bytes=out[2])


def _call(lib, data, dtype, cluster=None, slots=None):
    """(the entry point's return code, its dxs, dus as numpy arrays, NaN where unwritten)."""
    npdt = np.float32 if dtype == "f32" else np.float64
    ins = [np.ascontiguousarray(data[f], dtype=npdt) for f in FIELDS]
    lead = ins[0].shape[:-3]
    N, nx, nu = ins[0].shape[-3], ins[0].shape[-1], ins[1].shape[-1]
    outs = [np.full(lead + (N + 1, nx), np.nan, npdt), np.full(lead + (N, nu), np.nan, npdt)]
    batch = int(np.prod(lead)) if lead else 1
    args = [a.ctypes.data for a in ins + outs] + [batch, N, nx, nu]
    if cluster is None and slots is None:
        fn = lib.wbmpc_forward_rollout_f32 if dtype == "f32" else lib.wbmpc_forward_rollout_f64
        return fn(*args, None), outs
    fn = lib.wbmpc_forward_rollout_ex_f32 if dtype == "f32" else lib.wbmpc_forward_rollout_ex_f64
    return fn(*args, cluster or 0, slots or 0, None), outs


def _run(lib, data, dtype, cluster=None, slots=None):
    code, outs = _call(lib, data, dtype, cluster, slots)
    assert code == 0, "the emulated launch failed (a hand-off wait timed out or misfired)"
    return outs


def _plain(data, dtype):
    tdt = DTYPES[dtype][1]
    return to_numpy(rollout.forward_rollout_plain(*(torch.as_tensor(data[f], dtype=tdt)
                                                    for f in FIELDS)))


def _tol(dtype, ref):
    if dtype == "f64":
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=0.0, atol=1e-5 * max(1.0, float(np.abs(ref[0]).max())))


# (N, nx, nu, dtype, cluster, slots, batch, the plan's (cluster, slots)); None: the kernel's own
# (a forced geometry has no plan to check: None)
CASES = [
    (7, 12, 5, "f32", None, None, None, (1, 7)),   # 8 KB of stages: one CTA
    (7, 12, 5, "f64", 2, None, None, None),
    (7, 12, 5, "f32", 4, None, None, None),
    (7, 12, 5, "f64", 7, None, None, None),       # one stage a rank
    (15, 35, 35, "f32", None, None, None, (8, 2)),
    (15, 35, 35, "f64", 2, 2, None, None),        # 8 stages a rank through 2 slots
    (28, 58, 35, "f32", None, None, None, (8, 4)),
    (28, 58, 35, "f64", None, None, None, (8, 3)),   # the ring: 4 stages, 3 slots
    (28, 58, 21, "f32", None, None, None, (8, 4)),
    (10, 20, 8, "f64", 4, None, 2, None),         # a batch: two clusters
]


def _case_id(c):
    N, nx, nu, dtype, cluster, slots, batch, _ = c
    return (f"{N}x{nx}x{nu}-{dtype}-C{cluster or 'plan'}" + (f"-S{slots}" if slots else "")
            + (f"-B{batch}" if batch else ""))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_rollout_matches_plain(emulated, case):
    N, nx, nu, dtype, cluster, slots, batch, plan = case
    if plan is not None:
        code, got_plan = _plan(emulated, N, nx, nu, dtype)
        assert code == 0 and (got_plan["cluster"], got_plan["slots"]) == plan
        assert got_plan["smem_bytes"] <= 232448
    data = _data(N + nx + nu, N, nx, nu, batch)
    ref = _plain(data, dtype)
    assert_close(_run(emulated, data, dtype, cluster, slots), ref, **_tol(dtype, ref),
                 what=f"{_case_id(case)} vs plain")


@pytest.mark.parametrize("case", [(7, 12, 5, "f32", 4), (15, 35, 35, "f64", None),
                                  (28, 58, 35, "f32", None)],
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[3]}-C{c[4] or 'plan'}")
def test_emulated_rollout_matches_pallas(emulated, case):
    N, nx, nu, dtype, cluster = case
    data = _data(11, N, nx, nu)
    with jax_mode(dtype):
        ref = to_numpy(pallas_forward_rollout(
            *(jnp.asarray(data[f], dtype=DTYPES[dtype][0]) for f in FIELDS), interpret=True))
    assert_close(_run(emulated, data, dtype, cluster), ref, **_tol(dtype, ref),
                 what=f"{case} vs Pallas interpret")


@pytest.mark.parametrize("offset", [1, 3])
def test_emulated_rollout_unaligned_inputs(emulated, offset):
    """Every input `offset` values into its buffer (as a view of a larger
    tensor may be): each array's bulk copy moves its 16-byte-aligned middle,
    cp.async the ends, at another lead for each stage."""
    data = _data(offset, 15, 35, 35)
    ref = _plain(data, "f32")
    shifted = {}
    for f, v in data.items():
        buf = np.empty(v.size + offset, np.float32)
        buf[offset:] = v.ravel()
        shifted[f] = buf[offset:].reshape(v.shape)
        assert shifted[f].ctypes.data % 16 != 0
    ins = [shifted[f] for f in FIELDS]
    outs = [np.full((16, 35), np.nan, np.float32), np.full((15, 35), np.nan, np.float32)]
    code = emulated.wbmpc_forward_rollout_ex_f32(*(a.ctypes.data for a in ins + outs), 1, 15, 35,
                                                 35, 4, 0, None)
    assert code == 0
    assert_close(outs, ref, **_tol("f32", ref), what=f"inputs {offset} values off alignment")


def test_emulated_rollout_is_bit_reproducible(emulated):
    """(28, 58, 35) f32 and the f64 ring, each launched twice: the same bits."""
    for dtype in ("f32", "f64"):
        data = _data(5, 28, 58, 35)
        first, again = _run(emulated, data, dtype), _run(emulated, data, dtype)
        for a, b in zip(first, again):
            assert np.array_equal(a, b), f"{dtype}: two launches on the same inputs differ"


def test_emulated_rollout_refuses_bad_geometry(emulated):
    """A stage beyond 227 KB; a cluster above N (a rank without a stage) or
    above 8; more slots than a rank has stages; no instance: refused, and
    nothing is written."""
    assert _plan(emulated, 4, 200, 100, "f64")[0] != 0
    data = _data(0, 7, 12, 5)
    for cluster, slots in ((8, 0), (9, 0), (2, 5)):
        code, outs = _call(emulated, data, "f32", cluster, slots)
        assert code != 0 and np.isnan(outs[0]).all()
    code, _ = _call(emulated, {f: v[None][:0] for f, v in data.items()}, "f32")
    assert code != 0
