"""PyTorch port, K1's CUDA source on the CPU: `csrc/riccati.cu` compiled by the
host C++ compiler against a small shim that runs each thread block as host
threads, then held against the plain version and the Pallas kernel (interpret
mode) on the synthetic LQ data of tests/test_ops_riccati.py, and for its
float32 precision against the plain version's on a whole-body LQ of the
benchmark (`tests/_saved_solve.py`).

The shim runs one `std::thread` per CUDA thread. `__syncthreads` and the
named barrier are `std::barrier`s, and warp shuffles go through a per-warp
exchange with its own barrier. `cp.async` becomes a plain copy. Shared memory
starts as NaN bytes, so a read of anything the kernel did not write shows in
the result. The threads of a warp run independently, as they may on the
card, so the test catches indexing errors and most missing barriers. It says
nothing about speed, and nothing about what `nvcc` accepts: the card tier
(tests/test_torch_cuda.py) covers that.

Tolerances as tests/test_torch_riccati.py: f32 atol 2e-4 (dxs and dus scaled
by max(|dxs|, 1)); f64 rtol 1e-9, atol 1e-10. The shim and `build_host_library`
also serve K2's and K3's tests, tests/test_torch_kernel_emulation_fkvel.py and
tests/test_torch_kernel_emulation_rollout.py; the shim's cluster part (the
CTAs of a cluster as threads of one process, DSMEM as a pointer into the
peer's buffer, the mbarrier as a counter and a condition variable, the
cluster barrier as a `std::barrier`) serves K3's."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import DTYPES, assert_close, jax_mode, to_numpy
from wb_humanoid_mpc_tpu.ops.riccati import pallas_riccati_rollout
from wb_humanoid_mpc_tpu_torch.ops import _lib, riccati
from wb_humanoid_mpc_tpu_torch.solver.riccati import levenberg_damp

FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")

SHIM = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host emulation"; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
struct EmuBlock {
  unsigned char* smem;
  std::barrier<>* block_bar;
  std::unique_ptr<std::barrier<>> named;
  std::mutex mu;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<double> slots;
};
inline thread_local EmuBlock* emu_block;
inline thread_local unsigned char* emu_smem;
inline void __syncthreads() { emu_block->block_bar->arrive_and_wait(); }
inline void emu_named_sync(int n) {
  {
    std::lock_guard<std::mutex> g(emu_block->mu);
    if (!emu_block->named) emu_block->named.reset(new std::barrier<>(n));
  }
  emu_block->named->arrive_and_wait();
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  emu_block->slots[t] = static_cast<double>(v);
  emu_block->warp_bar[w]->arrive_and_wait();
  const T r = static_cast<T>(emu_block->slots[w * 32 + (l ^ mask)]);
  emu_block->warp_bar[w]->arrive_and_wait();
  return r;
}
template <class K, class... Args>
void emu_launch(K kernel, int grid, int block, size_t smem, Args... args) {
  for (int b = 0; b < grid; ++b) {
    EmuBlock e;
    std::vector<unsigned char> shared(smem, 0xFF);
    std::barrier<> bar(block);
    e.smem = shared.data();
    e.block_bar = &bar;
    for (int w = 0; w < block / 32; ++w) e.warp_bar.emplace_back(new std::barrier<>(32));
    e.slots.resize(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; emu_smem = e.smem; emu_block = &e;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
// ---- thread-block clusters: the CTAs of one cluster run at once, as threads
// of one process; clusters run one after another ----
struct EmuCopy { void* dst; const void* src; size_t n; };
struct EmuMbar {             // an mbarrier: arrivals and bytes to go in the current phase
  std::mutex mu;
  std::condition_variable cv;
  unsigned expected = 0, pending = 0, phase = 0;
  long long tx = 0;
  std::vector<std::pair<EmuCopy, bool>> copies;   // queued copies, whether each counts as tx
};
struct EmuCluster {
  std::vector<unsigned char*> smem;   // each CTA's shared memory, smem_bytes each
  size_t smem_bytes = 0;
  std::unique_ptr<std::barrier<>> bar;
  std::mutex mu;
  std::map<size_t, std::unique_ptr<EmuMbar>> mbars;   // by (rank, shared offset)
  std::atomic<bool> failed{false};
};
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_rank;
inline thread_local std::optional<std::barrier<>::arrival_token> emu_token;
inline std::chrono::seconds emu_wait_limit{60};
inline void* emu_peer(const void* p, unsigned rank) {   // DSMEM: the peer's shared buffer
  const size_t off = static_cast<const unsigned char*>(p) - emu_smem;
  return emu_cluster->smem.at(rank) + off;
}
inline EmuMbar& emu_mbar(const void* p) {   // p: an address in some CTA's shared memory
  const unsigned char* c = static_cast<const unsigned char*>(p);
  std::lock_guard<std::mutex> g(emu_cluster->mu);
  for (size_t r = 0; r < emu_cluster->smem.size(); ++r) {
    const unsigned char* base = emu_cluster->smem[r];
    if (c >= base && c < base + emu_cluster->smem_bytes) {
      auto& m = emu_cluster->mbars[(r << 32) | static_cast<size_t>(c - base)];
      if (!m) m.reset(new EmuMbar);
      return *m;
    }
  }
  std::abort();
}
inline void emu_mbar_init(void* p, unsigned count) {
  EmuMbar& m = emu_mbar(p);
  std::lock_guard<std::mutex> g(m.mu);
  m.expected = m.pending = count;
  m.phase = 0;
  m.tx = 0;
}
inline void emu_mbar_advance(EmuMbar& m) {   // under m.mu: end the phase if nothing is left
  if (m.pending == 0 && m.tx == 0 && m.copies.empty()) {
    m.pending = m.expected;
    ++m.phase;
    m.cv.notify_all();
  }
}
inline void emu_mbar_arrive(void* p, unsigned long long tx = 0) {
  EmuMbar& m = emu_mbar(p);
  std::lock_guard<std::mutex> g(m.mu);
  if (m.expected == 0 || m.pending == 0) { emu_cluster->failed = true; return; }
  --m.pending;
  m.tx += static_cast<long long>(tx);
  emu_mbar_advance(m);
  m.cv.notify_all();   // a waiter may now land the queued copies
}
inline void emu_mbar_expect_tx(void* p, unsigned bytes) { emu_mbar_arrive(p, bytes); }
// queue a copy that completes on the mbarrier (counting its bytes against the
// expected ones if `tx`); it lands when a thread waits on that mbarrier
inline void emu_mbar_copy(void* p, EmuCopy c, bool tx) {
  EmuMbar& m = emu_mbar(p);
  std::lock_guard<std::mutex> g(m.mu);
  m.copies.push_back({c, tx});
}
// wait until phase `parity` has completed, landing the queued copies first; a
// wait past emu_wait_limit marks the launch failed (the kernel runs on with
// what it has)
inline void emu_mbar_wait(void* p, unsigned parity) {
  EmuMbar& m = emu_mbar(p);
  std::unique_lock<std::mutex> g(m.mu);
  const auto deadline = std::chrono::steady_clock::now() + emu_wait_limit;
  while ((m.phase & 1u) == (parity & 1u)) {
    if (m.pending == 0 && !m.copies.empty()) {   // every arrival is in: land the copies
      for (auto& [c, tx] : m.copies) {
        std::memcpy(c.dst, c.src, c.n);
        if (tx) m.tx -= static_cast<long long>(c.n);
      }
      m.copies.clear();
      emu_mbar_advance(m);
      continue;
    }
    if (m.cv.wait_until(g, deadline) == std::cv_status::timeout) {
      emu_cluster->failed = true;
      return;
    }
  }
}
inline void emu_cluster_arrive() { emu_token.emplace(emu_cluster->bar->arrive()); }
inline void emu_cluster_wait() {
  emu_cluster->bar->wait(std::move(*emu_token));
  emu_token.reset();
}
template <class K, class... Args>
int emu_launch_clusters(K kernel, int n_clusters, int size, int block, size_t smem,
                        Args... args) {
  bool failed = false;
  for (int c = 0; c < n_clusters; ++c) {
    EmuCluster cl;
    cl.bar.reset(new std::barrier<>(size * block));
    cl.smem_bytes = smem;
    std::vector<std::unique_ptr<EmuBlock>> blocks;
    std::vector<std::vector<unsigned char>> shared;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int r = 0; r < size; ++r) {
      shared.emplace_back(smem, 0xFF);
      bars.emplace_back(new std::barrier<>(block));
      blocks.emplace_back(new EmuBlock);
      EmuBlock& e = *blocks.back();
      e.smem = shared.back().data();
      e.block_bar = bars.back().get();
      for (int w = 0; w < block / 32; ++w) e.warp_bar.emplace_back(new std::barrier<>(32));
      e.slots.resize(block);
      cl.smem.push_back(e.smem);
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < size; ++r) {
      for (int t = 0; t < block; ++t) {
        threads.emplace_back([&, r, t] {
          threadIdx.x = t; blockIdx.x = c * size + r; blockDim.x = block;
          emu_block = blocks[r].get(); emu_smem = blocks[r]->smem;
          emu_cluster = &cl; emu_rank = r;
          kernel(args...);
        });
      }
    }
    for (auto& th : threads) th.join();
    failed = failed || cl.failed;
  }
  return failed ? 1 : 0;
}
"""

# (what the card runs, what the host runs instead)
EDITS = (
    ("#include <cuda_runtime.h>", '#include "emu_shim.h"'),
    ('asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(d), "l"(src),\n'
     '               "n"(static_cast<int>(sizeof(T))));', "(void)d; *dst = *src;"),
    ('asm volatile("cp.async.commit_group;\\n" ::);', ";"),
    ('asm volatile("cp.async.wait_group 0;\\n" ::: "memory");', ";"),
    ('asm volatile("bar.sync 1, %0;\\n" ::"r"(n) : "memory");', "emu_named_sync(n);"),
    ("extern __shared__ __align__(16) unsigned char smem_raw[];",
     "unsigned char* smem_raw = emu_smem;"),
)
LAUNCH = re.compile(r"riccati_rollout_kernel<T><<<batch, kThreads, smem, "
                    r"static_cast<cudaStream_t>\(stream\)>>>\(")


def build_host_library(directory, source: str, edits, launch: re.Pattern | None,
                       host_launch: str, entry_points) -> ctypes.CDLL:
    """Compile `csrc/<source>` for the host against SHIM: each (card, host) pair
    of `edits` replaced by text (the card's text must be there), the one kernel
    launch matched by `launch` (if any) replaced by `host_launch`; then load it
    and bind `entry_points` with the signatures of `_lib._SIGNATURES`."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel source for the host")
    src = (_lib.CSRC / source).read_text()
    for card, host in edits:
        assert card in src, f"csrc/{source} no longer contains {card!r}"
        src = src.replace(card, host)
    if launch is not None:
        src, n = launch.subn(host_launch, src)
        assert n == 1
    (directory / "emu_shim.h").write_text(SHIM)
    cpp = directory / (source.replace(".cu", "_host.cpp"))
    cpp.write_text(src)
    so = directory / ("lib" + source.replace(".cu", "_host.so"))
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{directory}",
                    "-o", str(so), str(cpp)], check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    for name in entry_points:
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K1's C entry points, built from csrc/riccati.cu for the host."""
    lib = build_host_library(tmp_path_factory.mktemp("k1_host"), "riccati.cu", EDITS, LAUNCH,
                             "emu_launch(riccati_rollout_kernel<T>, batch, kThreads, smem, ",
                             ("wbmpc_riccati_rollout_f32", "wbmpc_riccati_rollout_f64"))
    lib.wbmpc_riccati_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.wbmpc_riccati_smem_bytes.restype = ctypes.c_size_t
    return lib


def _data(seed, N, nx, nu, batch=None, quu_span=1.0):
    rng = np.random.default_rng(seed)
    parts = [riccati.random_lq_data(rng, N, nx, nu, dtype=np.float64, quu_span=quu_span)
             for _ in range(batch or 1)]
    return {f: np.stack([p[f] for p in parts]) if batch else parts[0][f] for f in FIELDS}


def _call(lib, data, dtype, reg):
    """(the entry point's return code, its K, k, dxs, dus as numpy arrays)."""
    npdt = np.float32 if dtype == "f32" else np.float64
    ins = [np.ascontiguousarray(data[f], dtype=npdt) for f in FIELDS]
    lead = ins[0].shape[:-3]
    N, nx, nu = ins[0].shape[-3], ins[0].shape[-1], ins[1].shape[-1]
    outs = [np.empty(lead + (N, nu, nx), npdt), np.empty(lead + (N, nu), npdt),
            np.empty(lead + (N + 1, nx), npdt), np.empty(lead + (N, nu), npdt)]
    fn = lib.wbmpc_riccati_rollout_f32 if dtype == "f32" else lib.wbmpc_riccati_rollout_f64
    batch = int(np.prod(lead)) if lead else 1
    return fn(*(a.ctypes.data for a in ins + outs), batch, N, nx, nu, reg, None), outs


def _run(lib, data, dtype, reg):
    code, outs = _call(lib, data, dtype, reg)
    assert code == 0
    return outs


def _plain(data, dtype, reg):
    tdt = DTYPES[dtype][1]
    return to_numpy(riccati.riccati_rollout_plain(*(torch.as_tensor(data[f], dtype=tdt)
                                                    for f in FIELDS), reg=reg))


def _assert_tol(got, ref, dtype, what):
    if dtype == "f64":
        assert_close(got, ref, rtol=1e-9, atol=1e-10, what=what)
        return
    scale = max(float(np.abs(ref[2]).max()), 1.0)
    assert_close(got[:2], ref[:2], rtol=0.0, atol=2e-4, what=what)
    assert_close(got[2:], ref[2:], rtol=0.0, atol=2e-4 * scale, what=what)


@pytest.mark.parametrize("case", [
    (1, 12, 5, "f64"),    # N = 1: no stage to prefetch
    (2, 12, 5, "f32"),    # N = 2: one stage to prefetch
    (5, 13, 7, "f64"),    # widths off the 4 x 4 tiles; a ragged pivot block
    (4, 58, 1, "f64"),    # nu = 1: one pivot
    (28, 58, 21, "f32"),  # the main path's projected LQ
    (3, 20, 50, "f64"),   # nu beyond the rollout's register rows
    (3, 70, 10, "f32"),   # nx beyond the rollout's register columns
], ids=lambda c: "x".join(map(str, c[:3])) + "-" + c[3])
def test_emulated_kernel_matches_plain(emulated, case):
    N, nx, nu, dtype = case
    data = _data(N + nx + nu, N, nx, nu)
    _assert_tol(_run(emulated, data, dtype, 1e-8), _plain(data, dtype, 1e-8), dtype,
                f"{case} vs plain")


@pytest.mark.parametrize("case", [(7, 12, 5, "f32"), (10, 20, 8, "f64")],
                         ids=lambda c: "x".join(map(str, c[:3])) + "-" + c[3])
def test_emulated_kernel_matches_pallas(emulated, case):
    N, nx, nu, dtype = case
    data = _data(11, N, nx, nu)
    with jax_mode(dtype):
        ref = to_numpy(pallas_riccati_rollout(
            *(jnp.asarray(data[f], dtype=DTYPES[dtype][0]) for f in FIELDS), reg=1e-8,
            interpret=True))
    _assert_tol(_run(emulated, data, dtype, 1e-8), ref, dtype, f"{case} vs Pallas interpret")


def test_emulated_kernel_batch_and_regularization(emulated):
    """Two blocks, Quu diagonals spanning four orders of magnitude, reg 1e-6."""
    data = _data(2, 8, 14, 6, batch=2, quu_span=100.0)
    got = _run(emulated, data, "f64", 1e-6)
    assert got[0].shape == (2, 8, 6, 14)
    _assert_tol(got, _plain(data, "f64", 1e-6), "f64", "batch, regularization")


def test_emulated_entry_point_refuses_shapes_beyond_shared_memory(emulated):
    assert emulated.wbmpc_riccati_smem_bytes(58, 35, 8) <= 232448   # the largest case
    assert emulated.wbmpc_riccati_smem_bytes(120, 60, 8) > 232448
    code, _ = _call(emulated, _data(0, 2, 120, 60), "f64", 1e-8)
    assert code != 0


def _wb_walk_lq():
    """The projected, damped LQ of the first iteration of the benchmark's
    saved whole-body solve (`tests/_saved_solve.py`), built in float32 on
    the CPU: 29 stages at (58, 21), stage costs far larger than B'PB."""
    from tests import _saved_solve as saved
    from wb_humanoid_mpc_tpu_torch import interface
    from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WBNodeParams
    from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq
    from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpIteration, SqpSolverConfig, _times
    from wb_humanoid_mpc_tpu_torch.solver.transcription import Trajectory

    mpc = interface.build_wb_mpc(*saved.files(saved.cell()), device="cpu", dtype=torch.float32)
    cfg = SqpSolverConfig(n_nodes=mpc.n_nodes, dt=mpc.dt, sqp_iterations=2)
    it = SqpIteration(mpc.ocp, mpc.model.flow_map,
                      mpc.ocp.barrier_params("cpu", torch.float32), cfg)
    t0, x0, traj, params, lam = saved.inputs(Trajectory, WBNodeParams, torch.float32, "cpu")
    lq = it.fns.lq_approximation(traj, _times(t0, x0, cfg), params, lam, it.rho_lq)
    reduced = levenberg_damp(project_lq(lq, lq.Cx, lq.Du, lq.g_res, cfg.proj_eps)[0], cfg.reg)
    data = {f: getattr(reduced, f).numpy() for f in FIELDS[:-1]}
    data["dx0"] = (x0 - traj.xs[0]).numpy()
    return data


def test_emulated_kernel_keeps_the_plain_precision_on_the_wb_lq(emulated):
    """In float32, on the whole-body LQ where the stage costs dwarf the
    products they join, K1's K, k, dxs and dus lie no further from float64
    than twice the plain version's. (Summing each product onto its stage
    cost put K 5.6 times, k 3.9 times further, and one solve of the
    benchmark 4.3e-2 from float64.)"""
    data = _wb_walk_lq()
    ref = _plain(data, "f64", 1e-8)

    def errors(got):
        out = []
        for a, r in zip(got, ref):
            scale = np.maximum(1.0, np.abs(r).reshape(len(r), -1).max(axis=1))
            out.append(float((np.abs(a - r).reshape(len(r), -1) / scale[:, None]).max()))
        return out

    kernel, plain = errors(_run(emulated, data, "f32", 1e-8)), errors(_plain(data, "f32", 1e-8))
    for name, e, p in zip(("K", "k", "dxs", "dus"), kernel, plain):
        assert e <= 2.0 * p, f"{name}: kernel {e:.3e}, plain {p:.3e}"
