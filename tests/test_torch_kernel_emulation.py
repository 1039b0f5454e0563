"""PyTorch port, K1's CUDA source on the CPU: `csrc/riccati.cu` compiled by the
host C++ compiler against a small shim that runs each thread block as host
threads, then held against the plain version and the Pallas kernel (interpret
mode) on the synthetic LQ data of tests/test_ops_riccati.py.

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
also serve K2's test, tests/test_torch_kernel_emulation_fkvel.py."""

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

FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <mutex>
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
inline EmuBlock* emu_block;
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
    emu_block = &e;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; emu_smem = e.smem;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
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


def build_host_library(directory, source: str, edits, launch: re.Pattern, host_launch: str,
                       entry_points) -> ctypes.CDLL:
    """Compile `csrc/<source>` for the host against SHIM: each (card, host) pair
    of `edits` replaced by text (the card's text must be there), the one kernel
    launch matched by `launch` replaced by `host_launch`; then load it and
    bind `entry_points` with the signatures of `_lib._SIGNATURES`."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel source for the host")
    src = (_lib.CSRC / source).read_text()
    for card, host in edits:
        assert card in src, f"csrc/{source} no longer contains {card!r}"
        src = src.replace(card, host)
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
