"""The launch floor: an empty kernel of a given grid, cluster shape, block size
and dynamic shared memory, beside which `chip_smoke.py`, `compare_k2.py` and
`compare_k3.py` put a kernel's device time.

    lib = build()                                      # one nvcc, cached in the build directory
    launch = empty_launcher(lib, 4, 8, 384, 122480)    # 4 clusters of 8 CTAs
    launch()                                           # one launch on the current stream

A cluster of 1 is an ordinary grid, launched without the cluster attribute.
Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import ctypes

import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
// an empty kernel of n_clusters clusters of `cluster` CTAs, `threads` a CTA, `smem` bytes
extern "C" int wbmpc_empty(int n_clusters, int cluster, int threads, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}
"""


def build() -> ctypes.CDLL:
    """The empty kernel's library, compiled once with the kernel library's flags."""
    out_dir = _lib.BUILD_DIR / "launch_floor"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "empty.cu"
    src.write_text(SOURCE)
    so = out_dir / f"empty_{_lib._digest([src])}.so"
    if not so.exists():
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(src), "-o", str(so)]])
    lib = ctypes.CDLL(str(so))
    lib.wbmpc_empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wbmpc_empty.restype = ctypes.c_int
    return lib


def empty_launcher(lib: ctypes.CDLL, n_clusters: int, cluster: int, threads: int, smem: int):
    """A function that launches the empty kernel once on the current stream."""
    def launch():
        code = lib.wbmpc_empty(n_clusters, cluster, threads, smem,
                               torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"empty kernel: CUDA error {code}")
    return launch
