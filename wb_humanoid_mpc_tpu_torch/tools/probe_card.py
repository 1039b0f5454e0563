"""Measure, on the card, the latencies and the single-SM copy rates that
bound a one-block kernel such as K1.

    python -m wb_humanoid_mpc_tpu_torch.tools.probe_card

One block of 512 threads; thread 0 reads `clock64()`. Latencies, in SM
cycles per dependent step over 200 steps, from the first three warps while
the other thirteen wait at a barrier: a shared-memory load chain, a global
load chain over a table that L2 holds, a named barrier among 96 threads, an
IEEE `1/sqrtf` and an `rsqrtf`. Copy rates into one SM's shared memory, in
bytes per cycle, for a stage of K1 at (58, 21) f32 (4,640 floats, contiguous,
first read from L2): `cp.async` of 4 bytes a thread, and plain loads and
stores of 4 and 8 bytes. Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib

STEPS, COPY_FLOATS, COPY_REPS = 200, 4640, 28

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void latencies(const int* chain, long long* out, int steps) {
  __shared__ int schain[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) schain[i] = (i * 97 + 13) % 1024;
  __syncthreads();
  if (threadIdx.x < 96) {
    int j = threadIdx.x, g = threadIdx.x;
    float f = 2.0f + threadIdx.x, h = f;
    long long t0 = clock64();
    for (int k = 0; k < steps; ++k) j = schain[j];
    long long t1 = clock64();
    for (int k = 0; k < steps; ++k) g = chain[g];
    long long t2 = clock64();
    for (int k = 0; k < steps; ++k) asm volatile("bar.sync 1, 96;" ::: "memory");
    long long t3 = clock64();
    for (int k = 0; k < steps; ++k) f = 1.0f / sqrtf(f + 1.0f) + 1.0f;
    long long t4 = clock64();
    for (int k = 0; k < steps; ++k) h = rsqrtf(h + 1.0f) + 1.0f;
    long long t5 = clock64();
    if (threadIdx.x == 0) {
      out[0] = t1 - t0; out[1] = t2 - t1; out[2] = t3 - t2; out[3] = t4 - t3; out[4] = t5 - t4;
      out[5] = j + g + static_cast<int>(f + h);
    }
  }
  __syncthreads();
}

__global__ void copies(const float* src, int n, int reps, long long* out) {
  extern __shared__ float buf[];
  for (int r = 0; r < reps; ++r) {
    __syncthreads();
    const float* s = src + static_cast<size_t>(r) * n;
    long long t0 = clock64();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(buf + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(s + e));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    long long t1 = clock64();
    s = src + static_cast<size_t>(r + reps) * n;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += blockDim.x) buf[e] = s[e];
    __syncthreads();
    long long t2 = clock64();
    s = src + static_cast<size_t>(r + 2 * reps) * n;
    for (int e = 2 * threadIdx.x; e + 1 < n; e += 2 * blockDim.x) {
      const float2 v = *reinterpret_cast<const float2*>(s + e);
      buf[e] = v.x;
      buf[e + 1] = v.y;
    }
    __syncthreads();
    long long t3 = clock64();
    if (threadIdx.x == 0) { out[0] += t1 - t0; out[1] += t2 - t1; out[2] += t3 - t2; }
  }
}

extern "C" int probe_latencies(const int* chain, long long* out, int steps) {
  latencies<<<1, 512>>>(chain, out, steps);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int probe_copies(const float* src, int n, int reps, long long* out) {
  copies<<<1, 512, n * sizeof(float)>>>(src, n, reps, out);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def _build() -> ctypes.CDLL:
    out_dir = _lib.BUILD_DIR / "probe_card"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe_card.cu"
    src.write_text(SOURCE)
    so = out_dir / "libprobe_card.so"
    _lib._run_all([[_lib._nvcc(), *_lib.ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC", "-shared",
                    str(src), "-o", str(so)]])
    lib = ctypes.CDLL(str(so))
    lib.probe_latencies.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.probe_copies.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_card: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _build()
    n = 1 << 16
    chain = ((torch.arange(n, device="cuda") * 4099 + 7) % n).to(torch.int32)
    for run in range(2):
        out = torch.zeros(6, dtype=torch.int64, device="cuda")
        assert lib.probe_latencies(chain.data_ptr(), out.data_ptr(), STEPS) == 0
        c = [v / STEPS for v in out.tolist()[:5]]
        print(f"run {run}: cycles per dependent step: shared load {c[0]:.1f}, L2 load {c[1]:.1f}, "
              f"96-thread named barrier {c[2]:.1f}, 1/sqrtf {c[3]:.1f}, rsqrtf {c[4]:.1f}")
    src = torch.randn(3 * COPY_REPS * COPY_FLOATS + 16, device="cuda")
    src.sum().item()   # the source read once, so that L2 holds it
    for run in range(2):
        out = torch.zeros(3, dtype=torch.int64, device="cuda")
        assert lib.probe_copies(src.data_ptr(), COPY_FLOATS, COPY_REPS, out.data_ptr()) == 0
        rates = [4 * COPY_FLOATS * COPY_REPS / v for v in out.tolist()]
        print(f"run {run}: bytes per cycle into one SM ({4 * COPY_FLOATS} B): cp.async 4 B "
              f"{rates[0]:.1f}, load/store 4 B {rates[1]:.1f}, load/store 8 B {rates[2]:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
