"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one shared library.

The kernels have a plain C interface and are bound with `ctypes`: each
`csrc/*.cu` is compiled by its own `nvcc` process (all started together),
the objects are linked into one library for `sm_90a`, and the library is
loaded on the first call that needs a kernel. The build lands in
`wb_humanoid_mpc_tpu_torch/_build/` (listed in `.gitignore`) under a name
that hashes the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import every module of the port on a machine without `nvcc`.

It also keeps the launch counts. Each kernel wrapper module registers itself
(`register_counter(__name__)`), which gives it two plain counts: LAUNCHES,
its kernel's launches since its last reset (read by the tests, the card
tier's among them), and RECORDED, the launches recorded into CUDA graphs. A wrapper
counts where it launches, through `count_launch`; under graph capture that
counts in RECORDED, and `utils/graphs.py` adds what a graph recorded
(`recorded()` before and after its capture) to LAUNCHES at each replay
(`add_replayed`). Both also count in the open record of `utils/trace.py`
(`Record.launches`), so a record holds the launches its call ran. The
collectives of `parallel/collectives.py` count the same way, each kind
under a name of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from wb_humanoid_mpc_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_state: dict = {}
COUNTERS: dict = {}   # name -> a registered kernel wrapper module (or counter)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "wbmpc_fkvel_f32": [_P] * 4 + [_D] + [_P] * 5 + [_I] * 3 + [_P],
    "wbmpc_fkvel_f64": [_P] * 4 + [_D] + [_P] * 5 + [_I] * 3 + [_P],
    "wbmpc_fkvel_flow_f32": [_P] * 4 + [_D] + [_P] * 3 + [_I] * 4 + [_P],
    "wbmpc_fkvel_flow_f64": [_P] * 4 + [_D] + [_P] * 3 + [_I] * 4 + [_P],
    "wbmpc_riccati_rollout_f32": [_P] * 15 + [_I] * 4 + [_D, _P],
    "wbmpc_riccati_rollout_f64": [_P] * 15 + [_I] * 4 + [_D, _P],
    "wbmpc_forward_rollout_f32": [_P] * 8 + [_I] * 4 + [_P],
    "wbmpc_forward_rollout_f64": [_P] * 8 + [_I] * 4 + [_P],
    "wbmpc_forward_rollout_ex_f32": [_P] * 8 + [_I] * 6 + [_P],
    "wbmpc_forward_rollout_ex_f64": [_P] * 8 + [_I] * 6 + [_P],
    "wbmpc_forward_rollout_plan": [_I] * 4 + [_P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once; raise with its output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outs


def _build(so: Path, sources: list[Path]) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(sources, objs)])
        tmp_so = Path(tmp) / so.name
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                           *(str(o) for o in objs)]])
        os.replace(tmp_so, so)   # atomic: a concurrent loader sees all or nothing
    return "".join(logs)


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/` on first use."""
    with _lock:
        lib = _state.get("lib")
        if lib is not None:
            return lib
        sources = _sources()
        so = BUILD_DIR / f"libwbmpc_kernels_{_digest(sources)}.so"
        t0 = time.perf_counter()
        log = "" if so.exists() else _build(so, sources)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wbmpc_error_string.argtypes = [ctypes.c_int]
        lib.wbmpc_error_string.restype = ctypes.c_char_p
        lib.wbmpc_riccati_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wbmpc_riccati_smem_bytes.restype = ctypes.c_size_t
        _state.update(lib=lib, build_seconds=time.perf_counter() - t0, build_log=log)
        return lib


def build_info() -> dict:
    """Seconds the first `library()` call took (build included) and the
    compiler's output (`-Xptxas -v`: registers and shared memory per kernel)."""
    library()
    return {"seconds": _state["build_seconds"], "log": _state["build_log"]}


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.wbmpc_error_string(code).decode()})")


def register_counter(module_name: str, holder=None) -> None:
    """Give the kernel wrapper module `module_name` (being imported) its
    LAUNCHES and RECORDED counts; or `holder`, any object, under that name."""
    module = sys.modules[module_name] if holder is None else holder
    module.LAUNCHES = module.RECORDED = 0
    COUNTERS[module_name] = module


def reset_launches(module_name: str) -> None:
    COUNTERS[module_name].LAUNCHES = 0


def count_launch(module_name: str, on_cuda: bool = True) -> None:
    """Count one launch of a registered wrapper's kernel (or one collective,
    `on_cuda` when on CUDA tensors): in RECORDED while the current stream is
    capturing a CUDA graph (the launch is recorded, not run), else in
    LAUNCHES."""
    module = COUNTERS[module_name]
    if on_cuda and torch.cuda.is_current_stream_capturing():
        module.RECORDED += 1
    else:
        module.LAUNCHES += 1
        trace.launched(module_name)


def recorded() -> dict[str, int]:
    """{module name: RECORDED} of every registered wrapper."""
    return {name: module.RECORDED for name, module in COUNTERS.items()}


def add_replayed(held: dict[str, int]) -> None:
    """Count the launches {module name: n} that a graph's replay made."""
    for name, n in held.items():
        COUNTERS[name].LAUNCHES += n
        trace.launched(name, n)
