"""Split K1's device time by phase, on the card.

    python -m wb_humanoid_mpc_tpu_torch.tools.profile_k1 [--launches 5]
        [--out chiprun_out/profile_k1.json]

Builds `csrc/riccati.cu` alone with `-DWBMPC_K1_PHASE_CLOCK`, which makes
thread 0 of the first block read `clock64()` after each block barrier of the
kernel (see the top of the source), and launches it on random LQ data at the
shapes `chip_smoke.py` holds K1 at: (28, 58, 21) and (28, 58, 35), in f32 and
f64. Reports, per shape, the SM cycles of each phase per stage (the stage loop's
phases) or per launch (the rest), their sum per launch, and the instrumented
kernel's device time (CUDA events), so that cycles read as time. Needs a CUDA
card and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib, riccati

SHAPES = ((28, 58, 21, torch.float32), (28, 58, 35, torch.float32),
          (28, 58, 21, torch.float64), (28, 58, 35, torch.float64))
PHASES = ("P update of the stage before + wait for M", "(1) PM = P M", "(2) W = M'PM + cost",
          "(3) Cholesky | back substitution | copy", "last P update + stage 0's K",
          "rollout")


def _build() -> ctypes.CDLL:
    src = _lib.CSRC / "riccati.cu"
    out_dir = _lib.BUILD_DIR / "profile_k1"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libk1clock_{_lib._digest([src])}.so"
    if not so.exists():
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-DWBMPC_K1_PHASE_CLOCK", str(src),
               "-o", str(so)]
        _lib._run_all([cmd])
    lib = ctypes.CDLL(str(so))
    for name in ("wbmpc_riccati_rollout_f32", "wbmpc_riccati_rollout_f64"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.wbmpc_riccati_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wbmpc_riccati_phase_cycles.restype = ctypes.c_int
    lib.wbmpc_error_string.argtypes = [ctypes.c_int]
    lib.wbmpc_error_string.restype = ctypes.c_char_p
    return lib


def _cycles(lib, reset: bool) -> np.ndarray:
    out = (ctypes.c_ulonglong * 6)()
    _lib.check(lib, lib.wbmpc_riccati_phase_cycles(out, int(reset)), "phase clock")
    return np.array(out[:], dtype=np.float64)


def profile(lib, N: int, nx: int, nu: int, dtype, launches: int) -> dict:
    data = riccati.random_lq_data(np.random.default_rng(0), N, nx, nu, dtype=np.float64)
    ins = [torch.as_tensor(data[k], dtype=dtype, device="cuda").contiguous()
           for k in ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")]
    outs = [torch.empty(N, nu, nx, dtype=dtype, device="cuda"),
            torch.empty(N, nu, dtype=dtype, device="cuda"),
            torch.empty(N + 1, nx, dtype=dtype, device="cuda"),
            torch.empty(N, nu, dtype=dtype, device="cuda")]
    fn = lib.wbmpc_riccati_rollout_f32 if dtype == torch.float32 else lib.wbmpc_riccati_rollout_f64
    ptrs = [a.data_ptr() for a in ins + outs]

    def launch():
        code = fn(*ptrs, 1, N, nx, nu, 1e-8, torch.cuda.current_stream().cuda_stream)
        _lib.check(lib, code, "riccati kernel (phase clock)")

    launch()
    torch.cuda.synchronize()
    _cycles(lib, reset=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        launch()
    end.record()
    torch.cuda.synchronize()
    cyc = _cycles(lib, reset=True) / launches
    per_launch = float(cyc.sum())
    ms = start.elapsed_time(end) / launches
    per_stage = {PHASES[i]: cyc[i] / N for i in range(4)}
    return {"shape": [N, nx, nu], "dtype": str(dtype).replace("torch.", ""),
            "cycles_per_stage": per_stage,
            "cycles_per_launch": {PHASES[4]: cyc[4], PHASES[5]: cyc[5], "all": per_launch},
            "device_ms_instrumented": ms, "cycles_per_ms": per_launch / ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/profile_k1.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_k1: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = _build()
    rows = [profile(lib, N, nx, nu, dt, args.launches) for N, nx, nu, dt in SHAPES]
    for r in rows:
        print(f"K1 {tuple(r['shape'])} {r['dtype']}: {r['device_ms_instrumented'] * 1e3:.1f} us "
              f"instrumented, {r['cycles_per_launch']['all']:.0f} cycles per launch")
        for name, c in r["cycles_per_stage"].items():
            print(f"  per stage  {c:10.0f}  {name}")
        for name in PHASES[4:]:
            print(f"  per launch {r['cycles_per_launch'][name]:10.0f}  {name}")
    result = {"card": card, "torch": torch.__version__, "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
