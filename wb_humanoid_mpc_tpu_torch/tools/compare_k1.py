"""Build one or more versions of K1's source, hold each against the plain
version and time them in turns, on one card.

    python -m wb_humanoid_mpc_tpu_torch.tools.compare_k1 [SOURCE.cu ...] [--rounds 2]

With no source, the package's `csrc/riccati.cu`. Each source is compiled
alone with the kernel library's flags (one `nvcc` each, all started
together) and must keep K1's C interface. For every case (the main path's and
the AL path's shapes in f32 and f64, N = 1, nu = 1, ragged tiles, batches) the
tool prints the error against `riccati_rollout_plain` (f32 within
`chip_smoke.K1_TOL`, f64 within 1e-9) and the device time of one launch
(`chip_smoke.kernel_device_ms`). The sources take turns in each round, so a
comparison between them holds on one card. Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from wb_humanoid_mpc_tpu_torch.ops import _lib, riccati

REPO = Path(__file__).resolve().parents[2]
# (N, nx, nu, dtype, batch, quu_span, reg)
CASES = ((28, 58, 21, torch.float32, None, 1.0, 1e-8), (28, 58, 35, torch.float32, None, 1.0, 1e-8),
         (28, 58, 21, torch.float64, None, 1.0, 1e-8), (28, 58, 35, torch.float64, None, 1.0, 1e-8),
         (1, 58, 21, torch.float32, None, 1.0, 1e-8), (4, 58, 1, torch.float64, None, 1.0, 1e-8),
         (5, 13, 7, torch.float32, None, 1.0, 1e-8), (28, 58, 35, torch.float32, 4, 1.0, 1e-8),
         (8, 14, 6, torch.float64, 2, 100.0, 1e-6))
FIELDS = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu", "QN", "qN", "dx0")


def _build(sources: list[Path]) -> list[ctypes.CDLL]:
    out_dir = _lib.BUILD_DIR / "compare_k1"
    out_dir.mkdir(parents=True, exist_ok=True)
    sos = [out_dir / f"{src.stem}_{_lib._digest([src])}.so" for src in sources]
    _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(src), "-o", str(so)]
                   for src, so in zip(sources, sos) if not so.exists()])
    libs = []
    for so in sos:
        lib = ctypes.CDLL(str(so))
        for name in ("wbmpc_riccati_rollout_f32", "wbmpc_riccati_rollout_f64"):
            getattr(lib, name).argtypes = _lib._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        lib.wbmpc_error_string.argtypes = [ctypes.c_int]
        lib.wbmpc_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    return libs


def _inputs(N, nx, nu, dtype, batch, quu_span):
    rng = np.random.default_rng(N + nx + nu)
    parts = [riccati.random_lq_data(rng, N, nx, nu, dtype=np.float64, quu_span=quu_span)
             for _ in range(batch or 1)]
    return [torch.as_tensor(np.stack([p[f] for p in parts]) if batch else parts[0][f],
                            dtype=dtype, device="cuda").contiguous() for f in FIELDS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k1: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")   # TF32 off, as on the solver's path
    sources = args.sources or [_lib.CSRC / "riccati.cu"]
    libs = _build(sources)
    print(chip_smoke.card_line())
    inputs = [_inputs(*c[:6]) for c in CASES]
    ok = True
    for rnd in range(args.rounds):
        for src, lib in zip(sources, libs):
            parts = []
            for (N, nx, nu, dtype, batch, _, reg), ins in zip(CASES, inputs):
                lead = (batch,) if batch else ()
                outs = [torch.empty(*lead, N, nu, nx, dtype=dtype, device="cuda"),
                        torch.empty(*lead, N, nu, dtype=dtype, device="cuda"),
                        torch.empty(*lead, N + 1, nx, dtype=dtype, device="cuda"),
                        torch.empty(*lead, N, nu, dtype=dtype, device="cuda")]
                fn = (lib.wbmpc_riccati_rollout_f32 if dtype == torch.float32
                      else lib.wbmpc_riccati_rollout_f64)
                ptrs = [a.data_ptr() for a in ins + outs]

                def launch():
                    code = fn(*ptrs, batch or 1, N, nx, nu, reg,
                              torch.cuda.current_stream().cuda_stream)
                    _lib.check(lib, code, str(src))

                launch()
                torch.cuda.synchronize()
                ref = riccati.riccati_rollout_plain(*ins, reg=reg)
                tol = chip_smoke.K1_TOL if dtype == torch.float32 else dict(rtol=1e-9, atol=1e-9)
                label = f"({N},{nx},{nu}) {str(dtype)[6:]}" + (f" batch={batch}" if batch else "")
                try:
                    err = chip_smoke.max_err(outs, ref, what=f"{src.name} {label}", **tol)
                except AssertionError as e:
                    ok = False
                    parts.append(f"{label} FAILED: {e}")
                    continue
                ms = chip_smoke.kernel_device_ms(launch, 20)
                parts.append(f"{label} {ms * 1e3:.2f} us (err {err:.2e})")
            print(f"round {rnd} {src}: " + " | ".join(parts), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
