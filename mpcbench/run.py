"""The benchmark of the PyTorch and CUDA port, `wb_humanoid_mpc_tpu_torch`.

    python3 mpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (a `workloads` entry of
BENCHMARK.json) names a configuration (`configs/<name>.json`) and a traffic
mix (`traffic/<name>.json`, which names its driver, `drivers/<name>.py`).
The driver sets the program up, warms it up, measures for `--seconds`,
then checks what the window produced against the plain reference.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (`metrics/<name>.py` each) from a further traced
stretch.

Earlier lines on standard output (starting with `#`) record the card, its
power limit, clocks and power beside the window, launch counts, recovery
and reset counts, peak memory and the set-up's parts. The last lines on
standard error give each number compared with its limit; the last line
on standard output is the result, one JSON object.

Exit codes: 0 with a result; 3 without a CUDA card, or fewer cards than
the cell asks for; 4 when JAX or the JAX package is loaded once the window
has closed (neither may be); anything else on an error. Only exit code 0
prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# one process with few threads: the host's numerical libraries run on one
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

# any kernel cache of the program stays inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "mpcbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "mpcbench_cache" / "torch_extensions")

from mpcbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def info(key: str, value) -> None:
    print(f"# {key}: {json.dumps(value)}", flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    sampler = harness.SmiSampler(0)
    driver = cell.driver()
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                                beside=sampler)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 4

    info("card", {"kind": kind, "count": chips, "torch": torch.__version__,
                  "cuda": torch.version.cuda})
    info("beside_window", sampler.summary)
    for key, value in result.notes().items():
        info(key, value)

    entries = cell.per_layer() if args.trace else cell.end_to_end()
    metrics = harness.read_metrics(cell, entries, result)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": result.memory_peak_bytes}
    out = {"correct": all(v <= limit for v, limit in checks.values()),
           "attempted": len(result.solves),
           "failed": sum(driver.failed(s) for s in result.solves),
           "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = result.trace.busy_s
        device["window_s"] = result.trace.window_s
        out["breakdown"] = result.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        print(f"{k} {v!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
