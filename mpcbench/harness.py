"""The benchmark's general machinery: the cell's files found by name, the
metrics read and printed, the guard against JAX, the `nvidia-smi` sampler
and the reduction of a `torch.profiler` trace to device intervals.

Nothing here knows a configuration, a traffic mix or a metric by name:
`BENCHMARK.json` names them, and each lives in a file of its own under the
benchmark's folder (`configs/<name>.json`, `traffic/<name>.json`,
`drivers/<driver>.py`, `metrics/<name>.py`).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may hold: the JAX
# package is the port's reference and is never measured, and the port's name
# begins with its name, so names are compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "wb_humanoid_mpc_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN_MODULES))


# ---- the cell's files, found by name ----

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the Python file `path` as module `name`."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module   # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


class Cell:
    """One `workloads` entry of BENCHMARK.json with its configuration,
    traffic mix, driver and metrics, each read from its own file."""

    def __init__(self, bench: dict, workload: str, home: Path = HERE):
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                           f"{[w['name'] for w in bench['workloads']]}")
        self.home = Path(home)
        self.workload = found[0]
        self.name = workload
        conf = [c for c in bench["configs"] if c["name"] == self.workload["config"]]
        if not conf:
            raise KeyError(f"no config {self.workload['config']!r} in BENCHMARK.json")
        self.config_entry = conf[0]
        self.config = json.loads((self.home / "configs" / f"{conf[0]['name']}.json").read_text())
        self.traffic = json.loads(
            (self.home / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.bench = bench

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.home / "drivers" / f"{name}.py", f"mpcbench_driver_{name}")

    def path(self, rel: str) -> Path:
        """A file of the configuration, relative to the benchmark's folder."""
        return self.home / rel

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if m["moves"] in reported
                and ("workloads" not in m or self.name in m["workloads"])]

    def metric(self, name: str):
        return load_module(self.home / "metrics" / f"{name}.py",
                           "mpcbench_metric_" + name.replace(".", "_").replace("-", "_"))


def read_metrics(cell: Cell, entries: list[dict], run) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read in `run`; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for entry in entries:
        module = cell.metric(entry["name"])
        if module.UNIT != entry["unit"] or module.SOURCE != entry["source"]:
            raise ValueError(f"metrics/{entry['name']}.py declares {module.UNIT!r} from "
                             f"{module.SOURCE!r}; BENCHMARK.json says {entry['unit']!r} from "
                             f"{entry['source']!r}")
        value = module.read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


# ---- statistics ----

def percentile(values, q: float) -> float:
    """The q-th percentile of all `values` (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---- clocks and power beside the window ----

class SmiSampler:
    """`nvidia-smi` sampling SM clock, power draw and temperature once a
    second beside the window (its power limit read once). As a context
    manager it samples inside the `with` and leaves its `summary`."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self, index: int = 0):
        self.index = index
        self.proc = None
        self.limit = None
        self.summary: dict = {}

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.summary = self.stop()

    def start(self) -> None:
        try:
            self.limit = subprocess.run(
                ["nvidia-smi", "-i", str(self.index), "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", str(self.index), f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-l", "1"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except (OSError, subprocess.TimeoutExpired):
            self.proc = None

    def stop(self) -> dict:
        """Stop the sampler, wait for it, and summarise its samples."""
        if self.proc is None:
            return {"power_limit": self.limit, "samples": 0}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
        summary = {"power_limit": self.limit, "samples": len(rows)}
        if rows:
            a = np.asarray(rows)
            for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
                summary[key] = [float(a[:, i].min()), float(np.median(a[:, i])),
                                float(a[:, i].max())]
        return summary


# ---- the device trace ----

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """The device operations of a chrome trace exported by `torch.profiler`
    inside the user annotation `window` (the traced window)."""

    def __init__(self, trace_path: Path, window: str):
        events = json.loads(Path(trace_path).read_text())["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace holds no annotation {window!r}")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.ops = []       # (name, start us, duration us, grid) in the window
        launches = {}       # correlation id -> host runtime call
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e.get("name", "")
            elif cat in DEVICE_CATEGORIES:
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                if ts + dur <= self.t0 or ts >= self.t1:
                    continue
                args = e.get("args", {})
                self.ops.append((e.get("name", ""), ts, dur, args.get("grid"),
                                 args.get("correlation")))
        # each op's host launch call, by correlation id (the runtime event
        # may come before or after it in the file)
        self.ops = [(n, ts, dur, grid, launches.get(corr, ""))
                    for n, ts, dur, grid, corr in self.ops]
        self.ops.sort(key=lambda o: o[1])
        self.intervals = self._merged()
        self.busy_s = sum(b - a for a, b, _ in self.intervals) * 1e-6

    def _merged(self) -> list[tuple[float, float, tuple]]:
        """Merged busy intervals (start, end, the op that starts each)."""
        out: list[list] = []
        for op in self.ops:
            a, b = max(op[1], self.t0), min(op[1] + op[2], self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b, op])
        return [tuple(x) for x in out]

    def kernels(self, name_part: str) -> list[tuple[float, list]]:
        """(duration s, grid) of every kernel whose name contains name_part."""
        return [(dur * 1e-6, grid) for n, _, dur, grid, _ in self.ops if name_part in n]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the host call that launched the work after it."""
        by_name: dict[str, float] = {}
        for n, _, dur, _, _ in self.ops:
            by_name[n] = by_name.get(n, 0.0) + dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = self.t0
        for a, b, first in self.intervals:
            if a > prev:
                gaps.append((f"host {first[4] or 'call'} then {first[0][:80]}", (a - prev) * 1e-6))
            prev = b
        if self.t1 > prev:
            gaps.append(("end of window", (self.t1 - prev) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}
