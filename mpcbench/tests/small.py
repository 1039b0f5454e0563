"""A copy of the benchmark's files with the configurations cut to a few
nodes, for the CPU tests: the same cells, traffic, drivers and metrics,
each task file's horizon shortened to `n_nodes` of its own dt."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent


def small_home(dest: Path, n_nodes: int = 4) -> Path:
    """dest/ with configs/, traffic/, drivers/, metrics/ of the benchmark
    and every configuration cut to `n_nodes` nodes."""
    for sub in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(HOME / sub, dest / sub)
    for path in (dest / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        task = dest / c["task"]
        text = task.read_text()
        horizon = n_nodes * c["dt"]
        text = re.sub(r"(\n\s*timeHorizon\s+)[0-9.eE+-]+", rf"\g<1>{horizon!r}", text)
        task.write_text(text)
        c.update(n_nodes=n_nodes, horizon_s=horizon)
        path.write_text(json.dumps(c, indent=1))
    return dest


def benchmark(later: bool = False) -> dict:
    """BENCHMARK.json; with `later`, also the entries of the cells it
    leaves out whose files stay (`later.json`), for the CPU tests."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    if later:
        extra = json.loads((Path(__file__).parent / "later.json").read_text())
        for key in ("configs", "workloads", "per_layer"):
            b[key] = b[key] + extra[key]
    return b
