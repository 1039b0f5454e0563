"""BENCHMARK.json against the benchmark's contract, the cell's files found
by name (a configuration, a traffic mix and a metric added as new files
need no edit to a file that is there), and the guard against JAX."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

from mpcbench import harness
from mpcbench.tests.small import HOME, ROOT, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        names.add(c["name"])
    assert len(names) == len(b["configs"])
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
        module = harness.load_module(HOME / "metrics" / f"{m['name']}.py", "m_" + m["name"])
        assert (module.UNIT, module.SOURCE) == (m["unit"], m["source"])
        assert module.MOVES == m.get("moves")
    for w in b["workloads"]:
        cell = harness.Cell(b, w["name"])
        reported = [m["name"] for m in cell.end_to_end()]
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer()


def test_files_under_paths_are_named_from_names():
    for path in HOME.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_added_files_are_found_by_name(tmp_path):
    home = tmp_path / "bench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(HOME / sub, home / sub)
    # new files only: a configuration, a traffic mix, a metric
    shutil.copy(home / "configs" / "humanoid23-wb.json", home / "configs" / "other-robot.json")
    t = json.loads((home / "traffic" / "walk-cmds.json").read_text())
    t["obs_noise_std"] = 0.0
    (home / "traffic" / "still.json").write_text(json.dumps(t))
    (home / "metrics" / "episodes_n.py").write_text(
        'SOURCE = "program_counter"\nUNIT = "n"\nMOVES = "solves_per_s"\n\n\n'
        "def read(run):\n    return len({s.episode for s in run.solves}) or None\n")
    b = benchmark(later=True)
    b["configs"].append(dict(b["configs"][0], name="other-robot",
                             file="mpcbench/configs/other-robot.json"))
    b["workloads"].append({"name": "other-still", "config": "other-robot", "traffic": "still",
                           "chips": 1, "why": "a new cell from new files"})
    b["per_layer"].append({"name": "episodes_n", "unit": "n", "better": "higher",
                           "source": "program_counter", "layer": "MPC runtime: episodes",
                           "moves": "solves_per_s", "workloads": ["other-still"]})
    cell = harness.Cell(b, "other-still", home)
    assert cell.config["formulation"] == "wb" and cell.traffic["obs_noise_std"] == 0.0
    assert cell.driver().Loop is not None
    names = [m["name"] for m in cell.per_layer()]
    assert "episodes_n" in names
    assert "episodes_n" not in [m["name"] for m in harness.Cell(b, "wb-walk", home).per_layer()]
    import types
    run = types.SimpleNamespace(solves=[types.SimpleNamespace(episode=0),
                                        types.SimpleNamespace(episode=1)])
    out = harness.read_metrics(cell, [m for m in cell.per_layer() if m["name"] == "episodes_n"],
                               run)
    assert out == {"episodes_n": {"value": 2.0, "unit": "n"}}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax():
    for path in HOME.rglob("*.py"):
        if "tests" in path.relative_to(HOME).parts:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not harness.forbidden_modules(tops), path
        if "reference" in path.relative_to(HOME).parts:
            assert "wb_humanoid_mpc_tpu_torch" not in tops, path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"wb_humanoid_mpc_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert harness.forbidden_modules({"wb_humanoid_mpc_tpu.solver": 1, "jaxlib.xla": 1}) == [
        "jaxlib", "wb_humanoid_mpc_tpu"]


def test_what_a_run_loads_holds_no_jax():
    """In a fresh interpreter: everything a run imports, the port and the
    reference included, loads neither JAX nor the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from mpcbench import harness, compare, roofline\n"
        "b = harness.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = harness.Cell(b, w['name'])\n"
        "    c.driver()\n"
        "    [c.metric(m['name']) for m in c.end_to_end() + c.per_layer()]\n"
        "import wb_humanoid_mpc_tpu_torch.interface, wb_humanoid_mpc_tpu_torch.ops._lib\n"
        "import mpcbench.reference.build\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload", "cen-walk", "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
