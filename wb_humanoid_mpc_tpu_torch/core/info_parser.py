"""Parser for Boost property-tree INFO files (the reference's config format).

Replaces ocs2's `LoadData` (reference: `ModelSettings.cpp:104-180`,
`HumanoidCostConstraintFactory.cpp:79-224` consume this format) so the
reference robot configs (`task.info`, `reference.info`, `gait.info`) load
verbatim.

A numpy copy of `wb_humanoid_mpc_tpu/core/info_parser.py`: the PyTorch port
imports nothing of the JAX package, so it keeps its own.

Grammar subset actually used by the reference configs:
  key value            scalar entry (string until end of line, ';'/'//' comments)
  key { ... }          nested block
  [i] value            vector entry inside a block
  (i,j) value          (sparse) matrix entry inside a block
  scaling value        scalar multiplier convention for weight matrices
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np


def _strip_comment(line: str) -> str:
    # ';' and '//' start comments (reference info files use both)
    for marker in (";", "//"):
        idx = line.find(marker)
        if idx >= 0:
            line = line[:idx]
    return line.strip()


def _tokenize(text: str) -> list[str]:
    tokens: list[str] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line:
            continue
        # braces may be glued to keys
        line = line.replace("{", " { ").replace("}", " } ")
        # quoted strings stay single tokens
        for tok in re.findall(r'"[^"]*"|\S+', line):
            tokens.append(tok)
        tokens.append("\n")
    return tokens


def _parse_value(s: str) -> Any:
    s = s.strip().strip('"')
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        i = int(s)
        return i
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def parse_info(text: str) -> dict:
    """Parse INFO text into nested dicts; vector/matrix blocks post-processed
    by :func:`as_vector` / :func:`as_matrix`."""
    tokens = _tokenize(text)
    pos = 0

    def parse_block() -> dict:
        nonlocal pos
        out: dict[str, Any] = {}
        pending_key: str | None = None
        pending_vals: list[str] = []

        def flush():
            nonlocal pending_key, pending_vals
            if pending_key is None:
                return
            if len(pending_vals) == 0:
                out[pending_key] = None
            elif len(pending_vals) == 1:
                out[pending_key] = _parse_value(pending_vals[0])
            else:
                out[pending_key] = [_parse_value(v) for v in pending_vals]
            pending_key, pending_vals = None, []

        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "\n":
                # keep a value-less key pending: `key` on one line with `{` on
                # the next opens a named block (common in reference configs)
                if pending_key is not None and pending_vals:
                    flush()
                pos += 1
                continue
            if tok == "}":
                flush()
                pos += 1
                return out
            if tok == "{":
                pos += 1
                key = pending_key
                pending_key = None
                pending_vals.clear()
                block = parse_block()
                out[key if key is not None else f"_anon{len(out)}"] = block
                continue
            if pending_key is None:
                pending_key = tok.strip('"')
            else:
                pending_vals.append(tok)
            pos += 1
        flush()
        return out

    return parse_block()


def load_info(path: str) -> dict:
    with open(path) as f:
        return parse_info(f.read())


_VEC_KEY = re.compile(r"^\[(\d+)\]$")
_MAT_KEY = re.compile(r"^\((\d+),(\d+)\)$")


def as_vector(block: dict | None, default: list | None = None) -> list:
    """Block of `[i] value` entries -> ordered list (strings or numbers)."""
    if block is None:
        return list(default or [])
    items = []
    for k, v in block.items():
        m = _VEC_KEY.match(k)
        if m:
            items.append((int(m.group(1)), v))
    items.sort()
    return [v for _, v in items]


def as_matrix(block: dict, n: int, m: int | None = None, apply_scaling: bool = True) -> np.ndarray:
    """Block of `(i,j) value` entries (+ optional `scaling`) -> dense array.

    With m=None returns a length-n vector from `(i,0)` entries.
    """
    scale = float(block.get("scaling", 1.0)) if apply_scaling else 1.0
    if m is None:
        out = np.zeros(n)
    else:
        out = np.zeros((n, m))
    for k, v in block.items():
        mm = _MAT_KEY.match(k)
        if not mm:
            continue
        i, j = int(mm.group(1)), int(mm.group(2))
        if i >= n or (m is not None and j >= m):
            continue  # caller probed with a smaller size; ignore excess entries
        if m is None:
            out[i] = float(v)
        else:
            out[i, j] = float(v)
    return out * scale


def get_path(tree: dict, path: str, default: Any = None) -> Any:
    node: Any = tree
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node
