"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, one cell or one per-layer
metric lives in a file of its own, found by the name the manifest gives:

- ``bench/configs/<config>.json``: the configuration as it is run;
- ``bench/workloads/<cell>.json``: the cell's traffic, chips, why and the
  limits of the comparison that decides ``correct``;
- ``bench/drivers/<config>.py``: Create, set-up and the chunk loop through
  the program's public entry points;
- ``bench/reference/<config>.py``: the plain reference, its control and the
  comparison;
- ``bench/layers/<metric>.py``: the reader of one per-layer metric;
- ``bench/ops/<kernel>.py``: one kernel's operation count and the pattern
  of its names in the profiler.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

# top-level module names a run may not load (compared whole: the program's
# own name, repro_torch, begins with the reference package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    """The manifest at the root of the checkout."""
    return load_json(root / "BENCHMARK.json")


def cell_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in manifest["workloads"])
    raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {known})")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def end_to_end(manifest: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(manifest: dict, cell: str) -> list[dict]:
    """The per-layer metrics whose readers find something in this cell."""
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell])]


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (by path: a name may hold
    characters a module name may not)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    key = f"bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def ops_modules() -> dict:
    """Every ``bench/ops/<kernel>.py`` by kernel name."""
    return {p.stem: load_module("ops", p.stem)
            for p in sorted((BENCH / "ops").glob("*.py"))
            if not p.stem.startswith("_")}


def forbidden_loaded(modules) -> list[str]:
    """The top-level names among ``modules`` (``sys.modules``' keys) that
    a run may not load."""
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops & set(FORBIDDEN_MODULES))
