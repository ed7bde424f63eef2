"""No run of the benchmark loads JAX or the JAX package ``repro``; the
reference imports nothing of the program.  Module names are compared by
their whole top-level name: ``repro_torch`` begins with ``repro``."""

import ast
import subprocess
import sys

from bench.harness import manifest

SCAN = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.harness import cell, manifest, profile
m = manifest.load()
for c in m["configs"]:
    manifest.load_module("drivers", c["name"])
    manifest.load_module("reference", c["name"])
for x in m["per_layer"]:
    manifest.load_module("layers", x["name"])
manifest.ops_modules()
import bench.run, bench.calibrate
import torch.profiler
print(",".join(manifest.forbidden_loaded(sys.modules)))
"""


def test_whole_name_comparison():
    assert manifest.forbidden_loaded(["repro_torch", "repro_torch.api",
                                      "jaxtyping", "reprolib"]) == []
    assert manifest.forbidden_loaded(["repro.core", "jax._src"]) == [
        "jax", "repro"]
    assert manifest.forbidden_loaded(["flax", "jaxlib.xla"]) == [
        "flax", "jaxlib"]


def test_harness_loads_no_jax():
    code = SCAN.format(root=str(manifest.ROOT), src=str(manifest.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((manifest.BENCH / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                           "bench"}, path


def test_no_file_of_the_benchmark_imports_jax():
    for path in sorted(manifest.BENCH.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, path
