"""repro_torch.analysis.concurrency, the stdlib-only concurrency lint, on the
CPU: the reference's seeded-violation proofs (``tests/test_concurrency_lint.py``)
on the port's copy, a device synchronize under the lock (the port's
counterpart of ``block_until_ready``), the same findings as the reference's
lint on the same sources, and the port's own serving and runtime trees
linting clean."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import concurrency as RCL
from repro_torch.analysis.concurrency import (
    ConcurrencyFinding,
    _owns_lock,
    lint_paths,
    lint_source,
    main as lint_main,
)

REPO = Path(__file__).resolve().parents[1]
LINT_PATH = REPO / "src" / "repro_torch" / "analysis" / "concurrency.py"
PORT_TREES = [REPO / "src" / "repro_torch" / "serve",
              REPO / "src" / "repro_torch" / "runtime"]


UNLOCKED_WRITE = '''
import threading

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def bump(self):
        self._count += 1          # line 10: unlocked shared write

    def locked_bump(self):
        with self._lock:
            self._count += 1      # fine
'''

BLOCKING_UNDER_LOCK = '''
import threading, time

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = None
        self._worker_thread = None

    def drain(self, item):
        with self._lock:
            time.sleep(0.1)                 # line 12
            got = self._queue.get()          # line 13
            out = item.block_until_ready()   # line 14
            self._worker_thread.join()       # line 15
        return got, out
'''

SYNC_UNDER_LOCK = '''
import threading
import torch

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream()

    def flush(self):
        with self._lock:
            torch.cuda.synchronize()         # line 12
            self._stream.synchronize()       # line 13
'''


class TestSeededViolations:
    def test_unlocked_write_is_flagged_with_rule_named(self):
        findings = lint_source(UNLOCKED_WRITE, "seeded.py")
        assert [f.rule for f in findings] == ["unlocked_shared_write"]
        f = findings[0]
        assert "_count" in f.message and "bump" in f.message
        assert f.path == "seeded.py" and f.line == 10
        assert "unlocked_shared_write" in str(f)

    def test_every_blocking_call_under_lock_is_flagged(self):
        findings = lint_source(BLOCKING_UNDER_LOCK, "seeded.py")
        assert len(findings) == 4
        assert {f.rule for f in findings} == {"blocking_call_under_lock"}
        assert [f.line for f in findings] == [12, 13, 14, 15]
        msgs = " ".join(f.message for f in findings)
        assert "sleep" in msgs and ".get()" in msgs
        assert "block_until_ready" in msgs and "join" in msgs

    def test_device_synchronize_under_lock_is_flagged(self):
        findings = lint_source(SYNC_UNDER_LOCK, "seeded.py")
        assert [(f.rule, f.line) for f in findings] == [
            ("blocking_call_under_lock", 12), ("blocking_call_under_lock", 13)]
        assert all(".synchronize()" in f.message for f in findings)

    def test_init_writes_are_exempt(self):
        findings = lint_source(UNLOCKED_WRITE)
        assert all("__init__" not in f.message for f in findings)

    def test_lock_free_class_is_exempt(self):
        src = "class P:\n    def f(self):\n        self._x = 1\n"
        assert lint_source(src) == []

    def test_pragma_suppresses_with_reason(self):
        src = (
            "import threading\n"
            "class E:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def f(self):\n"
            "        self._n = 1  # concurrency: ok — pre-share setup\n"
        )
        assert lint_source(src) == []

    def test_nested_def_does_not_inherit_the_lock(self):
        src = (
            "import threading, time\n"
            "class E:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def f(self):\n"
            "        with self._lock:\n"
            "            def cb():\n"
            "                self._x = 1\n"
            "            return cb\n"
        )
        findings = lint_source(src)
        assert [f.rule for f in findings] == ["unlocked_shared_write"]


@pytest.mark.parametrize("src", [UNLOCKED_WRITE, BLOCKING_UNDER_LOCK],
                         ids=["unlocked", "blocking"])
def test_same_findings_as_reference(src):
    mine = lint_source(src, "seeded.py")
    ref = RCL.lint_source(src, "seeded.py")
    assert [(f.rule, f.line, f.message) for f in mine] == [
        (f.rule, f.line, f.message) for f in ref]


class TestRealTree:
    def test_serve_and_runtime_lint_clean(self):
        findings = lint_paths(PORT_TREES)
        assert findings == [], "\n".join(str(f) for f in findings)

    def test_whole_port_lints_clean(self):
        findings = lint_paths([REPO / "src" / "repro_torch"])
        assert findings == [], "\n".join(str(f) for f in findings)

    def test_lock_owning_classes_are_linted(self):
        """The trees hold the lock-owning classes the lint is for (the
        engine's, the LRU's, the metrics', the fault plan's)."""
        owners = set()
        for tree in PORT_TREES:
            for f in sorted(tree.rglob("*.py")):
                for node in ast.walk(ast.parse(f.read_text())):
                    if isinstance(node, ast.ClassDef) and _owns_lock(node):
                        owners.add(node.name)
        assert {"ServeEngine", "PlanLRU", "ServeMetrics", "FaultPlan"} <= owners

    def test_cli_exit_code_counts_findings(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text(UNLOCKED_WRITE)
        rc = lint_main([str(bad)])
        assert rc == 1
        out = capsys.readouterr().out
        assert "unlocked_shared_write" in out and "bad.py" in out

    def test_cli_clean_exits_zero(self, tmp_path, capsys):
        good = tmp_path / "good.py"
        good.write_text("x = 1\n")
        assert lint_main([str(good)]) == 0


class TestStdlibOnly:
    def test_module_imports_nothing_beyond_stdlib(self):
        tree = ast.parse(LINT_PATH.read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert mods <= {"ast", "dataclasses", "sys", "pathlib",
                        "__future__"}, mods

    def test_runs_as_a_bare_script(self):
        proc = subprocess.run(
            [sys.executable, str(LINT_PATH), *map(str, PORT_TREES)],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin:/usr/local/bin"},
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout

    def test_runs_as_a_module(self):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.concurrency",
             str(REPO / "src" / "repro_torch")],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin:/usr/local/bin",
                 "PYTHONPATH": str(REPO / "src")},
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout


def test_finding_is_hashable_and_ordered():
    f = ConcurrencyFinding("unlocked_shared_write", "a.py", 3, "m")
    assert hash(f) == hash(
        ConcurrencyFinding("unlocked_shared_write", "a.py", 3, "m")
    )
