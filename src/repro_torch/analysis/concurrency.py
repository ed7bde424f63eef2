"""AST concurrency lint for the serving/runtime layer (counterpart of
``repro.analysis.concurrency``, of which it is a copy).

The serve engine, LRU, metrics, and chaos runtime all follow the same
locking discipline: shared mutable state lives in ``self._*`` attributes
owned by a class that creates ``self._lock``, every post-``__init__``
write happens inside ``with self._lock:``, and nothing *blocking* —
queue puts/gets, a device synchronize (``torch.cuda.synchronize``, a
stream's or an event's ``synchronize``, and the reference's
``block_until_ready``), ``time.sleep``, thread joins — runs while the lock
is held (the deadlock shape: a worker blocked on a full queue while
holding the lock the producer needs).

This module enforces both halves statically:

- ``unlocked_shared_write`` — an assignment to ``self._foo`` outside any
  ``with self._lock:`` block, in a class that owns a ``_lock``
  (``__init__`` and other construction-time methods are exempt; a line
  may opt out with ``# concurrency: ok`` plus a reason).
- ``blocking_call_under_lock`` — a ``time.sleep``, ``.synchronize()``,
  ``block_until_ready``, queue ``put``/``get`` (on a queue-named
  receiver), or ``.join()`` (on a worker/thread-named receiver)
  lexically inside a ``with self._lock:`` body.

It is deliberately **stdlib-only** (``ast`` + ``dataclasses``): run as a
module, or as a bare script on a host with no torch::

    python -m repro_torch.analysis.concurrency src/repro_torch/serve src/repro_torch/runtime
    python src/repro_torch/analysis/concurrency.py src/repro_torch

Exit status is the number of findings (0 == clean), making it a
fail-closed lint step.  The proof that the pass actually fires on real
violation shapes lives in tests/test_torch_concurrency_lint.py (seeded
snippets of both kinds).
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path

PRAGMA = "# concurrency: ok"

# methods that run before the object is shared across threads
_CONSTRUCTION_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

# blocking attribute calls and the receiver-name evidence we require
_QUEUE_HINTS = ("queue", "_q")
_THREAD_HINTS = ("worker", "thread")


@dataclasses.dataclass(frozen=True)
class ConcurrencyFinding:
    """One lint hit: ``rule`` is ``unlocked_shared_write`` or
    ``blocking_call_under_lock``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:  # "path:line: [rule] message"
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _is_self_attr(node: ast.AST, name: str | None = None) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and (name is None or node.attr == name)
    )


def _receiver_name(func: ast.Attribute) -> str:
    """Best-effort dotted receiver of an attribute call, lowercased."""
    parts: list[str] = []
    node: ast.AST = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)).lower()


def _is_lock_with(item: ast.withitem) -> bool:
    """True for ``with self._lock:`` (optionally aliased)."""
    ctx = item.context_expr
    if isinstance(ctx, ast.Call):  # e.g. self._lock.acquire_timeout(...)
        ctx = ctx.func
    return _is_self_attr(ctx) and "lock" in ctx.attr.lower()  # type: ignore[union-attr]


def _blocking_reason(call: ast.Call) -> str | None:
    """Why this call blocks, or None if it doesn't (syntactic evidence)."""
    func = call.func
    if isinstance(func, ast.Name):
        return "sleep()" if func.id == "sleep" else None
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    recv = _receiver_name(func)
    if attr == "sleep" and (recv == "time" or recv.endswith(".time")):
        return "time.sleep()"
    if attr == "block_until_ready":
        return ".block_until_ready()"
    if attr == "synchronize":
        return f".synchronize() on {recv!r}"
    if attr in ("put", "get") and any(h in recv for h in _QUEUE_HINTS):
        return f"queue .{attr}() on {recv!r}"
    if attr == "join" and any(h in recv for h in _THREAD_HINTS):
        return f".join() on {recv!r}"
    if attr == "result" and "fut" in recv:
        return f".result() on {recv!r}"
    return None


def _pragma_lines(source: str) -> set[int]:
    return {
        i
        for i, line in enumerate(source.splitlines(), start=1)
        if PRAGMA in line
    }


class _ClassLinter(ast.NodeVisitor):
    """Lint one class that owns a ``self._lock``."""

    def __init__(self, path: str, pragmas: set[int]):
        self.path = path
        self.pragmas = pragmas
        self.findings: list[ConcurrencyFinding] = []
        self._lock_depth = 0
        self._method: str | None = None

    # -- traversal state ---------------------------------------------------
    def lint_class(self, node: ast.ClassDef) -> list[ConcurrencyFinding]:
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # concurrency: ok — a linter's own state (_lock_depth
                # counts nesting; it is not a lock), never shared
                self._method = stmt.name  # concurrency: ok — as above
                self._lock_depth = 0
                for inner in stmt.body:
                    self.visit(inner)
        return self.findings

    def visit_FunctionDef(self, node):  # nested defs: new unlocked scope
        prev, self._lock_depth = self._lock_depth, 0
        self.generic_visit(node)
        self._lock_depth = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node: ast.With):
        locked = any(_is_lock_with(i) for i in node.items)
        if locked:
            self._lock_depth += 1
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With

    # -- the two rules -----------------------------------------------------
    def _check_write(self, target: ast.AST, line: int):
        if (
            self._lock_depth == 0
            and self._method not in _CONSTRUCTION_METHODS
            and line not in self.pragmas
            and _is_self_attr(target)
            and target.attr.startswith("_")  # type: ignore[union-attr]
            and "lock" not in target.attr.lower()  # type: ignore[union-attr]
        ):
            self.findings.append(
                ConcurrencyFinding(
                    rule="unlocked_shared_write",
                    path=self.path,
                    line=line,
                    message=(
                        f"write to shared 'self.{target.attr}' in "  # type: ignore[union-attr]
                        f"{self._method}() outside 'with self._lock:'"
                    ),
                )
            )

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check_write(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if self._lock_depth > 0 and node.lineno not in self.pragmas:
            reason = _blocking_reason(node)
            if reason is not None:
                self.findings.append(
                    ConcurrencyFinding(
                        rule="blocking_call_under_lock",
                        path=self.path,
                        line=node.lineno,
                        message=(
                            f"{reason} while holding self._lock in "
                            f"{self._method}() (lock held across a "
                            "blocking call)"
                        ),
                    )
                )
        self.generic_visit(node)


def _owns_lock(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            if any(
                _is_self_attr(t) and "lock" in t.attr.lower()  # type: ignore[union-attr]
                for t in node.targets
            ):
                return True
    return False


def lint_source(source: str, path: str = "<string>") -> list[ConcurrencyFinding]:
    """Lint python ``source``; only classes owning a ``_lock`` are held to
    the locking discipline (a lock-free class shares nothing by contract).
    """
    tree = ast.parse(source, filename=path)
    pragmas = _pragma_lines(source)
    findings: list[ConcurrencyFinding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _owns_lock(node):
            findings.extend(_ClassLinter(path, pragmas).lint_class(node))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def lint_paths(paths) -> list[ConcurrencyFinding]:
    """Lint every ``*.py`` file under the given files/directories."""
    findings: list[ConcurrencyFinding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(
                lint_source(f.read_text(encoding="utf-8"), str(f))
            )
    return findings


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    findings = lint_paths(args)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"concurrency lint: {n} finding(s) in {len(args)} path(s)")
    return n


if __name__ == "__main__":
    sys.exit(main())
