"""The benchmark's own spans: name, start, end (host clock, seconds from
the process's first line) and a few fields, kept in memory and written out
when the run ends."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path


class Spans:
    def __init__(self, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.records: list[tuple[str, float, float, dict]] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def add(self, name: str, start: float, end: float, **fields) -> None:
        self.records.append((name, start, end, fields))

    @contextmanager
    def __call__(self, name: str, **fields):
        start = self.now()
        try:
            yield
        finally:
            self.add(name, start, self.now(), **fields)

    def durations(self, name: str) -> list[float]:
        return [b - a for n, a, b, _ in self.records if n == name]

    def total(self, name: str) -> float:
        return sum(self.durations(name))

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for name, a, b, fields in self.records:
                f.write(json.dumps(dict(name=name, start=a, end=b, **fields))
                        + "\n")
