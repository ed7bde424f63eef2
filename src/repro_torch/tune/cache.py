"""Persistent on-disk cache for Create-time autotuning results (counterpart
of ``repro.tune.cache``).

cuSten's contract is that every expensive decision happens once at Create
time.  The autotuner keeps that promise across *processes*: measured
winners are stored as JSON under ``~/.cache/repro-tune/`` (override with
``REPRO_TUNE_CACHE``; the reference's directory and variable, whose
entries never collide with these: the keys differ), keyed by everything that could change
the answer — kernel name, shape, dtype, boundary condition, backend
request, the torch and CUDA versions, a **host fingerprint** and the
**device** the problem runs on (:func:`host_fingerprint`: the card's
name, compute capability and SM count, or ``cpu``) — so a second Create
of an identical plan on the same machine never re-measures, while a warm
cache shipped between differing hosts or cards misses and re-measures
instead of silently reusing the donor's choices.
``REPRO_TUNE_FORCE=1`` (:func:`repro_torch.tune.enable_force`)
re-measures even on a hit.

Cache entries are one file per key (temp file, fsync, ``os.replace``), so
concurrent Creates race harmlessly.  A corrupted, truncated, foreign or
missing file is a miss, never an error: the tuner re-measures and rewrites
it.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import platform
import tempfile
from pathlib import Path

import torch

from repro_torch.runtime import chaos as _chaos

ENV_VAR = "REPRO_TUNE_CACHE"
SCHEMA_VERSION = 1


def _dtype_name(dtype) -> str:
    """``'float64'`` for ``torch.float64``, ``np.float64`` or the name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(getattr(dtype, "name", dtype))


@functools.lru_cache(maxsize=None)
def device_fingerprint(device: str = "cpu") -> str:
    """The identity of the device a problem runs on: ``'cpu'`` off a card;
    on a card its name, compute capability and SM count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return (f"{props.name}/sm_{props.major}{props.minor}/"
            f"{props.multi_processor_count}sm")


@functools.lru_cache(maxsize=None)
def host_fingerprint(device: str = "cpu") -> str:
    """A coarse hardware identity baked into every tune key: architecture,
    logical core count and the device's fingerprint
    (:func:`device_fingerprint`).  Deterministic across processes on the
    same machine (the cross-process key-stability contract)."""
    return "/".join(
        str(p)
        for p in (
            platform.machine() or "unknown",
            f"{os.cpu_count() or 0}cpu",
            device_fingerprint(str(device)),
        )
    )


def cache_dir() -> Path:
    """Cache root: ``$REPRO_TUNE_CACHE`` or ``~/.cache/repro-tune``."""
    root = os.environ.get(ENV_VAR)
    if root:
        return Path(root)
    return Path.home() / ".cache" / "repro-tune"


def tune_key(
    kernel: str,
    *,
    shape,
    dtype,
    bc: str | None = None,
    backend: str | None = None,
    extra=None,
    device="cpu",
) -> str:
    """Canonical cache key for one tuning problem: a sorted-key JSON
    document of (schema, kernel, shape, dtype, bc, backend, the torch and
    CUDA versions, the host fingerprint of ``device``, extra).
    Deterministic across processes on the same host.  ``extra`` carries
    kernel-specific discriminators (halo extents, the cyclic flag, the
    registry operator the weights or bands came from, ...) and must be
    JSON-serialisable."""
    doc = {
        "schema": SCHEMA_VERSION,
        "kernel": str(kernel),
        "shape": [int(s) for s in shape],
        "dtype": _dtype_name(dtype),
        "bc": bc,
        "backend": backend,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": host_fingerprint(str(device)),
        "extra": extra,
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


class TuneCache:
    """One JSON file per key under ``root`` (see :func:`cache_dir`)."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else cache_dir()

    def path_for(self, key: str) -> Path:
        digest = hashlib.sha256(key.encode("utf-8")).hexdigest()[:32]
        return self.root / f"{digest}.json"

    def get(self, key: str):
        """The stored winner config for ``key``, or None on a miss.
        Unreadable, corrupted or mismatched files are misses, not errors."""
        try:
            with open(self.path_for(key), encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError, UnicodeDecodeError):
            return None
        if not isinstance(payload, dict) or payload.get("key") != key:
            return None  # truncated rewrite or (vanishingly rare) collision
        return payload.get("best")

    def put(self, key: str, best, *, us: float | None = None) -> None:
        """Store ``best`` for ``key`` atomically: the payload is written,
        flushed and fsync'd to a temp file before the rename, so a killed
        process never leaves a truncated entry under the final name.  Any
        failure (an unserialisable ``best`` included) leaves no stray
        ``.tmp`` behind and is swallowed: the cache degrades to a miss, it
        never breaks a Create.  Fires the chaos site ``'tune.cache_write'``
        at ``point='write'`` (before the payload) and ``point='replace'``
        (between the fsync and the rename)."""
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        except OSError:
            return
        payload = {"key": key, "best": best, "us": us}
        ok = False
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                _chaos.fire("tune.cache_write", point="write")
                json.dump(payload, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            # an injected io_error here rides the OSError degrade path (a
            # miss); an injected crash is a kill between fsync and publish
            _chaos.fire("tune.cache_write", point="replace")
            os.replace(tmp, self.path_for(key))
            ok = True
        except (OSError, TypeError, ValueError):
            pass
        finally:
            if not ok:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
