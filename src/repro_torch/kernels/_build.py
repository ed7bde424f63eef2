"""Build, load and launch the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/*.cu`` file is compiled at first use by its own ``nvcc`` call
(all started together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The libraries go to ``build/repro_torch/<hash of sources and flags>/`` at
the root of the checkout and are loaded with :mod:`ctypes`.  Every C entry
point launches on the stream it is given (PyTorch's current stream),
allocates nothing, and returns the ``cudaError_t`` of the launch; the
wrapper raises on a non-zero code.  A missing ``nvcc`` or a failed build
raises too: there is no fallback to the plain versions.

This module also holds the launch counters (one plain integer per kernel,
raised by one at each launch and nowhere else) and the backend dispatch
shared by every kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# launches of each kernel since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "stencil2d": 0,
    "penta_cols": 0,
    "penta_rows": 0,
    "ch_rhs_xsweep": 0,
}

BACKENDS = ("auto", "cuda", "torch")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry points per library: (name, argtypes).  Pointers and the stream are
# c_void_p, so ctypes does not cut them to 32 bits.
_ENTRY_POINTS = {
    "penta.cu": (
        ("penta_cols", [_I] + [_P] * 5 + [_P, _P, _P, _I, _I, _P]),
        ("penta_rows", [_I] + [_P] * 5 + [_P, _P, _P, _I, _I, _I, _P]),
    ),
    "stencil2d.cu": (
        ("stencil2d", [_I, _I, _I, _P, _P, _P, _P] + [_I] * 6 + [_P]),
    ),
    "fused_ch.cu": (
        ("ch_rhs_xsweep",
         [_I, _P, _P] + [_P] * 5 + [_P, _P, _I, _I, _I, _D, _D, _D, _P]),
    ),
}
SOURCES = tuple(_ENTRY_POINTS)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_lock = threading.Lock()
_state: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_backend(backend: str) -> None:
    if backend == "fft":
        raise NotImplementedError(
            "backend='fft' is not ported yet (ROADMAP.md queue 1, item 8)"
        )
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """``'auto'`` picks by the tensor's device: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``'cuda'`` forces the
    kernel (which raises on a CPU tensor), ``'torch'`` the plain version."""
    check_backend(backend)
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    return backend


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
        for root in filter(None, (home, "/usr/local/cuda")):
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                path = str(cand)
                break
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of repro_torch cannot be built"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_and_load() -> dict:
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, log = {}, []
    for src in SOURCES:
        target = out_dir / f"lib{Path(src).stem}.so"
        if target.is_file():
            continue
        tmp = out_dir / f".{target.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    failed = []
    for src, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        log.append(f"== nvcc {src} (rc {proc.returncode})\n{out}")
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(src)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    libs = {}
    for src in SOURCES:
        lib = ctypes.CDLL(str(out_dir / f"lib{Path(src).stem}.so"))
        lib.rt_error_string.argtypes = [_I]
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_device_info.argtypes = [_I, _P, _P]
        lib.rt_device_info.restype = _I
        for name, argtypes in _ENTRY_POINTS[src]:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
            libs[name] = (lib, fn)
    return {
        "libs": libs,
        "seconds": time.perf_counter() - t0,
        "log": "\n".join(log),
        "dir": str(out_dir),
        "devices": {},
    }


def build() -> dict:
    """Build (once per process and source hash) and load the kernels.

    Returns ``{'seconds', 'log', 'dir', ...}``: the build's wall time in
    this process, nvcc's output (``-Xptxas=-v`` register and spill report)
    and the library directory."""
    with _lock:
        if not _state:
            _state.update(_build_and_load())
    return _state


def _check(lib, err: int, what: str) -> None:
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError_t {err})")


def device_info(device: torch.device) -> tuple[int, int]:
    """``(opt-in shared memory per block in bytes, SM count)`` of a card."""
    state = build()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    info = state["devices"].get(idx)
    if info is None:
        lib = state["libs"]["penta_cols"][0]
        smem, sms = ctypes.c_int(0), ctypes.c_int(0)
        _check(
            lib,
            lib.rt_device_info(idx, ctypes.byref(smem), ctypes.byref(sms)),
            "cudaDeviceGetAttribute",
        )
        info = state["devices"][idx] = (smem.value, sms.value)
    return info


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32 or float64, got {t.dtype}"
        ) from None


def check_cuda(t: torch.Tensor, name: str, *, like: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``like``'s device,
    of ``like``'s dtype and of the given shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream (the
    stream is appended to ``args``), raise if the launch failed, and count
    the launch."""
    lib, fn = build()["libs"][name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, fn(*args, stream), f"CUDA kernel {name}")
    LAUNCHES[name] += 1


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
