"""Build, load and launch the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/*.cu`` file is compiled at first use by its own ``nvcc`` call
(all started together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The libraries go to ``build/repro_torch/<hash of sources and flags>/`` at
the root of the checkout and are loaded with :mod:`ctypes`.  Every C entry
point launches on the stream it is given (PyTorch's current stream),
allocates nothing, and returns the ``cudaError_t`` of the launch; the
wrapper raises on a non-zero code.  The entry points of the 2D and
batched-1D kernels also take a window (rows, lines or columns of the
output), which the streamed executors of ``repro_torch.launch.stream``
issue one chunk at a time; a monolithic call is one window covering
everything.  A missing ``nvcc`` or a failed build
raises too: there is no fallback to the plain versions.

A user's point function given as CUDA source (see
:func:`repro_torch.kernels.stencil2d.cuda_point_fn`) gets its own copy of
the three stencil libraries: :func:`point_fn_build` writes, for each of
``stencil2d.cu``, ``stencil1d_batch.cu`` and ``stencil3d.cu``, a ``.cu``
file that defines ``REPRO_NWIN`` (the plan's window count), holds the
source and includes the kernel (:func:`point_fn_source`), and compiles
them, in parallel, into ``build/repro_torch/<hash of the kernel sources,
flags, point source and NWIN>/``.  A plan on a card builds it at Create,
so a compile error raises there with nvcc's message.

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

from repro_torch.runtime import chaos as _chaos
from repro_torch.runtime import spans as _spans

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
    "ch_rhs": 0,
    "stencil1d_batch": 0,
    "stencil3d": 0,
    "penta_mid": 0,
    "weno5_advect": 0,
}

# what a kernel wrapper takes, and what a plan or ADI operator takes: the
# spectral backend is routed by the plan before any kernel wrapper
BACKENDS = ("auto", "cuda", "torch")
PLAN_BACKENDS = BACKENDS + ("fft",)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
# C entry points per library: (name, argtypes).  Pointers and the stream are
# c_void_p, so ctypes does not cut them to 32 bits.
_ENTRY_POINTS = {
    "penta.cu": (
        ("penta_cols", [_I] + [_P] * 5 + [_P, _P, _P] + [_I] * 8 + [_P]),
        ("penta_rows", [_I] + [_P] * 5 + [_P, _P, _P] + [_I] * 9 + [_P]),
        ("penta_mid", [_I] + [_P] * 5 + [_P, _P, _P] + [_I] * 6 + [_P]),
        ("penta_rows_occupancy", [_I, _I, _I, _P]),
    ),
    "stencil2d.cu": (
        ("stencil2d", [_I, _I, _I, _P, _P, _P, _P] + [_I] * 10 + [_P] * 4),
    ),
    "stencil1d_batch.cu": (
        ("stencil1d_batch",
         [_I, _I, _I, _P, _P, _P, _P, _I, _I, _L, _L] + [_I] * 7 + [_P] * 4),
    ),
    "stencil3d.cu": (
        ("stencil3d", [_I, _I, _I, _P, _P, _P, _P] + [_I] * 13 + [_P] * 4),
    ),
    "fused_ch.cu": (
        ("ch_rhs_xsweep",
         [_I, _P, _P] + [_P] * 5 + [_P, _P] + [_I] * 7 + [_D, _D, _D, _P]),
        ("ch_rhs", [_I, _P, _P, _P] + [_I] * 4 + [_D, _D, _D, _P]),
    ),
    "weno.cu": (
        ("weno5_advect", [_I, _P, _P, _P, _P, _I, _I, _D, _D, _P]),
    ),
}
SOURCES = tuple(_ENTRY_POINTS)
# the stencil libraries a user's point function is built into, and its id
POINT_FN_SOURCES = ("stencil2d.cu", "stencil1d_batch.cu", "stencil3d.cu")
USER_POINT_FN = 2
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_lock = threading.Lock()
_state: dict = {}
_point_fn_state: dict = {}  # (point source, NWIN) -> build
_point_fn_locks: dict = {}  # (point source, NWIN) -> its build's lock

# library loads of each build directory in this process (the audit's
# rebuild_budget rule reads them)
LOADS: dict[str, int] = {}

# The launch record of repro_torch.analysis.trace, one per thread: a
# callable ``(name, tensors, args)`` that launch() calls on the thread
# that set it.  While it is set, ptr() returns a pointer that carries its
# tensor, and launch() hands its arguments' tensors to the record.
_record = threading.local()


class _Pointer(int):
    """A launch argument's pointer that carries its tensor (an int to
    ctypes)."""


def set_launch_record(record) -> None:
    """Set (a callable) or clear (None) this thread's launch record."""
    _record.on_launch = record


def record_launch(name: str, args: tuple) -> None:
    """Hand one launch to this thread's record, if one is set, with the
    tensors of its :func:`ptr` arguments."""
    on_launch = getattr(_record, "on_launch", None)
    if on_launch is not None:
        tensors = tuple(a.tensor for a in args if isinstance(a, _Pointer))
        on_launch(name, tensors, args)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_backend(backend: str) -> None:
    """A plan's or an ADI operator's backend: ``'auto'|'cuda'|'torch'|'fft'``
    (``'auto'`` never picks ``'fft'``)."""
    if backend not in PLAN_BACKENDS:
        raise ValueError(
            f"backend must be one of {PLAN_BACKENDS}, got {backend!r}")


def check_kernel_backend(backend: str) -> None:
    """A kernel wrapper's backend: ``'auto'|'cuda'|'torch'``.  The spectral
    backend is a plan's and is routed before any kernel wrapper, so an
    ``'fft'`` that reaches one is a caller's bug."""
    if backend == "fft":
        raise ValueError(
            "backend='fft' reached a kernel wrapper: the spectral path is a "
            "plan's (a symbol multiply or divide), routed before any kernel; "
            f"kernel backends are {BACKENDS}"
        )
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """``'auto'`` picks by the tensor's device: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``'cuda'`` forces the
    kernel (which raises on a CPU tensor), ``'torch'`` the plain version."""
    check_kernel_backend(backend)
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


def _digest(*extra: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    for e in extra:
        h.update(b"\0" + e.encode())
    return h.hexdigest()[:16]


def point_fn_key(source: str, nwin: int) -> str:
    """The build directory's name for a user point function: a hash of the
    kernel sources, the flags, the point source and NWIN."""
    return _digest(source, str(int(nwin)))


def point_fn_source(kernel: str, source: str, nwin: int) -> str:
    """The ``.cu`` text of ``kernel``'s user build: NWIN, the user's
    source (nvcc's messages point into it as file ``point_fn``), then the
    kernel with its general path enabled."""
    return (
        f"// {kernel} with a user point function over {int(nwin)} windows\n"
        f"#define REPRO_NWIN {int(nwin)}\n"
        '#line 1 "point_fn"\n'
        f"{source}\n"
        "#define REPRO_USER_POINT_FN 1\n"
        f'#include "{kernel}"\n'
    )


def _compile(out_dir: Path, sources: dict, flags=()) -> str:
    """nvcc each ``{library name: .cu path}`` not built yet into
    ``out_dir/lib<name>.so``, all started together; raise with nvcc's
    output if any fails.  Returns the log."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, log = {}, []
    for name, src in sources.items():
        target = out_dir / f"lib{name}.so"
        if target.is_file():
            continue
        tmp = out_dir / f".{target.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        log.append(f"== nvcc {name} (rc {proc.returncode})\n{out}")
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    return "\n".join(log)


def _load(out_dir: Path, sources) -> dict:
    """Load ``lib<stem>.so`` of each source and set its entry points'
    argument types: ``{entry point: (library, function)}``."""
    LOADS[str(out_dir)] = LOADS.get(str(out_dir), 0) + 1
    libs = {}
    for src in sources:
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
    return libs


def _build_and_load() -> dict:
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _digest()
    log = _compile(out_dir, {Path(s).stem: CSRC / s for s in SOURCES})
    return {
        "libs": _load(out_dir, SOURCES),
        "seconds": time.perf_counter() - t0,
        "log": log,
        "dir": str(out_dir),
        "devices": {},
    }


def point_fn_build(source: str, nwin: int) -> dict:
    """Build (once per process, point source and NWIN) and load the three
    stencil libraries with a user's point function (builds of other
    sources and NWIN may run at the same time, from other threads);
    returns ``{'libs', 'seconds', 'log', 'dir'}`` as :func:`build` does.
    Raises
    ``RuntimeError`` with nvcc's output when the source does not
    compile."""
    key = (source, int(nwin))
    got = _point_fn_state.get(key)
    if got is not None:
        return got
    # one lock a build, so that builds of other sources run side by side
    with _lock:
        key_lock = _point_fn_locks.setdefault(key, threading.Lock())
    with key_lock:
        if key not in _point_fn_state:
            t0 = time.perf_counter()
            out_dir = BUILD_ROOT / point_fn_key(source, nwin)
            out_dir.mkdir(parents=True, exist_ok=True)
            jobs = {}
            for kernel in POINT_FN_SOURCES:
                # not the kernel's own name: the include would find itself
                cu = out_dir / f"point_fn_{kernel}"
                cu.write_text(point_fn_source(kernel, source, nwin))
                jobs[Path(kernel).stem] = cu
            log = _compile(out_dir, jobs, ("-I", str(CSRC)))
            _point_fn_state[key] = {
                "libs": _load(out_dir, POINT_FN_SOURCES),
                "seconds": time.perf_counter() - t0,
                "log": log,
                "dir": str(out_dir),
            }
    return _point_fn_state[key]


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


def occupancy(name: str, device: torch.device, *args) -> int:
    """Resident blocks an SM (or clusters a card) of ``device`` holds, from
    the C entry point ``name`` (its ``args`` and then the int it writes);
    no launch."""
    lib, fn = build()["libs"][name]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, fn(*args, ctypes.byref(blocks)), f"{name} query")
    return blocks.value


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


def window(win, n: int, what: str, out) -> tuple[int, int]:
    """``(start, stop)`` of a launch's window over ``n`` rows, lines or
    columns: the whole extent when ``win`` is None.  A window writes its
    part of a whole output, so it needs the caller's ``out``."""
    if win is None:
        return 0, n
    if out is None:
        raise ValueError(f"a {what} window writes into a given out")
    a, b = int(win[0]), int(win[1])
    if not 0 <= a < b <= n:
        raise ValueError(f"{what} window {win!r} is not within [0, {n}]")
    return a, b


def out_like(out: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """The output buffer of a launch: ``out`` after the checks of
    :func:`check_cuda` against ``like``, or a new contiguous tensor."""
    if out is None:
        return torch.empty_like(like, memory_format=torch.contiguous_format)
    check_cuda(out, "out", like=like, shape=like.shape)
    return out


def launch(name: str, device: torch.device, *args, libs=None,
           route: str | None = None) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream (the
    stream is appended to ``args``), raise if the launch failed, and count
    the launch.  ``libs`` are a user point function's libraries
    (:func:`point_fn_build`), else the library's own.

    The chaos site ``'kernel.dispatch'`` (the reference's
    ``'pallas.dispatch'``) fires first, with ``kernel=name``: an injected
    ``backend_error`` raises before the C call, so it leaves no partial
    output.

    With a launch record set on this thread (:func:`set_launch_record`),
    the launch is recorded after it succeeds (:func:`record_launch`).
    With the spans on (:mod:`repro_torch.runtime.spans`), the whole call
    is the span ``'repro.launch'``, with ``kernel=name`` and, where the
    wrapper names the kernel's route, ``route``."""
    if _spans.ON:
        fields = {"kernel": name} if route is None else {"kernel": name,
                                                         "route": route}
        with _spans.span("repro.launch", **fields):
            return _launch(name, device, args, libs)
    return _launch(name, device, args, libs)


def _launch(name: str, device: torch.device, args: tuple, libs) -> None:
    _chaos.fire("kernel.dispatch", kernel=name)
    lib, fn = (build()["libs"] if libs is None else libs)[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, fn(*args, stream), f"CUDA kernel {name}")
    LAUNCHES[name] += 1
    record_launch(name, args)


def ptr(t: torch.Tensor | None):
    """A launch argument's pointer (None for no tensor); while this thread
    has a launch record, one that carries ``t``."""
    if t is None:
        return None
    if getattr(_record, "on_launch", None) is None:
        return t.data_ptr()
    p = _Pointer(t.data_ptr())
    p.tensor = t
    return p
