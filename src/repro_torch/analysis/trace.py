"""The op trace of one call (counterpart of the jaxpr walker of
``repro.analysis.rules``: ``iter_eqns`` and ``all_primitives``).

Eager PyTorch has no jaxpr: :func:`trace` runs the call and records what
it issues, which is the program the reference would have traced.

- Every aten op, through a ``TorchDispatchMode``: its name, its tensor
  inputs' and outputs' dtypes, shapes and bytes, whether its output is a
  view (the schema's alias without a write), whether it materialises a
  permuted, non-contiguous input (a copy, clone or ``_to_copy`` of a
  transposed view: the ``transpose`` of a jaxpr), whether it is a host
  synchronisation (``_local_scalar_dense``, ``nonzero`` of a CUDA tensor,
  a copy from the card to the host) and its flops
  (:func:`repro_torch.analysis.cost.op_flops`).
- Every launch of the port's CUDA kernels, which are ctypes calls no
  dispatch mode sees: ``kernels/_build.launch``, the one place every
  launch passes, records it with its name and tensor arguments (the
  launch record, ``_build.set_launch_record``, kept per thread as the
  dispatch mode is).
- The live storages' high-water mark in bytes (on the CPU: the call's
  arguments, plus each new storage an op creates until its last tensor
  dies).

A driver loop marks its trips with :func:`trip`, so the ops of each trip
carry the loop's name in their path (the reference's ``('scan', ...)``)
and their trip index.  Nothing is recorded outside :func:`trace`; the
dispatch mode and the launch record are off when no trace runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build

__all__ = ["OpRecord", "TensorMeta", "Trace", "all_ops", "iter_ops", "trace",
           "trip"]

# ops whose output is a fresh buffer no input is read into
_FACTORY = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "scalar_tensor"})
# ops that materialise their input in a layout of their own
_COPIES = frozenset({"copy", "clone", "_to_copy", "contiguous"})


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """A tensor as an op saw it: shape, dtype, bytes of its elements and
    device type."""

    shape: tuple
    dtype: torch.dtype
    nbytes: int
    device: str

    @classmethod
    def of(cls, t: torch.Tensor) -> TensorMeta:
        return cls(tuple(t.shape), t.dtype, t.numel() * t.element_size(),
                   t.device.type)


@dataclasses.dataclass
class OpRecord:
    """One op of a trace: an aten op (``kind='aten'``, ``name`` like
    ``'aten.add.Tensor'``) or a kernel launch (``kind='kernel'``, ``name``
    the kernel's).  ``path`` is the enclosing loops' names (``()`` at top
    level) and ``trip`` the loop trip it ran in (None outside a loop).
    ``alloc`` is the bytes of the new storages its outputs hold."""

    name: str
    kind: str
    inputs: tuple
    outputs: tuple
    view: bool = False
    permuted_copy: bool = False
    host_sync: bool = False
    flops: float = 0.0
    taps: int | None = None
    alloc: int = 0
    path: tuple = ()
    trip: int | None = None

    @property
    def bytes(self) -> float:
        """Bytes moved: its inputs read and outputs written, once each; 0
        for a view and for an op that only allocates (``empty``)."""
        if self.view:
            return 0.0
        return float(sum(m.nbytes for m in self.inputs)
                     + sum(m.nbytes for m in self.outputs))


@dataclasses.dataclass
class Trace:
    """What one call issued: its ops in order, the bytes of its arguments'
    storages, the live-storage high-water mark (arguments included), and
    the bytes of the result's storages and of those the result shares
    with the arguments."""

    ops: list
    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    result: object = None


_active: list = []  # the running trace's recorder (at most one)


def _permuted(t: torch.Tensor) -> bool:
    """A transposed layout: among the dims longer than one, a stride that
    grows (a slice of a contiguous tensor keeps its strides' order)."""
    strides = [s for n, s in zip(t.shape, t.stride()) if n > 1]
    return any(a < b for a, b in zip(strides, strides[1:]))


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s.data_ptr(), s.nbytes()


class _Recorder(TorchDispatchMode):
    """The dispatch mode and launch record behind :func:`trace`."""

    def __init__(self, args):
        super().__init__()
        self.ops: list = []
        self.path: tuple = ()
        self.trip: int | None = None
        self.trips: dict = {}  # loop name -> trips begun
        self.thread = threading.get_ident()  # the tracing thread
        self.live: dict = {}  # storage ptr -> [bytes, live tensors]
        self.live_bytes = 0
        self.peak = 0
        for t in _tensors(args):
            ptr, nbytes = _storage(t)
            if nbytes and ptr not in self.live:
                self.live[ptr] = [nbytes, 1]  # held by the caller throughout
                self.live_bytes += nbytes
        self.argument_ptrs = set(self.live)
        self.argument_bytes = self.peak = self.live_bytes

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t`` live until it dies; the bytes of its storage if the
        storage is new, else 0."""
        ptr, nbytes = _storage(t)
        if not nbytes:
            return 0
        entry = self.live.get(ptr)
        new = entry is None
        if new:
            entry = self.live[ptr] = [nbytes, 0]
            self.live_bytes += nbytes
            self.peak = max(self.peak, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, ptr)
        return nbytes if new else 0

    def _release(self, ptr) -> None:
        entry = self.live.get(ptr)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            del self.live[ptr]
            self.live_bytes -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.analysis.cost import op_flops

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        stem = func.overloadpacket.__name__.rstrip("_")
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        src = ins[1] if stem == "copy" and len(ins) > 1 else (ins[0] if ins else None)
        permuted = (stem in _COPIES and src is not None and _permuted(src)
                    and any(not _permuted(o) for o in outs))
        sync = (stem == "_local_scalar_dense"
                or (stem == "nonzero" and bool(ins) and ins[0].is_cuda)
                or (stem in _COPIES and src is not None and src.is_cuda
                    and any(o.device.type == "cpu" for o in outs)))
        record = OpRecord(
            name=str(func), kind="aten",
            inputs=() if stem in _FACTORY else tuple(TensorMeta.of(t) for t in ins),
            outputs=() if stem in _FACTORY else tuple(TensorMeta.of(t) for t in outs),
            view=view, permuted_copy=permuted, host_sync=sync,
            path=self.path, trip=self.trip)
        record.flops = op_flops(func, args, kwargs, out, record)
        self.ops.append(record)
        record.alloc = sum(self._track(t) for t in outs)
        return out

    def launch(self, name: str, tensors: tuple, args: tuple) -> None:
        """The launch record (``_build.set_launch_record``): one record a
        kernel launch; its bytes are
        its tensor arguments', its flops the family floor's for the shape
        it ran on (:func:`repro_torch.analysis.cost.launch_flops`)."""
        from repro_torch.analysis.cost import launch_flops

        # the stencil kernels' tap count: the first argument of c_taps
        # (kernels/taps.py), a one-element int array; None for no taps
        taps = next((int(a[0]) for a in args if isinstance(a, ctypes.Array)
                     and a._type_ is ctypes.c_int and len(a) == 1), None)
        metas = tuple(TensorMeta.of(t) for t in tensors)
        record = OpRecord(name=name, kind="kernel", inputs=metas, outputs=(),
                          taps=taps, path=self.path, trip=self.trip)
        record.flops = launch_flops(record)
        self.ops.append(record)


def trace(fn, *args) -> Trace:
    """Run ``fn(*args)`` once and record every aten op and kernel launch
    it issues (module docstring).  Traces do not nest."""
    if _active:
        raise RuntimeError("a trace is already running")
    rec = _Recorder(args)
    _active.append(rec)
    _build.set_launch_record(rec.launch)
    try:
        with rec:
            result = fn(*args)
    finally:
        _build.set_launch_record(None)
        _active.clear()
    out_ptrs = {}
    for t in _tensors(result):
        ptr, nbytes = _storage(t)
        if nbytes:
            out_ptrs[ptr] = nbytes
    return Trace(
        ops=rec.ops, argument_bytes=rec.argument_bytes, peak_bytes=rec.peak,
        output_bytes=sum(out_ptrs.values()),
        alias_bytes=sum(b for p, b in out_ptrs.items()
                        if p in rec.argument_ptrs),
        result=result)


@contextlib.contextmanager
def trip(loop: str):
    """Mark one trip of the driver loop ``loop``: the ops recorded inside
    carry ``loop`` in their path and the trip's index (0, 1, ...).  Does
    nothing when no trace runs on this thread."""
    if not _active or _active[0].thread != threading.get_ident():
        yield
        return
    rec = _active[0]
    path, index = rec.path, rec.trip
    rec.trip = rec.trips.get(loop, 0)
    rec.trips[loop] = rec.trip + 1
    rec.path = path + (loop,)
    try:
        yield
    finally:
        rec.path, rec.trip = path, index


def iter_ops(tr: Trace):
    """Yield ``(path, op)`` for every recorded op, in order (the
    counterpart of ``iter_eqns``: ``path`` is the tuple of enclosing loop
    names, ``()`` at top level)."""
    for op in tr.ops:
        yield op.path, op


def all_ops(tr: Trace) -> set[str]:
    """Every op name in the trace (the counterpart of ``all_primitives``):
    aten ops as ``'aten.<op>.<overload>'``, kernel launches by name."""
    return {op.name for op in tr.ops}
