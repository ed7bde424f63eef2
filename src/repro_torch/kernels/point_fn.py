"""A plain PyTorch point function translated into the stencil kernels'
point function (the counterpart of JAX tracing ``point_fn`` into the
Pallas kernel body, ``repro/kernels/stencil2d.py``).

The reference's function-pointer mode takes any traceable Python
``point_fn(windows, coeffs)``: ``jax`` traces it into the kernel.  Here
the function is traced once by ``make_fx`` on placeholders (``nwin`` 0-d
windows and a coefficient vector of the plan's length, so that a loop
over the coefficients unrolls as it will on the fields), the aten graph
becomes a small SSA expression (:class:`PointIR`), and :func:`emit_cuda`
writes it as the C++ point function that ``_build.point_fn_build``
compiles into the general path of the three hand-written stencil
kernels.  No kernel is added.  :func:`eval_torch` interprets the same
expression with the same aten ops: the CPU tests hold it to the function
bit for bit, which proves the translation without a compiler.

What translates (:data:`OPS`): ``add``, ``sub``, ``rsub``, ``mul``,
``div`` (tensor and scalar forms, their in-place forms on a value the
function made), ``neg``, ``reciprocal``, ``pow`` (scalar, tensor and
scalar-base forms), ``abs``, ``sqrt``, ``rsqrt``, ``exp``, ``log``,
``sin``, ``cos``, ``tanh``, ``maximum``, ``minimum``, ``clamp`` (and
``clamp_min``/``clamp_max``), the six comparisons, ``where``, and
``select``/``unbind`` of the coefficients.  The trace runs in float64;
the kernel's ``T`` is the field's type.  A 0-d tensor the function closes
over (or makes, ``torch.tensor(0.5)``) becomes a literal, baked in at
the function's first translation, as jax bakes it at trace time: change
it afterwards and the kernel keeps the old value.  Anything else raises
``NotImplementedError`` naming the op (or carrying the tracing error):
an op outside the table, a reduction, a shape op, data-dependent Python
control flow, a cast away from the field's type, an in-place write to a
window or a coefficient.  Such a function runs on the card only with its
CUDA source (:func:`repro_torch.kernels.stencil2d.cuda_point_fn`).

The CUDA text rounds each op as the plain version's PyTorch kernels do on
the card (``csrc/point_fn_ops.cuh``: no fused multiply-adds; ``pow`` with
the exponents PyTorch special-cases as products, ``sqrt``, ``rsqrt`` and
reciprocals; a division by a literal as a multiply by its reciprocal).
"""

from __future__ import annotations

import math
import operator
import threading
import weakref
from collections.abc import Callable
from typing import NamedTuple

import torch

aten = torch.ops.aten

# the dtype the function is traced in; the kernel's T is the field's
TRACE_DTYPE = torch.float64


class Const(NamedTuple):
    """A literal: a 0-d tensor's value, its dtype and device (``field``: a
    ``scalar_tensor`` made in the field's dtype, as ``torch.where(c, x,
    0.0)`` makes one)."""

    value: float | int | bool
    dtype: torch.dtype
    device: str
    field: bool = False


class Node(NamedTuple):
    """One SSA value: ``kind`` is ``'win'`` (``args = (i,)``), ``'coef'``
    (``(i,)``), ``'const'`` (``(Const,)``) or an op of :data:`OPS`, whose
    ``args`` hold node indices (ints wrapped in :class:`Ref`) and Python
    scalars; ``target`` is the aten overload it evaluates with."""

    kind: str
    args: tuple
    target: object = None
    is_bool: bool = False


class Ref(int):
    """An argument that is a node index (a plain int is a literal)."""


class PointIR(NamedTuple):
    """A traced point function: ``nodes`` in evaluation order, the index of
    the result, and the counts it was traced for."""

    nodes: tuple
    out: int
    nwin: int
    ncoeffs: int


# op name -> the aten packets it comes from (the in-place forms map to
# their functional op)
_PACKETS = {
    "add": ("add", "add_"), "sub": ("sub", "sub_"), "rsub": ("rsub",),
    "mul": ("mul", "mul_"), "div": ("div", "div_"), "neg": ("neg",),
    "reciprocal": ("reciprocal",), "pow": ("pow",), "abs": ("abs",),
    "sqrt": ("sqrt",), "rsqrt": ("rsqrt",), "exp": ("exp",),
    "log": ("log",), "sin": ("sin",), "cos": ("cos",), "tanh": ("tanh",),
    "maximum": ("maximum",), "minimum": ("minimum",),
    "clamp": ("clamp",), "clamp_min": ("clamp_min",),
    "clamp_max": ("clamp_max",), "eq": ("eq",), "ne": ("ne",),
    "lt": ("lt",), "le": ("le",), "gt": ("gt",), "ge": ("ge",),
    "where": ("where",),
}
OPS = tuple(_PACKETS)
_OP_OF = {p: op for op, ps in _PACKETS.items() for p in ps}
_COMPARE = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
            "ge": ">="}
_MATH = ("abs", "sqrt", "rsqrt", "exp", "log", "sin", "cos", "tanh")
# ops that pass a value through unchanged (a copy, a detached alias)
_IDENTITY = ("clone", "detach", "alias", "lift_fresh_copy")


class _Refused(Exception):
    pass


def _name(fn) -> str:
    return getattr(fn, "__name__", type(fn).__name__)


def _refusal(fn, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"point_fn {_name(fn)!r} has no CUDA counterpart: {why}.  The "
        "translator takes the elementwise ops of "
        "repro_torch.kernels.point_fn.OPS on the windows and the "
        "coefficients; give the function's CUDA source with "
        "repro_torch.kernels.stencil2d.cuda_point_fn")


class _LastCall(torch.overrides.TorchFunctionMode):
    """Remembers the torch function the traced code called last, so that a
    tracing error names the op that raised it."""

    last = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.last = func
        return func(*args, **(kwargs or {}))


def _make_fx_graph(fn: Callable, nwin: int, ncoeffs: int):
    from torch.fx.experimental.proxy_tensor import make_fx

    last = _LastCall()

    def traced(coeffs, *windows):
        with last:
            return fn(list(windows), coeffs)

    args = (torch.zeros(ncoeffs, dtype=TRACE_DTYPE),) + tuple(
        torch.zeros((), dtype=TRACE_DTYPE) for _ in range(nwin))
    try:
        return make_fx(traced, tracing_mode="real")(*args)
    except Exception as e:  # the tracing error, carried in the refusal
        where = getattr(last.last, "__qualname__", None) or _name(last.last)
        raise _Refused(
            f"tracing it failed in {where} ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''}); data-dependent "
            "Python control flow and ops on more than one point do not "
            "translate") from e


def _op_str(target) -> str:
    return f"aten.{target._overloadpacket.__name__}.{target._overloadname}"


def trace(fn: Callable, nwin: int, ncoeffs: int) -> PointIR:
    """``fn(windows, coeffs)`` traced over ``nwin`` windows and ``ncoeffs``
    coefficients into a :class:`PointIR`; raises ``NotImplementedError``
    naming what does not translate."""
    try:
        return _trace(fn, int(nwin), int(ncoeffs))
    except _Refused as e:
        raise _refusal(fn, str(e)) from e.__cause__


def _trace(fn, nwin, ncoeffs) -> PointIR:
    gm = _make_fx_graph(fn, nwin, ncoeffs)
    nodes: list[Node] = []
    val = {}  # fx node -> Ref, a tuple of Refs (unbind) or "coeffs"
    origin = {}  # fx node -> "input" (a window, coefficient or constant)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]

    def add(node: Node) -> Ref:
        nodes.append(node)
        return Ref(len(nodes) - 1)

    def const_of(ref):
        n = nodes[ref] if isinstance(ref, Ref) else None
        return n.args[0] if n is not None and n.kind == "const" else None

    out_ref = None
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            i = placeholders.index(n)
            if i == 0:
                val[n] = "coeffs"
            else:
                val[n] = add(Node("win", (i - 1,)))
            origin[n] = "input"
            continue
        if n.op == "get_attr":
            t = getattr(gm, n.target)
            if t.ndim != 0:
                raise _Refused(f"it closes over a tensor of shape "
                               f"{tuple(t.shape)}; only 0-d constants "
                               "become literals")
            val[n] = add(Node("const", (Const(t.item(), t.dtype,
                                              str(t.device)),)))
            origin[n] = "input"
            continue
        if n.op == "output":
            res = n.args[0]
            if not isinstance(res, torch.fx.Node) or not isinstance(
                    val.get(res), Ref):
                raise _Refused("it does not return one tensor")
            out_ref = val[res]
            continue
        if n.target is operator.getitem:
            src, i = n.args
            if not isinstance(val.get(src), tuple):
                raise _Refused("it indexes a value that is not the "
                               "coefficients' unbind")
            val[n] = val[src][i]
            origin[n] = "input"
            continue
        target = n.target
        if not isinstance(target, torch._ops.OpOverload):
            raise _Refused(f"it calls {target!r}")
        packet = target._overloadpacket.__name__
        args = [val.get(a, a) if isinstance(a, torch.fx.Node) else a
                for a in n.args]
        if any(isinstance(a, torch.fx.Node) and a not in val for a in n.args):
            raise _Refused(f"{_op_str(target)} takes a value it cannot see")
        if packet in ("select", "unbind") and args and args[0] == "coeffs":
            dim = args[1] if len(args) > 1 else n.kwargs.get("dim", 0)
            if dim != 0:
                raise _Refused(f"{_op_str(target)} along dim {dim}")
            if packet == "unbind":
                val[n] = tuple(add(Node("coef", (i,))) for i in range(ncoeffs))
            else:
                val[n] = add(Node("coef", (args[2] % ncoeffs,)))
            origin[n] = "input"
            continue
        if "coeffs" in args:
            raise _Refused(f"{_op_str(target)} on the coefficient vector: "
                           "coefficients translate one at a time (c[i])")
        out_val = n.meta.get("val")
        if not isinstance(out_val, torch.Tensor) or out_val.ndim != 0:
            raise _Refused(f"{_op_str(target)} does not give one value a "
                           "point (a shape op or a reduction)")
        if packet in _IDENTITY:
            val[n] = args[0]
            # a clone is a value of the function's own
            origin[n] = None if packet == "clone" else origin.get(n.args[0])
            continue
        if packet == "_to_copy":
            src_val = n.args[0].meta.get("val")
            if set(n.kwargs) - {"dtype"} or (
                    src_val is not None and n.kwargs.get("dtype",
                                                         src_val.dtype)
                    != src_val.dtype):
                raise _Refused(f"{_op_str(target)} casts to "
                               f"{n.kwargs.get('dtype')}, away from the "
                               "field's type")
            val[n] = args[0]
            origin[n] = origin.get(n.args[0])
            continue
        if packet == "scalar_tensor":
            val[n] = add(Node("const", (Const(
                args[0], out_val.dtype, str(out_val.device),
                field=out_val.dtype == TRACE_DTYPE),)))
            origin[n] = "input"
            continue
        op = _OP_OF.get(packet)
        if op is None:
            raise _Refused(f"{_op_str(target)} is outside the translator's "
                           "table")
        if packet.endswith("_") and origin.get(n.args[0]) == "input":
            raise _Refused(f"{_op_str(target)} writes in place to a window, "
                           "a coefficient or a constant")
        if out_val.dtype not in (TRACE_DTYPE, torch.bool):
            raise _Refused(f"{_op_str(target)} gives {out_val.dtype}, away "
                           "from the field's type")
        kwargs = dict(n.kwargs)
        if kwargs.pop("alpha", 1) != 1 or kwargs.pop("rounding_mode",
                                                     None) is not None:
            raise _Refused(f"{_op_str(target)} with alpha or rounding_mode")
        if kwargs:
            raise _Refused(f"{_op_str(target)} with {sorted(kwargs)}")
        if packet.endswith("_"):
            target = getattr(getattr(aten, packet[:-1]), target._overloadname)
        consts = [const_of(a) for a in args if isinstance(a, Ref)]
        if consts and all(c is not None and not c.field for c in consts):
            # a value of constants alone: folded, as the function computes
            # it, in the constants' own dtype
            t = target(*(_eval_arg(a, nodes) for a in args))
            val[n] = add(Node("const", (Const(t.item(), t.dtype,
                                              str(t.device)),)))
            origin[n] = "input"
            continue
        val[n] = add(Node(op, tuple(args), target,
                          out_val.dtype == torch.bool))
        origin[n] = None
    res = nodes[out_ref]
    if res.is_bool or (res.kind == "const" and not res.args[0].field):
        raise _Refused("it returns a comparison or a constant, not a value "
                       "of the field's type")
    return PointIR(tuple(nodes), int(out_ref), nwin, ncoeffs)


def _eval_arg(a, nodes, env=None):
    if not isinstance(a, Ref):
        return a
    if env is not None:
        return env[a]
    c = nodes[a].args[0]
    return torch.tensor(c.value, dtype=c.dtype, device=c.device)


def _live(ir: PointIR) -> list[int]:
    """The nodes the result depends on, in order."""
    need = {ir.out}
    for i in range(ir.out, -1, -1):
        if i in need:
            need.update(a for a in ir.nodes[i].args if isinstance(a, Ref))
    return sorted(need)


def eval_torch(ir: PointIR, windows, coeffs: torch.Tensor) -> torch.Tensor:
    """The traced function on ``windows`` (``ir.nwin`` tensors) and
    ``coeffs``, by the same aten ops in the same order: bit for bit the
    function itself."""
    env = {}
    for i in _live(ir):
        node = ir.nodes[i]
        if node.kind == "win":
            env[i] = windows[node.args[0]]
        elif node.kind == "coef":
            env[i] = coeffs[node.args[0]]
        elif node.kind == "const":
            c = node.args[0]
            if c.field:
                env[i] = torch.scalar_tensor(
                    c.value, dtype=windows[0].dtype, device=windows[0].device)
            else:
                env[i] = torch.tensor(c.value, dtype=c.dtype, device=c.device)
        else:
            env[i] = node.target(*(_eval_arg(a, ir.nodes, env)
                                   for a in node.args))
    return env[ir.out]


# ---------------------------------------------------------------------------
# CUDA C++
# ---------------------------------------------------------------------------


def _literal(v) -> str:
    """An exact C++ literal of a Python scalar, converted to ``T``."""
    if isinstance(v, bool):
        return f"T({int(v)})"
    if isinstance(v, int):
        return f"T({v})"
    v = float(v)
    if math.isfinite(v):
        return f"T({v!r})"
    bits = {math.inf: "0x7ff0000000000000", -math.inf: "0xfff0000000000000"}
    return (f"T(__longlong_as_double({bits.get(v, '0x7ff8000000000000')}"
            "LL))")


def _scalar_of(ir: PointIR, a):
    """The value of a literal argument as the card's plain version sees it:
    a Python scalar, or a constant on the host (a CPU scalar to a CUDA
    kernel); None for a value computed on the card."""
    if not isinstance(a, Ref):
        return a
    n = ir.nodes[a]
    if n.kind == "const" and n.args[0].device == "cpu":
        return n.args[0].value
    return None


def _pow(x: str, e) -> str:
    """``x ** e`` for a scalar exponent as PyTorch's CUDA ``pow`` computes
    it (``pow_tensor_scalar_kernel``: products, ``sqrt``, ``rsqrt`` and
    reciprocals for its special exponents; 0 and 1 at the aten level)."""
    e = float(e)
    special = {
        0.0: "T(1)",
        1.0: x,
        2.0: f"pf_mul({x}, {x})",
        3.0: f"pf_mul(pf_mul({x}, {x}), {x})",
        0.5: f"sqrt({x})",
        -0.5: f"rsqrt({x})",
        -1.0: f"pf_div(T(1), {x})",
        -2.0: f"T(pf_div(1.0, double(pf_mul({x}, {x}))))",
    }
    return special.get(e, f"pow({x}, {_literal(e)})")


def _expr(ir: PointIR, node: Node, name) -> str:
    args = node.args

    def s(a, arith=True):
        if not isinstance(a, Ref):
            return _literal(a)
        n = ir.nodes[a]
        text = name(a)
        return f"T({text})" if arith and n.is_bool else text

    op = node.kind
    if op in ("add", "sub", "mul"):
        return f"pf_{op}({s(args[0])}, {s(args[1])})"
    if op == "rsub":
        return f"pf_sub({s(args[1])}, {s(args[0])})"
    if op == "div":
        k = _scalar_of(ir, args[1])
        if k is not None:  # the card multiplies by a CPU scalar's reciprocal
            return f"pf_mul({s(args[0])}, pf_div(T(1), {_literal(k)}))"
        return f"pf_div({s(args[0])}, {s(args[1])})"
    if op == "neg":
        return f"(-{s(args[0])})"
    if op == "reciprocal":
        return f"pf_div(T(1), {s(args[0])})"
    if op in _MATH:
        return f"{'fabs' if op == 'abs' else op}({s(args[0])})"
    if op == "pow":
        overload = node.target._overloadname
        if overload == "Scalar":  # scalar base
            if float(args[0]) == 1.0:
                return "T(1)"
            return f"pow({_literal(args[0])}, {s(args[1])})"
        k = _scalar_of(ir, args[1])
        if k is not None:
            return _pow(s(args[0]), k)
        return f"pow({s(args[0])}, {s(args[1])})"
    if op in ("maximum", "minimum"):
        return f"pf_{op}({s(args[0])}, {s(args[1])})"
    if op in ("clamp_min", "clamp_max"):
        return f"pf_{op}({s(args[0])}, {s(args[1])})"
    if op == "clamp":
        lo = args[1] if len(args) > 1 else None
        hi = args[2] if len(args) > 2 else None
        if lo is None and hi is None:
            return s(args[0])
        if hi is None:
            return f"pf_clamp_min({s(args[0])}, {s(lo)})"
        if lo is None:
            return f"pf_clamp_max({s(args[0])}, {s(hi)})"
        return f"pf_clamp({s(args[0])}, {s(lo)}, {s(hi)})"
    if op in _COMPARE:
        return f"({s(args[0], False)} {_COMPARE[op]} {s(args[1], False)})"
    if op == "where":
        return f"({s(args[0], False)} ? {s(args[1])} : {s(args[2])})"
    raise AssertionError(op)


def emit_cuda(ir: PointIR) -> str:
    """The C++ point function of ``ir``::

        template <typename T> __device__ T point_fn(const T* w, const T* c)

    one ``const T tK = ...;`` (``const bool`` for a comparison) an op the
    result depends on, windows as ``w[i]`` in the plain version's window
    order, coefficients as ``c[i]``, literals as ``T(<exact repr>)``."""
    names: dict[int, str] = {}
    lines = []

    def name(i):
        return names[i]

    for i in _live(ir):
        node = ir.nodes[i]
        if node.kind == "win":
            names[i] = f"w[{node.args[0]}]"
        elif node.kind == "coef":
            names[i] = f"c[{node.args[0]}]"
        elif node.kind == "const":
            names[i] = _literal(node.args[0].value)
        else:
            t = f"t{len(lines)}"
            lines.append(f"  const {'bool' if node.is_bool else 'T'} {t} = "
                         f"{_expr(ir, node, name)};")
            names[i] = t
    return ("// a point function translated from Python "
            "(repro_torch.kernels.point_fn)\n"
            '#include "point_fn_ops.cuh"\n\n'
            "template <typename T>\n"
            "__device__ T point_fn(const T* w, const T* c) {\n"
            + "".join(line + "\n" for line in lines)
            + f"  return {names[ir.out]};\n}}\n")


# ---------------------------------------------------------------------------
# the source a launch runs, once per function and counts
# ---------------------------------------------------------------------------

# function -> {(nwin, ncoeffs): source or the refusal's message}
_SOURCES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_lock = threading.Lock()


def translated_source(fn: Callable, nwin: int, ncoeffs: int) -> str:
    """The CUDA source of ``fn`` over ``nwin`` windows and ``ncoeffs``
    coefficients (:func:`trace`, then :func:`emit_cuda`), made once per
    function and counts: a plan's Create and its streamed, distributed
    and served launches share it, and so one build
    (``_build.point_fn_build`` keys on the source).  Raises
    ``NotImplementedError`` for a function the translator refuses."""
    key = (int(nwin), int(ncoeffs))
    try:
        per_fn = _SOURCES.get(fn)
    except TypeError:  # not weakly referenceable: translated each time
        per_fn = None
    got = None if per_fn is None else per_fn.get(key)
    if got is None:
        try:
            got = emit_cuda(trace(fn, *key))
        except NotImplementedError as e:
            got = e
        with _lock:
            try:
                _SOURCES.setdefault(fn, {})[key] = got
            except TypeError:
                pass
    if isinstance(got, NotImplementedError):
        raise NotImplementedError(str(got))
    return got
