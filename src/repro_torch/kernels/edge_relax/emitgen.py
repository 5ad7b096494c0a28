"""Generic emits: a program's own ``emit``, ``payload`` and custom monoid
``op`` traced into the CUDA relaxation kernels.

The counterpart of Pallas tracing ``prog.emit`` and ``prog.payload`` into
the TPU kernels' bodies (``repro/kernels/edge_relax/kernel.py`` ``_kernel``
and ``_scan_kernel``).  At :func:`~repro_torch.core.programs.lower` each
function is traced once with
``make_fx(tracing_mode="fake")`` on ``[E]`` fake tensors of the declared
dtypes (:func:`trace_program`; the program verifier reads the same trace),
and the graph becomes a small elementwise IR (:class:`IR`) in which every
type promotion is an explicit cast and every constant is a Python scalar.
:func:`translate` writes the IR as CUDA device functions into one header
(:attr:`Translation.header`); the kernels' generic instance
(``EMIT == kGeneric``, ``csrc/edge_relax_emit.cuh``) includes it, and
``kernel.py`` builds one set of libraries per distinct header text.

The op set (anything else is refused):

* add, sub (and ``c - x``), mul, true div, neg, abs, sqrt;
* exp, exp2, log, log2, log10, log1p, expm1, pow (tensor ** scalar,
  tensor ** tensor, scalar ** tensor), sin, cos, tanh, sigmoid, rsqrt,
  reciprocal;
* floor, ceil, round (half to even, with decimals too), trunc, sign;
* floor_divide, remainder, fmod, div with ``rounding_mode`` "trunc" or
  "floor", bit shifts (integers);
* minimum, maximum, clamp / clamp_min / clamp_max with constant bounds;
* where, the six comparisons, logical and/or/xor/not, bitwise
  and/or/xor/not, isnan, isinf, isfinite;
* dtype casts (``_to_copy``; float to int truncates) and constants
  (Python scalars, scalars and ``*_like`` fills created inside the
  function);

over float32, float16, bfloat16, int32, int64 and bool values, as state
fields, messages and intermediate values.  Refused, with an error that
names the program, the component and the op: reductions and indexing
(across edges, whose blocking the reference's kernels fix), a captured
tensor (the reference's ``pallas_call`` refuses captured constants too),
Python control flow on a traced value (the reference's trace fails),
and every op outside the set.  A refusal is recorded on the lowered program
(:attr:`Translation.error`): the CPU path still calls the program's
functions itself, and a CUDA launch raises it (:class:`GenericEmitError`).
There is no fallback.

Semantics.  :func:`evaluate` runs the IR as torch ops on the inputs'
device, so on the CPU it is bitwise the program's own function; the CUDA
text reproduces torch's CUDA kernels op by op, so on the card the generic
kernels are bitwise their plain versions: every float op rounds on its
own (``__fadd_rn`` & co., no FMA contraction, the CUDA math library's
full-precision ``expf``/``logf``/``powf``/... with no fast math),
subnormals are kept, minimum/maximum/clamp propagate NaN, integers wrap,
float-to-int casts truncate (``__float2int_rz``: NaN to 0, out of range
saturated), and a division by a constant multiplies by the float32
reciprocal of the constant, as torch's CUDA division by a scalar does
(torch on the CPU divides).  A float16/bfloat16 op computes in float32
and rounds once to its dtype (``__float2bfloat16_rn``, ``__float2half_rn``),
with a Python scalar operand kept at float32 (torch's opmath); the
kernels hold 16-bit values widened to float32, exactly, and store them
narrowed.  ``pow`` follows ATen's special exponents (2: ``x*x``, 3:
``x*x*x``, 0.5: sqrt, -0.5: rsqrt, -1: ``1/x``, -2: ``1/(x*x)``; a 16-bit
op rounds the exponent to its dtype first).

Records.  Every node of ``emit`` that depends only on the source vertex
(its state fields, ``src_gid`` and constants) is computed once per
vertex (and lane) in ``pack``, as the payload is: the record holds the
values emit's edge-dependent part reads (an int64 value takes two 32-bit
words), then the payload.  ``weight`` and ``dst_gid`` come from the edge
streams (``dst_gid`` only when read).  Records of up to :data:`MAX_WORDS`
= 7 words fit one 32-byte sector with the senders flag; wider ones take
more sectors per vertex in K1 and K3, and one lane per record in K2.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["GenericEmitError", "Node", "IR", "Traced", "Translation",
           "trace_program", "translate", "translate_monoid", "evaluate",
           "evaluate_emit", "evaluate_payload", "evaluate_op", "MAX_WORDS",
           "TRACE_E"]

MAX_WORDS = 7          # record words that fit one 32-byte sector
TRACE_E = 16           # the traced edge count (the verifier's geometry)

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
_F16, _BF16 = torch.float16, torch.bfloat16
_HALF = (_F16, _BF16)
_FLOATS = (_F32, _F16, _BF16)
_INTS = (_I32, _I64)
_DTYPES = (_F32, _F16, _BF16, _I32, _I64, _BOOL)
# C types of IR values: 16-bit floats are held widened to float, exactly
_CT = {_F32: "float", _F16: "float", _BF16: "float", _I32: "int",
       _I64: "long long", _BOOL: "bool"}
_WORDS = {_F32: 1, _F16: 1, _BF16: 1, _I32: 1, _I64: 2, _BOOL: 1}
# rounding of a float32 value to a 16-bit dtype (device helpers below)
_ROUND16 = {_F16: "rhf", _BF16: "rbf"}


class GenericEmitError(ValueError):
    """A program whose functions the generic CUDA kernels cannot compute;
    the message names the program, the component and the op."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR value.  ``op`` is ``"in"`` (``value`` names the input:
    ``s.<field>``, ``weight``, ``src_gid``, ``dst_gid``, ``a``, ``b``),
    ``"const"`` (``value`` a Python scalar; an operand of a float16/bfloat16
    op stays at float32, as torch computes with it), ``"cast"``, or an op
    of the set whose ``args`` are node indices already of the op's compute
    dtype (``clamp``: ``-1`` for an absent bound; ``pow_scalar``: ``value``
    the exponent).  ``scalar`` marks a constant that torch's CUDA kernels
    read as a CPU scalar (a Python scalar or a 0-d tensor made in the
    function), not a tensor (a ``*_like`` fill)."""

    op: str
    dtype: torch.dtype
    args: tuple = ()
    value: Any = None
    scalar: bool = True


@dataclasses.dataclass(frozen=True)
class IR:
    """An elementwise function as nodes in evaluation order; ``out`` is
    the result's index."""

    nodes: tuple
    out: int

    def live(self, roots=None, stop=()) -> set:
        """Indices of the nodes ``roots`` (default the result) depend on,
        not looking past the nodes in ``stop``."""
        seen, todo = set(), list([self.out] if roots is None else roots)
        while todo:
            i = todo.pop()
            if i < 0 or i in seen:
                continue
            seen.add(i)
            if i not in stop:
                todo.extend(self.nodes[i].args)
        return seen

    def inputs(self) -> set:
        """The input names the result reads."""
        return {self.nodes[i].value for i in self.live()
                if self.nodes[i].op == "in"}


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

def _data_dependent_errors():
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode,
    )
    return (GuardOnDataDependentSymNode, DataDependentOutputException)


@dataclasses.dataclass(frozen=True, eq=False)
class Traced:
    """One component's trace: the graph and its input names (flattened
    in the graph's placeholder order), or why tracing failed —
    ``data_dependent`` when the function branches on (or reads) a traced
    value, which eager torch runs but no trace can follow."""

    component: str
    graph: Any = None
    names: tuple = ()
    error: BaseException | None = None
    data_dependent: bool = False

    @property
    def out(self):
        """The result's fake value (dtype and shape), or None."""
        if self.graph is None:
            return None
        res = next(n for n in self.graph.graph.nodes
                   if n.op == "output").args[0]
        res = res[0] if isinstance(res, (tuple, list)) else res
        return res.meta.get("val") if isinstance(res, torch.fx.Node) \
            else None


def _trace(component: str, fn: Callable, named_args: tuple) -> Traced:
    """``make_fx(fn, tracing_mode="fake")`` on ``[TRACE_E]`` tensors;
    ``named_args`` holds (name, dtype) leaves in ``fn``'s argument
    structure (dicts for the state)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(
        named_args, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], torch.dtype))
    args = pytree.tree_unflatten(
        [torch.zeros(TRACE_E, dtype=dt) for _, dt in leaves], spec)
    def call(*xs):          # positional only: defaults are not inputs
        return fn(*xs)

    try:
        gm = make_fx(call, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    except _data_dependent_errors() as e:
        return Traced(component, error=e, data_dependent=True)
    except Exception as e:  # noqa: BLE001 - the user's function failed
        return Traced(component, error=e)
    return Traced(component, gm, tuple(name for name, _ in leaves))


def _state_args(fields) -> dict:
    return {k: (f"s.{k}", f.dtype) for k, f in fields}


def trace_program(fields, msg_dtype, monoid, emit, payload) -> dict:
    """The traces of a program's ``emit(s, weight, src_gid, dst_gid)``,
    ``payload(s, src_gid)`` (when given) and its monoid's custom ``op(a,
    b)`` (when given): component -> :class:`Traced`."""
    s = _state_args(fields)
    out = {"emit": _trace("emit", emit, (s, ("weight", _F32),
                                         ("src_gid", _I32),
                                         ("dst_gid", _I32)))}
    if payload is not None:
        out["payload"] = _trace("payload", payload, (s, ("src_gid", _I32)))
    if monoid.op is not None:
        out["monoid"] = _trace("monoid", monoid.op, (("a", msg_dtype),
                                                     ("b", msg_dtype)))
    return out


# --------------------------------------------------------------------------
# graph -> IR
# --------------------------------------------------------------------------

class _Refuse(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class _Stack:
    """``torch.stack`` of elementwise values along a new leading axis (IR
    node indices), as a reduction over that axis reads it."""

    items: tuple


_BINARY = {
    "add.Tensor": "add", "add.Scalar": "add", "sub.Tensor": "sub",
    "sub.Scalar": "sub", "mul.Tensor": "mul", "mul.Scalar": "mul",
    "div.Tensor": "div", "div.Scalar": "div", "minimum.default": "minimum",
    "maximum.default": "maximum",
    "bitwise_and.Tensor": "bitwise_and", "bitwise_and.Scalar": "bitwise_and",
    "bitwise_or.Tensor": "bitwise_or", "bitwise_or.Scalar": "bitwise_or",
    "bitwise_xor.Tensor": "bitwise_xor", "bitwise_xor.Scalar": "bitwise_xor",
}
_COMPARE = {f"{c}.{k}": c for c in ("eq", "ne", "lt", "le", "gt", "ge")
            for k in ("Tensor", "Scalar")}
_LOGICAL = {"logical_and.default": "logical_and",
            "logical_or.default": "logical_or",
            "logical_xor.default": "logical_xor"}
_UNARY = {"neg.default": "neg", "abs.default": "abs",
          "bitwise_not.default": "bitwise_not",
          "logical_not.default": "logical_not"}
# float math: the result's dtype is floating (an integer input is cast)
_MATH = {f"{op}.default": op for op in (
    "sqrt", "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "sin",
    "cos", "tanh", "sigmoid", "rsqrt", "reciprocal")}
_ROUNDING = {f"{op}.default": op for op in ("floor", "ceil", "round",
                                            "trunc", "sign")}
# the division family: (IR op) per ATen overload; div with a rounding mode
# maps by the mode
_DIVMOD = {"floor_divide.default": "floordiv",
           "floor_divide.Scalar": "floordiv",
           "remainder.Tensor": "remainder", "remainder.Scalar": "remainder",
           "remainder.Scalar_Tensor": "remainder",
           "fmod.Tensor": "fmod", "fmod.Scalar": "fmod",
           "div.Tensor_mode": None, "div.Scalar_mode": None}
_SHIFTS = {f"{name}.{k}": op
           for name, op in (("__lshift__", "lshift"), ("__rshift__", "rshift"),
                            ("bitwise_left_shift", "lshift"),
                            ("bitwise_right_shift", "rshift"))
           for k in ("Tensor", "Scalar", "Tensor_Scalar", "Scalar_Tensor")}
_PREDICATES = {"isnan.default": "isnan", "isinf.default": "isinf",
               "isfinite.default": "isfinite"}
_FILLS = {"ones_like.default": 1, "zeros_like.default": 0,
          "full_like.default": None}
_STACK_FOLDS = {"amax.default": "maximum", "amin.default": "minimum",
                "sum.dim_IntList": "add"}
_REDUCTIONS = ("sum", "mean", "prod", "amax", "amin", "max", "min", "any",
               "all", "argmax", "argmin", "cumsum", "cumprod", "var", "std",
               "norm", "logsumexp")
_INDEXING = ("select", "index", "slice", "gather", "index_select", "take",
             "narrow", "masked_select", "nonzero", "unbind", "split")


def _op_name(target) -> str:
    name = getattr(target, "__name__", str(target))
    return name[len("aten."):] if name.startswith("aten.") else name


def _classify(op: str) -> str:
    base = op.split(".")[0]
    if base in _REDUCTIONS:
        return f"aten.{op} (a reduction)"
    if base in _INDEXING:
        return f"aten.{op} (indexing)"
    return f"aten.{op}"


def _f32(value) -> float:  # analysis: allow(host-sync): a host constant, once per program
    with np.errstate(over="ignore"):
        return float(np.float32(value))


def _scalar(value, dtype):  # analysis: allow(host-sync): host scalars of a translation, made once per program
    """A Python scalar as an operand of an op computing in ``dtype``:
    floats rounded to float32 as torch rounds a scalar operand (the
    opmath of a float16/bfloat16 op is float32 too)."""
    if dtype in _FLOATS:
        return _f32(value)
    if dtype == _BOOL:
        return bool(value)
    if dtype not in _INTS:
        raise _Refuse(f"{dtype} values")
    if isinstance(value, float) and not float(value).is_integer():
        raise _Refuse(f"the float constant {value!r} in an integer op")
    v = int(value)
    info = torch.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise _Refuse(f"the constant {value!r} outside {dtype}")
    return v


def _stored(value, dtype):  # analysis: allow(host-sync): host scalars of a translation, made once per program
    """``value`` as an element of a ``dtype`` tensor holds it (a 16-bit
    float rounded to its dtype, through float32 as c10 converts)."""
    if dtype in _HALF:
        return float(torch.tensor(_f32(value)).to(dtype).float())
    return _scalar(value, dtype)


class _Lowering:
    def __init__(self):
        self.nodes, self.env = [], {}

    def add(self, node: Node) -> int:
        if node.op != "in" and node.dtype not in _DTYPES:
            raise _Refuse(f"{node.dtype} values")
        self.nodes.append(node)
        return len(self.nodes) - 1

    def const(self, value, dtype, scalar: bool = True) -> int:
        return self.add(Node("const", dtype, value=_scalar(value, dtype),
                             scalar=scalar))

    def cast(self, i: int, dtype, explicit: bool = False) -> int:
        """Node ``i`` as ``dtype``: an implicit promotion keeps a constant's
        float32 value (torch reads a scalar operand at opmath), an
        explicit cast rounds it as a tensor of ``dtype`` would."""
        n = self.nodes[i]
        if n.dtype == dtype:
            return i
        if n.op == "const":
            v = n.value
            if dtype in _INTS and n.dtype in _FLOATS:   # truncates
                if not np.isfinite(v):
                    raise _Refuse(f"the constant {v!r} cast to {dtype}")
                v = int(v)
            elif explicit:
                v = _stored(v, dtype)
            return self.const(v, dtype, n.scalar)
        return self.add(Node("cast", dtype, (i,)))

    def arg(self, a, dtype) -> int:
        """An op argument as a node of ``dtype``: a graph node (cast) or a
        Python scalar (a constant)."""
        if isinstance(a, torch.fx.Node):
            i = self.env.get(a)
            if i is None:
                raise _Refuse("a captured tensor")
            if isinstance(i, _Stack):
                raise _Refuse("a stacked tensor (not elementwise)")
            return self.cast(i, dtype)
        if isinstance(a, (bool, int, float)):
            return self.const(a, dtype)
        raise _Refuse(f"the argument {a!r}")

    @staticmethod
    def val(a):
        return a.meta["val"] if isinstance(a, torch.fx.Node) else a

    def dtype_of(self, a):
        """The dtype of a graph argument (None for a Python scalar)."""
        return a.meta["val"].dtype if isinstance(a, torch.fx.Node) else None


def _lower_node(b: _Lowering, gm, n, op: str, dt, a, kw) -> int:  # analysis: allow(host-sync, host-loop): translates a CPU trace, once per program
    """One graph node as IR nodes; returns the result's index."""
    if op == "lift_fresh_copy.default":
        t = getattr(gm, a[0].target)
        if t.ndim != 0:
            raise _Refuse("a captured tensor")
        return b.const(_stored(t.item(), dt), dt)
    if op == "stack.default":
        if (a[1] if len(a) > 1 else kw.get("dim", 0)) != 0:
            raise _Refuse(f"aten.{op} along a dimension other than 0")
        return _Stack(tuple(b.arg(x, dt) for x in a[0]))
    if op in _STACK_FOLDS and isinstance(b.env.get(a[0]), _Stack):
        # a reduction over the stacked axis: a fold of its elements (a sum
        # of two only, whose order no kernel can change)
        dims = a[1] if len(a) > 1 else kw.get("dim")
        keep = a[2] if len(a) > 2 else kw.get("keepdim", False)
        items = b.env[a[0]].items
        if list(dims if isinstance(dims, (list, tuple)) else [dims]) != [0] \
                or keep or (op.startswith("sum") and len(items) > 2):
            raise _Refuse(f"aten.{op} over {dims!r} of a stack of "
                          f"{len(items)}")
        acc = b.cast(items[0], dt)
        for j in items[1:]:
            acc = b.add(Node(_STACK_FOLDS[op], dt, (acc, b.cast(j, dt))))
        return acc
    if op == "scalar_tensor.default":
        return b.const(_stored(a[0], dt), dt)
    if op in _FILLS:
        fill = _FILLS[op] if _FILLS[op] is not None else a[1]
        return b.const(_stored(fill, dt), dt, scalar=False)
    if op == "_to_copy.default":
        if set(kw) - {"dtype", "layout", "device"}:
            raise _Refuse(f"aten.{op} with {sorted(kw)}")
        return b.cast(b.arg(a[0], b.val(a[0]).dtype), dt, explicit=True)
    if op in _BINARY or op == "rsub.Scalar":
        if kw.get("alpha", 1) != 1 or "rounding_mode" in kw:
            raise _Refuse(f"aten.{op} with {dict(kw)}")
        name = "sub" if op == "rsub.Scalar" else _BINARY[op]
        if dt == _BOOL and name in ("sub", "div"):
            raise _Refuse(f"aten.{op} on bool values")
        if dt == _BOOL and name in ("add", "mul"):      # torch: or / and
            name = "logical_or" if name == "add" else "logical_and"
        x, y = (a[1], a[0]) if op == "rsub.Scalar" else (a[0], a[1])
        return b.add(Node(name, dt, (b.arg(x, dt), b.arg(y, dt))))
    if op in _COMPARE:
        # torch's CUDA comparison reads a scalar at the compute dtype (a
        # 16-bit one rounded), unlike its arithmetic
        ct = torch.result_type(b.val(a[0]), b.val(a[1]))
        xs = [b.arg(x, ct) for x in a[:2]]
        xs = [b.const(_stored(b.nodes[i].value, ct), ct)
              if ct in _HALF and b.nodes[i].op == "const" else i for i in xs]
        return b.add(Node(_COMPARE[op], _BOOL, tuple(xs)))
    if op in _LOGICAL:
        return b.add(Node(_LOGICAL[op], _BOOL,
                          (b.arg(a[0], _BOOL), b.arg(a[1], _BOOL))))
    if op in _UNARY:
        ct = _BOOL if op == "logical_not.default" else dt
        if dt == _BOOL and op in ("neg.default", "abs.default"):
            raise _Refuse(f"aten.{op} on bool values")
        return b.add(Node(_UNARY[op], dt, (b.arg(a[0], ct),)))
    if op in _MATH:
        return b.add(Node(_MATH[op], dt, (b.arg(a[0], dt),)))
    if op in _ROUNDING:
        if dt == _BOOL or (dt in _INTS and op != "sign.default"):
            return b.arg(a[0], dt)                  # an integer copy
        return b.add(Node(_ROUNDING[op], dt, (b.arg(a[0], dt),)))
    if op == "round.decimals":
        if dt not in _FLOATS:
            return b.arg(a[0], dt)                  # an integer copy
        d = int(kw.get("decimals", a[1] if len(a) > 1 else 0))
        return b.add(Node("round", dt, (b.arg(a[0], dt),), value=d or None))
    if op in _DIVMOD:
        name = _DIVMOD[op]
        if name is None:
            mode = kw.get("rounding_mode", a[2] if len(a) > 2 else None)
            name = {None: "div", "trunc": "truncdiv",
                    "floor": "floordiv"}.get(mode)
            if name is None:
                raise _Refuse(f"aten.{op} with rounding_mode {mode!r}")
        if dt == _BOOL:
            raise _Refuse(f"aten.{op} on {dt} values")
        return b.add(Node(name, dt, (b.arg(a[0], dt), b.arg(a[1], dt))))
    if op in _SHIFTS:
        if dt not in _INTS:
            raise _Refuse(f"aten.{op} on {dt} values")
        return b.add(Node(_SHIFTS[op], dt, (b.arg(a[0], dt),
                                            b.arg(a[1], dt))))
    if op in _PREDICATES:
        ct = b.dtype_of(a[0])
        if ct not in _FLOATS:           # an integer is finite, never nan/inf
            return b.const(op == "isfinite.default", _BOOL)
        return b.add(Node(_PREDICATES[op], _BOOL, (b.arg(a[0], ct),)))
    if op == "pow.Tensor_Scalar":
        e = a[1]
        if not isinstance(e, (bool, int, float)):
            raise _Refuse(f"aten.{op} with the exponent {e!r}")
        if dt in _INTS and (isinstance(e, float) or e < 0):
            raise _Refuse(f"aten.{op} of an integer to {e!r}")
        return b.add(Node("pow_scalar", dt, (b.arg(a[0], dt),),
                          value=float(e) if dt in _FLOATS else int(e)))
    if op == "pow.Tensor_Tensor":
        return b.add(Node("pow", dt, (b.arg(a[0], dt), b.arg(a[1], dt))))
    if op == "pow.Scalar":
        # torch wraps the base as a tensor of the result's dtype (rounded
        # to it) on the exponent's device; a base of 1 gives ones
        if a[0] == 1:
            return b.const(1, dt, scalar=False)
        base = b.const(_stored(a[0], dt), dt, scalar=False)
        return b.add(Node("pow", dt, (base, b.arg(a[1], dt))))
    if op in ("clamp.default", "clamp_min.default", "clamp_max.default"):
        lo = a[1] if len(a) > 1 else kw.get("min")
        hi = a[2] if len(a) > 2 else kw.get("max")
        if op == "clamp_max.default":
            lo, hi = None, a[1]
        if isinstance(lo, torch.fx.Node) or isinstance(hi, torch.fx.Node):
            raise _Refuse(f"aten.{op} with tensor bounds")
        bound = lambda v: -1 if v is None else b.const(v, dt)  # noqa: E731
        return b.add(Node("clamp", dt, (b.arg(a[0], dt), bound(lo),
                                        bound(hi))))
    if op == "where.self":
        return b.add(Node("where", dt, (b.arg(a[0], _BOOL), b.arg(a[1], dt),
                                        b.arg(a[2], dt))))
    raise _Refuse(_classify(op))


def _to_ir(traced: Traced, out_dtype=None) -> IR:  # analysis: allow(host-sync, host-loop): translates a CPU trace, once per program
    """The IR of a traced component; raises :class:`_Refuse`."""
    gm = traced.graph
    b = _Lowering()
    place = iter(traced.names)
    out = None
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            # an input of another dtype is refused only if the result
            # reads it (below)
            b.env[n] = b.add(Node("in", n.meta["val"].dtype,
                                  value=next(place)))
            continue
        if n.op == "get_attr":
            # a captured 0-d tensor is a constant (a literal in the
            # reference's kernels too); any other is refused where read
            t = getattr(gm, n.target)
            if isinstance(t, torch.Tensor) and t.ndim == 0 and \
                    t.dtype in _DTYPES:
                b.env[n] = b.const(_stored(t.item(), t.dtype), t.dtype)
            continue
        if n.op == "output":
            res = n.args[0]
            res = res[0] if isinstance(res, (tuple, list)) else res
            if not isinstance(res, torch.fx.Node) or res not in b.env:
                raise _Refuse("a result that is not a traced tensor")
            out = b.env[res]
            continue
        op = _op_name(n.target)
        val = n.meta.get("val")
        for x in n.all_input_nodes:
            if x.op == "get_attr" and x not in b.env:
                raise _Refuse(f"a captured tensor of shape "
                              f"{tuple(getattr(gm, x.target).shape)} "
                              f"(aten.{op})")
        if not isinstance(val, torch.Tensor):
            raise _Refuse(_classify(op))
        stacked = op == "stack.default" and tuple(val.shape[1:]) in \
            ((), (TRACE_E,))
        if tuple(val.shape) not in ((), (TRACE_E,)) and not stacked:
            raise _Refuse(f"aten.{op} with a result of shape "
                          f"{tuple(val.shape)} (not elementwise)")
        b.env[n] = _lower_node(b, gm, n, op, val.dtype, n.args, n.kwargs)
    ir = IR(tuple(b.nodes), out)
    for i in ir.live():
        node = ir.nodes[i]
        if node.op == "in" and node.dtype not in _DTYPES:
            raise _Refuse(f"the input {node.value!r} of dtype {node.dtype}")
    if out_dtype is not None and ir.nodes[out].dtype != out_dtype:
        raise _Refuse(f"a result of dtype {ir.nodes[out].dtype}, not "
                      f"{out_dtype}")
    return ir


# --------------------------------------------------------------------------
# evaluation on torch (the semantics the CUDA text reproduces)
# --------------------------------------------------------------------------

_TORCH_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "minimum": torch.minimum, "maximum": torch.maximum,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor, "eq": torch.eq, "ne": torch.ne,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "floordiv": torch.floor_divide,
    "remainder": torch.remainder, "fmod": torch.fmod,
    "truncdiv": lambda x, y: torch.div(x, y, rounding_mode="trunc"),
    "lshift": torch.bitwise_left_shift, "rshift": torch.bitwise_right_shift,
    "pow": torch.pow,
}
_TORCH_UNARY = {"neg": torch.neg, "abs": torch.abs,
                "bitwise_not": torch.bitwise_not,
                "logical_not": torch.logical_not, "isnan": torch.isnan,
                "isinf": torch.isinf, "isfinite": torch.isfinite,
                **{op: getattr(torch, op) for op in
                   (*_MATH.values(), *_ROUNDING.values())}}
# ops whose torch function wants tensors on both sides
_BOTH_TENSORS = ("minimum", "maximum", "lshift", "rshift")


def evaluate(ir: IR, inputs: dict):
    """Run ``ir`` as torch ops on ``inputs`` (name -> tensor; any
    broadcastable shapes, e.g. laned ``[S, L, E]`` state against ``[S, 1,
    E]`` edges).  Constants stay Python scalars, as in the program's own
    function, so torch treats them alike on every device."""
    vals: list = []
    like = next(iter(inputs.values()))
    tensor = lambda v, dt: v if isinstance(v, torch.Tensor) else \
        torch.tensor(v, dtype=dt, device=like.device)  # noqa: E731
    for n in ir.nodes:
        args = [vals[i] if i >= 0 else None for i in n.args]
        dts = [ir.nodes[i].dtype if i >= 0 else None for i in n.args]
        if n.op == "in":
            v = inputs.get(n.value)
        elif n.op == "const":
            v = n.value
        elif n.op == "cast":
            x = args[0]
            v = x.to(n.dtype) if isinstance(x, torch.Tensor) else \
                _stored(x, n.dtype)
        elif n.op == "where":
            v = torch.where(tensor(args[0], _BOOL), args[1], args[2])
        elif n.op == "clamp":
            v = torch.clamp(args[0], args[1], args[2])
        elif n.op == "pow_scalar":
            v = torch.pow(args[0], n.value)
        elif n.op == "round" and n.value:
            v = torch.round(args[0], decimals=n.value)
        elif n.op in _TORCH_BINARY:
            # the arguments are of the op's compute dtype already; torch
            # needs a tensor first (minimum/maximum/shifts: both)
            x, y = args
            if not isinstance(x, torch.Tensor) and n.op == "pow":
                v = torch.pow(x, y)             # scalar ** tensor
            else:
                x = tensor(x, dts[0])
                if n.op in _BOTH_TENSORS:
                    y = tensor(y, dts[1])
                v = _TORCH_BINARY[n.op](x, y)
        else:
            v = _TORCH_UNARY[n.op](tensor(args[0], dts[0]))
        if isinstance(v, torch.Tensor) and v.dtype != n.dtype:
            v = v.to(n.dtype)
        vals.append(v)
    res = vals[ir.out]
    return res if isinstance(res, torch.Tensor) else \
        tensor(res, ir.nodes[ir.out].dtype)


def evaluate_emit(tr: "Translation", s: dict, weight, src_gid, dst_gid):
    """The program's emit through its IR (``s``: field -> tensor)."""
    return evaluate(tr.emit, {**{f"s.{k}": v for k, v in s.items()},
                              "weight": weight, "src_gid": src_gid,
                              "dst_gid": dst_gid})


def evaluate_payload(tr: "Translation", s: dict, src_gid):
    """The program's payload through its IR, as int32 (``edge_messages``'
    cast)."""
    return evaluate(tr.payload, {**{f"s.{k}": v for k, v in s.items()},
                                 "src_gid": src_gid})


def evaluate_op(tr: "Translation", a, b):
    """The monoid's custom op through its IR."""
    return evaluate(tr.op, {"a": a, "b": b})


# --------------------------------------------------------------------------
# IR -> CUDA
# --------------------------------------------------------------------------

def _lit(value, dtype) -> str:  # analysis: allow(host-sync): a host constant's C literal
    if dtype in _FLOATS:
        bits = int(np.array(value, np.float32).view(np.uint32))
        return f"__int_as_float(0x{bits:08x})"
    if dtype == _I32:
        return f"((int)0x{value & 0xFFFFFFFF:08x}u)"
    if dtype == _I64:
        return f"((long long)0x{value & 0xFFFFFFFFFFFFFFFF:016x}ull)"
    return "true" if value else "false"


def _round(dt, x: str) -> str:
    """``x`` (a float32 expression) as an op of ``dt`` leaves it: rounded
    once to a 16-bit dtype."""
    return f"{_ROUND16[dt]}({x})" if dt in _HALF else x


def _cast_expr(x: str, src, dst) -> str:
    if dst == _BOOL:
        return f"({x} != 0.0f)" if src in _FLOATS else f"({x} != 0)"
    if src == _BOOL:
        return f"({x} ? 1.0f : 0.0f)" if dst in _FLOATS else \
            f"(({_CT[dst]}){x})"
    if dst in _FLOATS:
        if src in _FLOATS:                  # widening is exact
            return _round(dst, x) if dst != _F32 else x
        f = f"__int2float_rn({x})" if src == _I32 else f"__ll2float_rn({x})"
        return _round(dst, f)
    if src in _FLOATS:                      # cvt.rzi: NaN 0, saturated
        return f"__float2ll_rz({x})" if dst == _I64 else \
            f"__float2int_rz({x})"
    if dst == _I64:
        return f"((long long){x})"
    return f"((int)(unsigned)(unsigned long long){x})"        # i64 -> i32


_UINT = {_I32: "unsigned", _I64: "unsigned long long"}
_FLOAT_OP = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
             "div": "__fdiv_rn"}
_C_OP = {"add": "+", "sub": "-", "mul": "*", "eq": "==", "ne": "!=",
         "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "bitwise_and": "&",
         "bitwise_or": "|", "bitwise_xor": "^", "logical_and": "&&",
         "logical_or": "||", "logical_xor": "!="}
# torch's CUDA kernels: the CUDA math library's float functions
_C_MATH = {"exp": "expf", "exp2": "exp2f", "log": "logf", "log2": "log2f",
           "log10": "log10f", "log1p": "log1pf", "expm1": "expm1f",
           "sin": "sinf", "cos": "cosf", "tanh": "tanhf", "rsqrt": "rsqrtf",
           "floor": "floorf", "ceil": "ceilf", "round": "nearbyintf",
           "trunc": "truncf", "sqrt": "__fsqrt_rn"}


def _recip(c) -> str:  # analysis: allow(host-sync): a host constant's C literal
    """The float32 reciprocal torch's CUDA kernels take of a scalar
    divisor."""
    with np.errstate(divide="ignore"):
        return _lit(float(np.float32(1.0) / np.float32(c)), _F32)


def _pow_scalar(x: str, e, dt) -> str:
    """ATen's CUDA pow with a scalar exponent (``pow_tensor_scalar_kernel``):
    0.5, -0.5 and -1 go to sqrt, rsqrt and reciprocal; the exponent is
    then converted to the dtype, and 2, 3 and -2 are products."""
    if dt in _INTS:
        u = _UINT[dt]
        mul = lambda p, q: f"(({_CT[dt]})(({u}){p} * ({u}){q}))"  # noqa: E731
        if e == 2:
            return mul(x, x)
        if e == 3:
            return mul(mul(x, x), x)
        return f"gen_powi<{_CT[dt]}>({x}, {_lit(e, dt)})"
    if e == 0.5:
        return _round(dt, f"__fsqrt_rn({x})")
    if e == -0.5:
        return _round(dt, f"rsqrtf({x})")
    if e == -1:
        return _round(dt, f"__fdiv_rn(1.0f, {x})")
    e = _stored(e, dt)
    sq = _round(dt, f"__fmul_rn({x}, {x})")
    if e == 2:
        return sq
    if e == 3:
        return _round(dt, f"__fmul_rn({sq}, {x})")
    if e == -2:
        return _round(dt, f"__fdiv_rn(1.0f, {sq})")
    return _round(dt, f"powf({x}, {_lit(e, _F32)})")


def _expr(ir: IR, n: Node, a: list) -> str:  # analysis: allow(host-sync): writes C++ from host constants, once per program
    """One node as a C++ expression over its arguments' variables ``a``,
    as torch's CUDA kernel for the op computes it."""
    dt = n.dtype
    op = n.op
    arg = [ir.nodes[i] if i >= 0 else None for i in n.args]
    const_y = len(arg) > 1 and arg[1] is not None and arg[1].op == "const" \
        and arg[1].scalar
    if op == "cast":
        return _cast_expr(a[0], arg[0].dtype, dt)
    if op in ("add", "sub", "mul", "div"):
        if dt in _FLOATS:
            if op == "div" and const_y:
                # torch's CUDA division by a scalar: times its reciprocal
                return _round(dt, f"__fmul_rn({a[0]}, {_recip(arg[1].value)})")
            return _round(dt, f"{_FLOAT_OP[op]}({a[0]}, {a[1]})")
        u = _UINT[dt]
        return f"(({_CT[dt]})(({u}){a[0]} {_C_OP[op]} ({u}){a[1]}))"
    if op in ("eq", "ne", "lt", "le", "gt", "ge", "logical_and",
              "logical_or", "logical_xor"):
        return f"({a[0]} {_C_OP[op]} {a[1]})"
    if op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return f"(({_CT[dt]})({a[0]} {_C_OP[op]} {a[1]}))"
    if op == "bitwise_not":
        return f"(!{a[0]})" if dt == _BOOL else f"(~{a[0]})"
    if op == "logical_not":
        return f"(!{a[0]})"
    if op in ("minimum", "maximum"):
        if dt == _BOOL:
            return f"({a[0]} {'&&' if op == 'minimum' else '||'} {a[1]})"
        if dt in _FLOATS:
            f = "fminf" if op == "minimum" else "fmaxf"
            return _round(dt, f"({a[0]} != {a[0]} ? {a[0]} : ({a[1]} != "
                              f"{a[1]} ? {a[1]} : {f}({a[0]}, {a[1]})))")
        return f"{'min' if op == 'minimum' else 'max'}({a[0]}, {a[1]})"
    if op == "clamp":
        x, lo, hi = a
        fl = dt in _FLOATS
        fmin, fmax = ("fminf", "fmaxf") if fl else ("min", "max")
        v = x if lo is None else f"{fmax}({x}, {lo})"
        v = v if hi is None else f"{fmin}({v}, {hi})"
        return f"({x} != {x} ? {x} : {_round(dt, v)})" if fl else v
    if op == "where":
        return _round(dt, f"({a[0]} ? {a[1]} : {a[2]})")
    if op == "neg":
        if dt in _FLOATS:
            return f"(-{a[0]})"
        return f"(({_CT[dt]})(({_UINT[dt]})0 - ({_UINT[dt]}){a[0]}))"
    if op == "abs":
        if dt in _FLOATS:
            return f"fabsf({a[0]})"
        return (f"({a[0]} < 0 ? ({_CT[dt]})(({_UINT[dt]})0 - "
                f"({_UINT[dt]}){a[0]}) : {a[0]})")
    if op == "round" and n.value:
        # ATen's round_decimals, in the dtype's own arithmetic: times (or
        # over) 10^|d| at the dtype, rounded, then nearbyint
        p = _lit(_stored(10.0 ** abs(n.value), dt), _F32)
        mul, div = ("__fmul_rn", "__fdiv_rn") if n.value > 0 else \
            ("__fdiv_rn", "__fmul_rn")
        scaled = _round(dt, f"{mul}({a[0]}, {p})")
        return _round(dt, f"{div}(nearbyintf({scaled}), {p})")
    if op in _C_MATH:
        return _round(dt, f"{_C_MATH[op]}({a[0]})")
    if op == "sigmoid":
        return _round(dt, f"__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-{a[0]})))")
    if op == "reciprocal":
        return _round(dt, f"__fdiv_rn(1.0f, {a[0]})")
    if op == "sign":
        return _round(dt, f"(float)((0.0f < {a[0]}) - ({a[0]} < 0.0f))")
    if op in ("isnan", "isinf", "isfinite"):
        x = a[0]
        return {"isnan": f"({x} != {x})",
                "isinf": f"(fabsf({x}) == __int_as_float(0x7f800000))",
                "isfinite": f"(fabsf({x}) < __int_as_float(0x7f800000))"}[op]
    if op == "pow_scalar":
        return _pow_scalar(a[0], n.value, dt)
    if op == "pow":
        if dt in _INTS:
            return f"gen_powi<{_CT[dt]}>({a[0]}, {a[1]})"
        return _round(dt, f"powf({a[0]}, {a[1]})")
    if op in ("floordiv", "truncdiv", "remainder", "fmod"):
        if dt in _INTS:
            return f"gen_{op}_i<{_CT[dt]}>({a[0]}, {a[1]})"
        if op in ("floordiv", "truncdiv") and const_y:
            # the scalar-divisor path: times its float32 reciprocal
            c = arg[1].value
            if op == "floordiv" and c == 0:     # torch: the true division
                return _round(dt, f"__fmul_rn({a[0]}, {_recip(c)})")
            if op == "truncdiv":
                return _round(dt, f"truncf(__fmul_rn({a[0]}, {_recip(c)}))")
            if dt in _HALF:
                return (f"gen_floordiv_16s<{_ROUND16[dt]}>({a[0]}, {a[1]}, "
                        f"{_recip(c)})")
            return f"gen_floordiv_fs({a[0]}, {a[1]}, {_recip(c)})"
        if dt in _HALF:
            # scalar_t arithmetic: a CPU scalar rounded to the dtype, the
            # quotient rounded before it is truncated or floored
            x, y = (_lit(_stored(m.value, dt), _F32)
                    if m.op == "const" and m.scalar else v
                    for m, v in zip(arg, a))
            r = _ROUND16[dt]
            if op == "floordiv":
                return f"gen_floordiv_16<{r}>({x}, {y})"
            if op == "truncdiv":
                return f"{r}(truncf({r}(__fdiv_rn({x}, {y}))))"
            return f"{r}(gen_{op}_f({x}, {y}))"
        return f"gen_{op}_f({a[0]}, {a[1]})"
    if op in ("lshift", "rshift"):
        return f"gen_{op}<{_CT[dt]}>({a[0]}, {a[1]})"
    raise AssertionError(op)


def _code(ir: IR, bind: dict, prefix: str, roots=None, given=None):  # analysis: allow(host-loop): writes C++ over IR nodes, once per program
    """Statements computing the nodes ``roots`` (default the result; inputs
    bound to C++ expressions by name, the nodes in ``given`` by index) and
    the variables that hold each computed node."""
    given = given or {}
    lines, var = [], dict(given)
    for i in sorted(ir.live(roots, stop=set(given))):
        if i in given:
            continue
        n = ir.nodes[i]
        v = f"{prefix}{i}"
        if n.op == "in":
            expr = bind[n.value]
        elif n.op == "const":
            expr = _lit(n.value, n.dtype)
        else:
            expr = _expr(ir, n, [None if j < 0 else var[j] for j in n.args])
        lines.append(f"  const {_CT[n.dtype]} {v} = {expr};")
        var[i] = v
    return lines, var


def _read_word(dt, k: int) -> str:
    if dt in _FLOATS:
        return f"__int_as_float(rec[{k}])"
    if dt == _BOOL:
        return f"(rec[{k}] != 0)"
    if dt == _I64:
        return (f"((long long)(((unsigned long long)(unsigned)rec[{k + 1}] "
                f"<< 32) | (unsigned)rec[{k}]))")
    return f"rec[{k}]"


def _write_word(dt, k: int, x: str) -> list:
    if dt in _FLOATS:
        return [f"  rec[{k}] = __float_as_int({x});"]
    if dt == _I64:
        return [f"  rec[{k}] = (int)(unsigned)(unsigned long long){x};",
                f"  rec[{k + 1}] = (int)(unsigned)((unsigned long long){x}"
                f" >> 32);"]
    return [f"  rec[{k}] = (int){x};"]


def _load_field(dt, i: int) -> str:
    """State field ``i`` of gen::pack's pointer array at ``at``, as its C
    value (a 16-bit float widened)."""
    if dt == _BF16:
        return (f"__uint_as_float((unsigned)static_cast<const unsigned short*>"
                f"(p.f[{i}])[at] << 16)")
    if dt == _F16:
        return (f"__half2float(__ushort_as_half(static_cast<const unsigned "
                f"short*>(p.f[{i}])[at]))")
    return f"static_cast<const {_CT[dt]}*>(p.f[{i}])[at]"


@dataclasses.dataclass(frozen=True, eq=False)
class Translation:
    """A program's functions as the generic kernels compute them.

    ``error`` is the refusal (``header`` is then None); otherwise
    ``header`` is the generated CUDA text and ``key`` its hash, which names
    the libraries built from it.  ``fields`` are the state fields the
    packing prologue reads, in the order of its pointer array; each
    source vertex (and lane) packs ``words`` 32-bit words: the values
    emit's edge-dependent part reads (its nodes that depend only on the
    source computed once per vertex) and the payload at ``pay_word``.
    """

    program: str
    msg_dtype: torch.dtype
    kind: str
    error: str | None = None
    header: str | None = None
    key: str = ""
    emit: IR | None = None
    payload: IR | None = None
    op: IR | None = None
    ident: Any = None
    fields: tuple = ()
    words: int = 0
    pay_word: int = -1
    reads_weight: bool = False
    reads_dst_gid: bool = False
    has_emit: bool = True

    def require(self) -> "Translation":
        """Self, or raise the recorded refusal."""
        if self.error is not None:
            raise GenericEmitError(self.error)
        return self

    @property
    def k1_record(self) -> int:
        """Ints per vertex record in K1: the words and the senders flag,
        rounded up to 2, 4, or a multiple of 8 (one 8- or 16-byte load, or
        whole 32-byte sectors)."""
        return _k1_record(self.words)

    @property
    def k2_group(self) -> int:
        """Lanes per K2 record: at most 4, 2 with a payload (its per-lane
        staging rows), as many as fit :data:`MAX_WORDS` words; a record
        wider than that holds one lane."""
        return _k2_group(self.words, self.pay_word >= 0)

    @property
    def k2_record(self) -> int:
        """Ints per K2 record: 8 (one sector: the group's words and the
        senders bits), or the words of one lane and the bits rounded up to
        whole sectors."""
        return _k2_record(self.words)


def _k1_record(words: int) -> int:
    need = words + 1
    return 2 if need <= 2 else 4 if need <= 4 else 8 * -(-need // 8)


def _k2_group(words: int, pay: bool) -> int:
    if words > MAX_WORDS:
        return 1
    return max(1, min(2 if pay else 4, MAX_WORDS // max(words, 1)))


def _k2_record(words: int) -> int:
    return 8 if words <= MAX_WORDS else 8 * -(-(words + 1) // 8)


_KINDS = {"min": 0, "max": 1, "sum": 2}
_STORE = {_BF16: ("unsigned short",
                  "(unsigned short)(__float_as_uint(v) >> 16)",
                  "__uint_as_float((unsigned)v << 16)"),
          _F16: ("unsigned short", "__half_as_ushort(__float2half_rn(v))",
                 "__half2float(__ushort_as_half(v))")}

# Device helpers of the generated text: torch's CUDA formulas for the
# 16-bit rounding, the division family, integer pow and the shifts
# (c10/util/generic_math.h, ATen/native/Pow.h, ATen's binary kernels).
_HELPERS = r"""
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rhf(float x) {
  return __half2float(__float2half_rn(x));
}
// c10::div_floor_floating
__device__ __forceinline__ float gen_floordiv_f(float a, float b) {
  if (b == 0.0f) return __fdiv_rn(a, b);
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float fd = floorf(div);
  if (__fsub_rn(div, fd) > 0.5f) fd = __fadd_rn(fd, 1.0f);
  return fd;
}
// the same with a CPU-scalar divisor b != 0: times its reciprocal
__device__ __forceinline__ float gen_floordiv_fs(float a, float b, float inv_b) {
  const float mod = fmodf(a, b);
  float div = __fmul_rn(__fsub_rn(a, mod), inv_b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fmul_rn(a, inv_b));
  float fd = floorf(div);
  if (__fsub_rn(div, fd) > 0.5f) fd = __fadd_rn(fd, 1.0f);
  return fd;
}
// the same over float16/bfloat16 values (R rounds to the dtype), as
// c10::div_floor_floating computes on c10::Half/BFloat16: the remainder
// and quotient in float32, the floors rounded to the dtype
template <float (*R)(float)>
__device__ __forceinline__ float gen_floordiv_16(float a, float b) {
  if (b == 0.0f) return R(__fdiv_rn(a, b));
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float fd = R(floorf(div));
  if (__fsub_rn(div, fd) > 0.5f) fd = R(__fadd_rn(fd, 1.0f));
  return fd;
}
// and with a CPU-scalar divisor b != 0 (float32, not rounded)
template <float (*R)(float)>
__device__ __forceinline__ float gen_floordiv_16s(float a, float b, float inv_b) {
  const float mod = fmodf(a, b);
  float div = __fmul_rn(__fsub_rn(a, mod), inv_b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fmul_rn(a, inv_b));
  float fd = R(floorf(div));
  if (__fsub_rn(div, fd) > 0.5f) fd = R(__fadd_rn(fd, 1.0f));
  return fd;
}
__device__ __forceinline__ float gen_truncdiv_f(float a, float b) {
  return truncf(__fdiv_rn(a, b));
}
__device__ __forceinline__ float gen_remainder_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) mod = __fadd_rn(mod, b);
  return mod;
}
__device__ __forceinline__ float gen_fmod_f(float a, float b) {
  return fmodf(a, b);
}
// Integer division and remainder as torch's CUDA kernels give them on
// sm_90, the cases C leaves undefined included (chip_emit_ops.py holds
// them to torch): a quotient or remainder by zero is -1 for int32, and for
// int64 -1 from a negative dividend and 2^32 - 1 from any other (so a
// floor division of a negative by zero is -2); the minimum over -1 is the
// minimum, remainder 0.
template <typename T>
__device__ __forceinline__ T gen_div0(T a) {
  return sizeof(T) == 4 || a < 0 ? T(-1) : T(0xffffffffll);
}
template <typename T>
__device__ __forceinline__ T gen_truncdiv_i(T a, T b) {
  if (b == 0) return gen_div0(a);
  if (b == T(-1)) return (T)((typename std::make_unsigned<T>::type)0 -
                             (typename std::make_unsigned<T>::type)a);
  return a / b;
}
template <typename T>
__device__ __forceinline__ T gen_fmod_i(T a, T b) {
  if (b == 0) return gen_div0(a);
  if (b == T(-1)) return T(0);
  return a % b;
}
template <typename T>
__device__ __forceinline__ T gen_remainder_i(T a, T b) {
  T r = gen_fmod_i(a, b);
  if (r != 0 && (r < 0) != (b < 0)) r += b;
  return r;
}
// c10::div_floor_integer
template <typename T>
__device__ __forceinline__ T gen_floordiv_i(T a, T b) {
  if ((a < 0) != (b < 0)) {
    const T quot = gen_truncdiv_i(a, b);
    const T rem = gen_fmod_i(a, b);
    return rem ? quot - 1 : quot;
  }
  return gen_truncdiv_i(a, b);
}
// at::native::powi
template <typename T>
__device__ __forceinline__ T gen_powi(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  if (b < 0) {
    if (a == 1) return 1;
    if (a == -1) return ((-b) % 2) ? -1 : 1;
    return 0;
  }
  U result = 1, base = (U)a;
  while (b) {
    if (b & 1) result *= base;
    b /= 2;
    base *= base;
  }
  return (T)result;
}
template <typename T>
__device__ __forceinline__ T gen_lshift(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  if (b < 0 || b >= (T)(sizeof(T) * 8)) return 0;
  return (T)((U)a << b);
}
template <typename T>
__device__ __forceinline__ T gen_rshift(T a, T b) {
  constexpr T kMax = sizeof(T) * 8 - 1;
  if (b < 0 || b >= kMax) return a >> kMax;
  return a >> b;
}
"""


def _head(tr, has_emit: bool, native_ident: bool, pay: bool) -> list:
    # the text names no program: programs that compute the same functions
    # share one header and so one set of libraries
    msg = tr["msg"]
    store, to_s, from_s = _STORE.get(msg, (_CT[msg], "v", "v"))
    return [
        "// Generated by repro_torch/kernels/edge_relax/emitgen.py (the",
        "// generic instance of the edge_relax kernels includes it).",
        "#pragma once",
        "#include <cuda_bf16.h>",
        "#include <cuda_fp16.h>",
        "#include <type_traits>",
        f"#define REPRO_GEN_HAS_EMIT {int(has_emit)}",
        "namespace {",
        "// the state fields gen::pack reads, in emitgen's pointer order",
        f"constexpr int kGenFields = {max(1, tr['n_fields'])};",
        "struct GenPtrs {",
        "  const void* f[kGenFields];",
        "};",
        "namespace gen {",
        f"using Msg = {_CT[msg]};        // the kernels' working type",
        f"using Store = {store};  // the message tensors' element",
        "__device__ __forceinline__ Store to_store(Msg v) { return "
        f"{to_s}; }}",
        "__device__ __forceinline__ Msg from_store(Store v) { return "
        f"{from_s}; }}",
        f"constexpr int kKind = {_KINDS[tr['kind']]};",
        f"constexpr bool kNativeIdent = "
        f"{'true' if native_ident else 'false'};",
        f"constexpr bool kPay = {'true' if pay else 'false'};",
        f"constexpr int kWords = {tr['words']};",
        f"constexpr int kPayWord = {tr['pay_word']};",
        f"constexpr int kRecK1 = {_k1_record(tr['words'])};",
        f"constexpr int kGroupK2 = {_k2_group(tr['words'], pay)};",
        f"constexpr int kRecK2 = {_k2_record(tr['words'])};",
        f"constexpr bool kReadsWeight = "
        f"{'true' if tr['reads_weight'] else 'false'};",
        f"constexpr bool kReadsDstGid = "
        f"{'true' if tr['reads_dst_gid'] else 'false'};",
        _HELPERS,
        "// the monoid's identity (masks non-sending edges)",
        "__device__ __forceinline__ Msg ident() { return "
        f"{_lit(tr['ident'], msg)}; }}",
    ]


def _op_fn(op_ir: IR | None, msg, kind: str) -> list:
    out = ["// the monoid's combine",
           "__device__ __forceinline__ Msg op(Msg a, Msg b) {"]
    if op_ir is None:
        if msg in _HALF and kind == "sum":      # torch: one rounding
            return out + [f"  return {_round(msg, '__fadd_rn(a, b)')};", "}"]
        return out + ["  return Combine<Msg, kKind>::op(a, b);", "}"]
    lines, var = _code(op_ir, {"a": "a", "b": "b"}, "o")
    return out + lines + [f"  return {var[op_ir.out]};", "}"]


def _refusal(program, component, what) -> str:
    return (f"program {program or '<unnamed>'!r}: {component}: {what} is "
            f"outside the op set of the generic CUDA kernels "
            f"(kernels/edge_relax/emitgen.py); the program runs on the CPU "
            f"only")


def _component_ir(traced: Traced, out_dtype=None):
    if traced.error is not None:
        what = ("Python control flow on a traced value" if
                traced.data_dependent else
                f"a function whose trace failed "
                f"({type(traced.error).__name__}: {traced.error})")
        raise _Refuse(what)
    return _to_ir(traced, out_dtype)


def _hoisted(ir: IR) -> list:  # analysis: allow(host-loop): walks IR nodes, once per program
    """The nodes of ``emit`` computed once per source vertex: those that
    depend only on the state fields, ``src_gid`` and constants and that
    the edge-dependent part (or the result) reads, in node order."""
    vert = {}
    for i, n in enumerate(ir.nodes):
        if n.op == "in":
            vert[i] = n.value.startswith("s.") or n.value == "src_gid"
        else:
            vert[i] = all(vert[j] for j in n.args if j >= 0)
    live = ir.live()
    read = {ir.out} if vert[ir.out] else set()
    for j in live:
        if not vert[j]:
            read.update(i for i in ir.nodes[j].args if i >= 0 and vert[i])
    return sorted(i for i in read if ir.nodes[i].op != "const")


def translate(program: str, fields, msg_dtype, monoid, traces: dict,
              with_payload: bool) -> Translation:  # analysis: allow(host-sync): host constants of a translation, once per program
    """A program's :class:`Translation` from its traces
    (:func:`trace_program`); a refusal is recorded, not raised."""
    kind = monoid.kind
    base = dict(program=program, msg_dtype=msg_dtype, kind=kind)
    component = "emit"
    try:
        if msg_dtype not in _DTYPES or msg_dtype == _BOOL:
            raise _Refuse(f"a message dtype of {msg_dtype}")
        emit_ir = _component_ir(traces["emit"], msg_dtype)
        pay_ir = None
        if with_payload:
            component = "payload"
            pay_ir = _component_ir(traces["payload"])
            if pay_ir.nodes[pay_ir.out].dtype != _I32:  # edge_messages' cast
                nodes = pay_ir.nodes + (Node("cast", _I32, (pay_ir.out,)),)
                pay_ir = IR(nodes, len(nodes) - 1)
        component = "monoid"
        op_ir = None
        if monoid.op is not None:
            op_ir = _component_ir(traces["monoid"], msg_dtype)
        ident = _stored(monoid.identity(msg_dtype), msg_dtype)
        component = "record"
        schema = dict(fields)
        slots = _hoisted(emit_ir)
        reads = emit_ir.inputs()
        vert_fields = {emit_ir.nodes[i].value for i in emit_ir.live(slots)
                       if emit_ir.nodes[i].op == "in"}
        if pay_ir is not None:
            vert_fields |= pay_ir.inputs()
        ptr_fields = [k for k, _ in fields if f"s.{k}" in vert_fields]
        for k in ptr_fields:
            if schema[k].dtype not in _DTYPES:
                raise _Refuse(f"the field {k!r} of dtype "
                              f"{schema[k].dtype}")
        offset, words = 0, {}
        for i in slots:
            words[i] = offset
            offset += _WORDS[emit_ir.nodes[i].dtype]
        pay_word = -1
        if pay_ir is not None:
            pay_word = offset
            offset += 1
    except _Refuse as e:
        return Translation(**base, error=_refusal(program, component, e))
    custom_ident = monoid.identity_of is not None
    native_ident = not custom_ident or ident == _stored(
        _native_identity(kind, msg_dtype), msg_dtype)
    info = dict(msg=msg_dtype, kind=kind, words=offset, pay_word=pay_word,
                reads_weight="weight" in reads,
                reads_dst_gid="dst_gid" in reads, ident=ident,
                n_fields=len(ptr_fields))
    text = _head(info, True, native_ident, pay_ir is not None)
    text += [""] + _op_fn(op_ir, msg_dtype, kind)
    # pack: the record of the source vertex (and lane) at `at`
    pack = ["", "// the record of the source vertex (and lane) at `at`",
            "__device__ __forceinline__ void pack(const GenPtrs& p, "
            "long long at, int gid, int* rec) {",
            "  (void)p; (void)at; (void)gid;"]
    bind = {"src_gid": "gid"}
    for i, k in enumerate(ptr_fields):
        dt = schema[k].dtype
        pack.append(f"  const {_CT[dt]} f{i} = {_load_field(dt, i)};")
        bind[f"s.{k}"] = f"f{i}"
    lines, var = _code(emit_ir, bind, "h", roots=slots)
    pack += lines
    for i in slots:
        pack += _write_word(emit_ir.nodes[i].dtype, words[i], var[i])
    if pay_ir is not None:
        lines, pvar = _code(pay_ir, bind, "q")
        pack += lines + [f"  rec[{pay_word}] = {pvar[pay_ir.out]};"]
    pack.append("}")
    # emit: the message of an edge from its source's record
    emit = ["", "// the message of an edge from its source's record",
            "__device__ __forceinline__ Msg emit(const int* rec, "
            "float weight, int dst_gid) {",
            "  (void)rec; (void)weight; (void)dst_gid;"]
    given = {i: _read_word(emit_ir.nodes[i].dtype, words[i]) for i in slots}
    lines, var = _code(emit_ir, {"weight": "weight", "dst_gid": "dst_gid"},
                       "e", given=given)
    emit += lines + [f"  return {var[emit_ir.out]};", "}"]
    header = "\n".join(text + pack + emit +
                       ["}  // namespace gen", "}  // namespace", ""])
    return Translation(
        **base, header=header,
        key=hashlib.sha256(header.encode()).hexdigest()[:16], emit=emit_ir,
        payload=pay_ir, op=op_ir, ident=ident,
        fields=tuple((k, schema[k].dtype) for k in ptr_fields),
        words=offset, pay_word=pay_word, reads_weight=info["reads_weight"],
        reads_dst_gid=info["reads_dst_gid"])


def _native_identity(kind: str, dtype):
    if kind == "sum":
        return 0
    big = float("inf") if dtype in _FLOATS else torch.iinfo(dtype).max
    return big if kind == "min" else -big


_MONOIDS: dict = {}


def translate_monoid(monoid, msg_dtype) -> Translation:
    """The combine alone (no emit) of a monoid with a custom op or
    identity, or of any monoid over 16-bit messages, for K2's pre-emitted
    mode; cached per (monoid, dtype)."""
    key = (monoid, msg_dtype)
    if key not in _MONOIDS:
        base = dict(program=f"monoid {monoid.name}", msg_dtype=msg_dtype,
                    kind=monoid.kind)
        try:
            if msg_dtype not in _DTYPES or msg_dtype == _BOOL:
                raise _Refuse(f"a message dtype of {msg_dtype}")
            op_ir = None
            if monoid.op is not None:
                op_ir = _component_ir(
                    _trace("monoid", monoid.op, (("a", msg_dtype),
                                                 ("b", msg_dtype))),
                    msg_dtype)
            ident = _stored(monoid.identity(msg_dtype), msg_dtype)
        except _Refuse as e:
            tr = Translation(**base, error=_refusal(
                f"monoid {monoid.name}", "monoid", e))
        else:
            native = monoid.identity_of is None or ident == _stored(
                _native_identity(monoid.kind, msg_dtype), msg_dtype)
            info = dict(msg=msg_dtype, kind=monoid.kind, words=0,
                        pay_word=-1, reads_weight=False,
                        reads_dst_gid=False, ident=ident, n_fields=0)
            text = _head(info, False, native, False)
            header = "\n".join(text + [""] + _op_fn(
                op_ir, msg_dtype, monoid.kind) + [
                "",
                "// no emit: K2's pre-emitted mode only",
                "__device__ __forceinline__ void pack(const GenPtrs&, "
                "long long, int, int*) {}",
                "__device__ __forceinline__ Msg emit(const int*, float, "
                "int) { return ident(); }",
                "}  // namespace gen", "}  // namespace", ""])
            tr = Translation(
                **base, header=header,
                key=hashlib.sha256(header.encode()).hexdigest()[:16],
                op=op_ir, ident=ident, has_emit=False)
        _MONOIDS[key] = tr
    return _MONOIDS[key]
