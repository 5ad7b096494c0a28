"""Generic emits: a program's own ``emit``, ``payload`` and custom monoid
``op`` traced into the CUDA relaxation kernels.

The counterpart of Pallas tracing ``prog.emit`` and ``prog.payload`` into
the TPU kernels' bodies (``repro/kernels/edge_relax/kernel.py`` ``_kernel``
and ``_scan_kernel``).  At :func:`~repro_torch.core.programs.lower` each
function is traced once with
``make_fx(tracing_mode="fake")`` on ``[E]`` fake tensors of the declared
dtypes (:func:`trace_program`; the program verifier reads the same trace),
and the graph becomes a small elementwise IR (:class:`IR`) in which every
type promotion is an explicit cast and every constant has its op's dtype.
:func:`translate` writes the IR as CUDA device functions into one header
(:attr:`Translation.header`); the kernels' generic instance
(``EMIT == kGeneric``, ``csrc/edge_relax_emit.cuh``) includes it, and
``kernel.py`` builds one set of libraries per distinct header text.

The op set (anything else is refused):

* add, sub (and ``c - x``), mul, true div, neg, abs, sqrt;
* minimum, maximum, clamp / clamp_min / clamp_max with constant bounds;
* where, the six comparisons, logical and/or/xor/not, bitwise
  and/or/xor/not;
* dtype casts (``_to_copy``) and constants (Python scalars, scalars
  created inside the function);

over float32, int32, int64 and bool values.  Refused, with an error that
names the program, the component and the op: reductions, indexing, a
captured tensor, Python control flow on a traced value, exp/log/pow and
every op outside the set, float16/bfloat16 values, and casts from float
to int (undefined in C out of range).  A refusal is recorded on the
lowered program (:attr:`Translation.error`): the CPU path still calls the
program's functions itself, and a CUDA launch raises it
(:class:`GenericEmitError`).  There is no fallback.

Semantics.  :func:`evaluate` runs the IR as torch ops on the inputs'
device, so on the CPU it is bitwise the program's own function; the CUDA
text reproduces torch's CUDA kernels op by op, so on the card the generic
kernels are bitwise their plain versions: every float op rounds on its
own (``__fadd_rn`` & co., no FMA contraction), subnormals are kept,
minimum/maximum/clamp propagate NaN, integers wrap, and a division by a
constant multiplies by the float32 reciprocal of the constant, as torch's
CUDA division by a scalar does (torch on the CPU divides).

Records.  The values an edge's message needs from its source — the fields
``emit`` reads (an int64 field takes two 32-bit words), ``src_gid`` if
read, and the payload, which depends only on the source and is computed
once per vertex — are packed into :data:`MAX_WORDS` = 7 words at most per
vertex (and lane); a program that needs more is refused.  ``weight`` and
``dst_gid`` come from the edge streams (``dst_gid`` only when read).
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

MAX_WORDS = 7          # 32-bit record words per source vertex (and lane)
TRACE_E = 16           # the traced edge count (the verifier's geometry)

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
_DTYPES = (_F32, _I32, _I64, _BOOL)
_CT = {_F32: "float", _I32: "int", _I64: "long long", _BOOL: "bool"}
_WORDS = {_F32: 1, _I32: 1, _I64: 2, _BOOL: 1}


class GenericEmitError(ValueError):
    """A program whose functions the generic CUDA kernels cannot compute;
    the message names the program, the component and the op."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR value.  ``op`` is ``"in"`` (``value`` names the input:
    ``s.<field>``, ``weight``, ``src_gid``, ``dst_gid``, ``a``, ``b``),
    ``"const"`` (``value`` a Python scalar of ``dtype``), ``"cast"``, or an
    op of the set whose ``args`` are node indices already of the op's
    compute dtype (``clamp``: ``-1`` for an absent bound)."""

    op: str
    dtype: torch.dtype
    args: tuple = ()
    value: Any = None


@dataclasses.dataclass(frozen=True)
class IR:
    """An elementwise function as nodes in evaluation order; ``out`` is
    the result's index."""

    nodes: tuple
    out: int

    def live(self) -> set:
        """Indices of the nodes the result depends on."""
        seen, todo = set(), [self.out]
        while todo:
            i = todo.pop()
            if i < 0 or i in seen:
                continue
            seen.add(i)
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
_UNARY = {"neg.default": "neg", "abs.default": "abs", "sqrt.default": "sqrt",
          "bitwise_not.default": "bitwise_not",
          "logical_not.default": "logical_not"}
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


def _scalar(value, dtype):  # analysis: allow(host-sync): host scalars of a translation, made once per program
    """A Python scalar as the value of ``dtype`` (floats rounded to
    float32 as torch rounds a scalar in a float32 op)."""
    if dtype == _F32:
        return float(np.float32(value))
    if dtype == _BOOL:
        return bool(value)
    if isinstance(value, float) and not float(value).is_integer():
        raise _Refuse(f"the float constant {value!r} in an integer op")
    v = int(value)
    info = torch.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise _Refuse(f"the constant {value!r} outside {dtype}")
    return v


class _Lowering:
    def __init__(self):
        self.nodes, self.env = [], {}

    def add(self, node: Node) -> int:
        if node.op != "in" and node.dtype not in _DTYPES:
            what = ("float16/bfloat16 values" if node.dtype in
                    (torch.float16, torch.bfloat16) else
                    f"{node.dtype} values")
            raise _Refuse(what)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def const(self, value, dtype) -> int:
        return self.add(Node("const", dtype, value=_scalar(value, dtype)))

    def cast(self, i: int, dtype) -> int:
        n = self.nodes[i]
        if n.dtype == dtype:
            return i
        if n.op == "const":
            return self.const(n.value, dtype)
        if n.dtype == _F32 and dtype in (_I32, _I64):
            raise _Refuse(f"a cast from float32 to {dtype} (undefined out "
                          f"of range)")
        return self.add(Node("cast", dtype, (i,)))

    def arg(self, a, dtype) -> int:
        """An op argument as a node of ``dtype``: a graph node (cast) or a
        Python scalar (a constant)."""
        if isinstance(a, torch.fx.Node):
            i = self.env.get(a)
            if i is None:
                raise _Refuse("a captured tensor")
            return self.cast(i, dtype)
        if isinstance(a, (bool, int, float)):
            return self.const(a, dtype)
        raise _Refuse(f"the argument {a!r}")

    @staticmethod
    def val(a):
        return a.meta["val"] if isinstance(a, torch.fx.Node) else a


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
            continue                        # only through lift_fresh_copy
        if n.op == "output":
            res = n.args[0]
            res = res[0] if isinstance(res, (tuple, list)) else res
            if not isinstance(res, torch.fx.Node) or res not in b.env:
                raise _Refuse("a result that is not a traced tensor")
            out = b.env[res]
            continue
        op = _op_name(n.target)
        val = n.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise _Refuse(_classify(op))
        if tuple(val.shape) not in ((), (TRACE_E,)):
            raise _Refuse(f"aten.{op} with a result of shape "
                          f"{tuple(val.shape)} (not elementwise)")
        dt = val.dtype
        a, kw = n.args, n.kwargs
        if op == "lift_fresh_copy.default":
            t = getattr(gm, a[0].target)
            if t.ndim != 0:
                raise _Refuse("a captured tensor")
            b.env[n] = b.const(t.item(), dt)
        elif op == "scalar_tensor.default":
            b.env[n] = b.const(a[0], dt)
        elif op == "_to_copy.default":
            if set(kw) - {"dtype", "layout", "device"}:
                raise _Refuse(f"aten.{op} with {sorted(kw)}")
            b.env[n] = b.cast(b.arg(a[0], b.val(a[0]).dtype), dt)
        elif op in _BINARY or op == "rsub.Scalar":
            if kw.get("alpha", 1) != 1 or "rounding_mode" in kw:
                raise _Refuse(f"aten.{op} with {dict(kw)}")
            if dt == _BOOL and op.split(".")[0] in ("add", "sub", "mul",
                                                    "div", "rsub"):
                raise _Refuse(f"aten.{op} on bool values")
            name = "sub" if op == "rsub.Scalar" else _BINARY[op]
            x, y = (a[1], a[0]) if op == "rsub.Scalar" else (a[0], a[1])
            b.env[n] = b.add(Node(name, dt, (b.arg(x, dt), b.arg(y, dt))))
        elif op in _COMPARE:
            ct = torch.result_type(b.val(a[0]), b.val(a[1]))
            b.env[n] = b.add(Node(_COMPARE[op], _BOOL,
                                  (b.arg(a[0], ct), b.arg(a[1], ct))))
        elif op in _LOGICAL:
            b.env[n] = b.add(Node(_LOGICAL[op], _BOOL,
                                  (b.arg(a[0], _BOOL), b.arg(a[1], _BOOL))))
        elif op in _UNARY:
            ct = _BOOL if op == "logical_not.default" else dt
            if dt == _BOOL and op in ("neg.default", "abs.default"):
                raise _Refuse(f"aten.{op} on bool values")
            b.env[n] = b.add(Node(_UNARY[op], dt, (b.arg(a[0], ct),)))
        elif op in ("clamp.default", "clamp_min.default",
                    "clamp_max.default"):
            lo = a[1] if len(a) > 1 else kw.get("min")
            hi = a[2] if len(a) > 2 else kw.get("max")
            if op == "clamp_max.default":
                lo, hi = None, a[1]
            if isinstance(lo, torch.fx.Node) or isinstance(hi, torch.fx.Node):
                raise _Refuse(f"aten.{op} with tensor bounds")
            bound = lambda v: -1 if v is None else b.const(v, dt)  # noqa: E731
            b.env[n] = b.add(Node("clamp", dt, (b.arg(a[0], dt), bound(lo),
                                                bound(hi))))
        elif op == "where.self":
            b.env[n] = b.add(Node("where", dt, (b.arg(a[0], _BOOL),
                                                b.arg(a[1], dt),
                                                b.arg(a[2], dt))))
        else:
            raise _Refuse(_classify(op))
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
    "logical_xor": torch.logical_xor,
}
_TORCH_UNARY = {"neg": torch.neg, "abs": torch.abs, "sqrt": torch.sqrt,
                "bitwise_not": torch.bitwise_not,
                "logical_not": torch.logical_not}


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
        if n.op == "in":
            v = inputs.get(n.value)
        elif n.op == "const":
            v = n.value
        elif n.op == "cast":
            x = args[0]
            v = x.to(n.dtype) if isinstance(x, torch.Tensor) else \
                _scalar(x, n.dtype)
        elif n.op == "where":
            v = torch.where(tensor(args[0], _BOOL), args[1], args[2])
        elif n.op == "clamp":
            v = torch.clamp(args[0], args[1], args[2])
        elif n.op in _TORCH_BINARY:
            # the arguments are of the op's compute dtype already; torch
            # needs a tensor first (minimum/maximum: both)
            x, y = args
            x = tensor(x, ir.nodes[n.args[0]].dtype)
            if n.op in ("minimum", "maximum"):
                y = tensor(y, ir.nodes[n.args[1]].dtype)
            v = _TORCH_BINARY[n.op](x, y)
        else:
            v = _TORCH_UNARY[n.op](tensor(args[0], ir.nodes[n.args[0]].dtype))
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
    if dtype == _F32:
        bits = int(np.array(value, np.float32).view(np.uint32))
        return f"__int_as_float(0x{bits:08x})"
    if dtype == _I32:
        return f"((int)0x{value & 0xFFFFFFFF:08x}u)"
    if dtype == _I64:
        return f"((long long)0x{value & 0xFFFFFFFFFFFFFFFF:016x}ull)"
    return "true" if value else "false"


def _cast_expr(x: str, src, dst) -> str:
    if dst == _BOOL:
        return f"({x} != 0.0f)" if src == _F32 else f"({x} != 0)"
    if src == _BOOL:
        return f"({x} ? 1.0f : 0.0f)" if dst == _F32 else \
            f"(({_CT[dst]}){x})"
    if dst == _F32:
        return f"__int2float_rn({x})" if src == _I32 else \
            f"__ll2float_rn({x})"
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


def _expr(ir: IR, n: Node, a: list) -> str:
    """One node as a C++ expression over its arguments' variables ``a``,
    as torch's CUDA kernel for the op computes it."""
    dt = n.dtype
    op = n.op
    if op == "cast":
        return _cast_expr(a[0], ir.nodes[n.args[0]].dtype, dt)
    if op in ("add", "sub", "mul", "div"):
        if dt == _F32:
            div = ir.nodes[n.args[1]]
            if op == "div" and div.op == "const":
                # torch's CUDA division by a scalar: times its reciprocal
                recip = np.float32(1.0) / np.float32(div.value)
                return f"__fmul_rn({a[0]}, {_lit(float(recip), _F32)})"
            return f"{_FLOAT_OP[op]}({a[0]}, {a[1]})"
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
        if dt == _F32:
            f = "fminf" if op == "minimum" else "fmaxf"
            return (f"({a[0]} != {a[0]} ? {a[0]} : ({a[1]} != {a[1]} ? "
                    f"{a[1]} : {f}({a[0]}, {a[1]})))")
        return f"{'min' if op == 'minimum' else 'max'}({a[0]}, {a[1]})"
    if op == "clamp":
        x, lo, hi = a
        fmin, fmax = ("fminf", "fmaxf") if dt == _F32 else ("min", "max")
        v = x if lo is None else f"{fmax}({x}, {lo})"
        v = v if hi is None else f"{fmin}({v}, {hi})"
        return f"({x} != {x} ? {x} : {v})" if dt == _F32 else v
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "neg":
        if dt == _F32:
            return f"(-{a[0]})"
        return f"(({_CT[dt]})(({_UINT[dt]})0 - ({_UINT[dt]}){a[0]}))"
    if op == "abs":
        if dt == _F32:
            return f"fabsf({a[0]})"
        return (f"({a[0]} < 0 ? ({_CT[dt]})(({_UINT[dt]})0 - "
                f"({_UINT[dt]}){a[0]}) : {a[0]})")
    if op == "sqrt":
        return f"__fsqrt_rn({a[0]})"
    raise AssertionError(op)


def _code(ir: IR, bind: dict, prefix: str):  # analysis: allow(host-loop): writes C++ over IR nodes, once per program
    """Statements computing ``ir`` (inputs bound to C++ expressions) and
    the variable that holds its result."""
    lines, var = [], {}
    for i in sorted(ir.live()):
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
    return lines, var[ir.out]


def _read_word(dt, k: int) -> str:
    if dt == _F32:
        return f"__int_as_float(rec[{k}])"
    if dt == _BOOL:
        return f"(rec[{k}] != 0)"
    if dt == _I64:
        return (f"((long long)(((unsigned long long)(unsigned)rec[{k + 1}] "
                f"<< 32) | (unsigned)rec[{k}]))")
    return f"rec[{k}]"


def _write_word(dt, k: int, x: str) -> list:
    if dt == _F32:
        return [f"  rec[{k}] = __float_as_int({x});"]
    if dt == _I64:
        return [f"  rec[{k}] = (int)(unsigned)(unsigned long long){x};",
                f"  rec[{k + 1}] = (int)(unsigned)((unsigned long long){x}"
                f" >> 32);"]
    return [f"  rec[{k}] = (int){x};"]


@dataclasses.dataclass(frozen=True, eq=False)
class Translation:
    """A program's functions as the generic kernels compute them.

    ``error`` is the refusal (``header`` is then None); otherwise
    ``header`` is the generated CUDA text and ``key`` its hash, which names
    the libraries built from it.  ``fields`` are the state fields the
    packing prologue reads, in the order of its pointer array; each
    source vertex (and lane) packs ``words`` 32-bit words: the fields
    ``emit`` reads, ``src_gid`` if read, and the payload at ``pay_word``.
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
        rounded up to 2, 4 or 8 (one 8-, 16- or 32-byte load)."""
        need = self.words + 1
        return 2 if need <= 2 else 4 if need <= 4 else 8

    @property
    def k2_group(self) -> int:
        """Lanes per 32-byte K2 record (7 words and the senders bits):
        at most 4, and 2 with a payload (its per-lane staging rows)."""
        return max(1, min(2 if self.pay_word >= 0 else 4,
                          MAX_WORDS // max(self.words, 1)))


_KINDS = {"min": 0, "max": 1, "sum": 2}


def _head(tr, has_emit: bool, native_ident: bool, pay: bool) -> list:
    # the text names no program: programs that compute the same functions
    # share one header and so one set of libraries
    return [
        "// Generated by repro_torch/kernels/edge_relax/emitgen.py (the",
        "// generic instance of the edge_relax kernels includes it).",
        "#pragma once",
        f"#define REPRO_GEN_HAS_EMIT {int(has_emit)}",
        "namespace {",
        "namespace gen {",
        f"using Msg = {_CT[tr['msg']]};",
        f"constexpr int kKind = {_KINDS[tr['kind']]};",
        f"constexpr bool kNativeIdent = "
        f"{'true' if native_ident else 'false'};",
        f"constexpr bool kPay = {'true' if pay else 'false'};",
        f"constexpr int kWords = {tr['words']};",
        f"constexpr int kPayWord = {tr['pay_word']};",
        f"constexpr bool kReadsWeight = "
        f"{'true' if tr['reads_weight'] else 'false'};",
        f"constexpr bool kReadsDstGid = "
        f"{'true' if tr['reads_dst_gid'] else 'false'};",
        "",
        "// the monoid's identity (masks non-sending edges)",
        "__device__ __forceinline__ Msg ident() { return "
        f"{_lit(tr['ident'], tr['msg'])}; }}",
    ]


def _op_fn(op_ir: IR | None) -> list:
    out = ["// the monoid's combine",
           "__device__ __forceinline__ Msg op(Msg a, Msg b) {"]
    if op_ir is None:
        return out + ["  return Combine<Msg, kKind>::op(a, b);", "}"]
    lines, res = _code(op_ir, {"a": "a", "b": "b"}, "o")
    return out + lines + [f"  return {res};", "}"]


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


def translate(program: str, fields, msg_dtype, monoid, traces: dict,
              with_payload: bool) -> Translation:
    """A program's :class:`Translation` from its traces
    (:func:`trace_program`); a refusal is recorded, not raised."""
    kind = monoid.kind
    base = dict(program=program, msg_dtype=msg_dtype, kind=kind)
    component = "emit"
    try:
        if msg_dtype not in (_F32, _I32):
            raise _Refuse(f"a message dtype of {msg_dtype}")
        emit_ir = _component_ir(traces["emit"], msg_dtype)
        pay_ir = None
        if with_payload:
            component = "payload"
            pay_ir = _component_ir(traces["payload"])
            pdt = pay_ir.nodes[pay_ir.out].dtype
            if pdt == _F32:
                raise _Refuse("a float32 payload")
            if pdt != _I32:                    # edge_messages' .to(int32)
                nodes = pay_ir.nodes + (Node("cast", _I32, (pay_ir.out,)),)
                pay_ir = IR(nodes, len(nodes) - 1)
        component = "monoid"
        op_ir = None
        if monoid.op is not None:
            op_ir = _component_ir(traces["monoid"], msg_dtype)
        ident = _scalar(monoid.identity(msg_dtype), msg_dtype)
        component = "record"
        reads = emit_ir.inputs()
        schema = dict(fields)
        emit_fields = [k for k, _ in fields if f"s.{k}" in reads]
        pay_fields = [] if pay_ir is None else \
            [k for k, _ in fields if f"s.{k}" in pay_ir.inputs()]
        ptr_fields = [k for k, _ in fields
                      if k in emit_fields or k in pay_fields]
        if len(ptr_fields) > 8:
            raise _Refuse(f"{len(ptr_fields)} state fields read (the "
                          f"packing prologue takes at most 8)")
        for k in ptr_fields:
            if schema[k].dtype not in _DTYPES:
                raise _Refuse(f"the field {k!r} of dtype "
                              f"{schema[k].dtype}")
        offset, slots = 0, {}
        for k in emit_fields:
            slots[f"s.{k}"] = (offset, schema[k].dtype)
            offset += _WORDS[schema[k].dtype]
        if "src_gid" in reads:
            slots["src_gid"] = (offset, _I32)
            offset += 1
        pay_word = -1
        if pay_ir is not None:
            pay_word = offset
            offset += 1
        if offset > MAX_WORDS:
            raise _Refuse(f"a source record of {offset} words (the fields "
                          f"emit reads, src_gid if read, the payload; at "
                          f"most {MAX_WORDS})")
    except _Refuse as e:
        return Translation(**base, error=_refusal(program, component, e))
    custom_ident = monoid.identity_of is not None
    native_ident = not custom_ident or ident == _scalar(
        _native_identity(kind, msg_dtype), msg_dtype)
    info = dict(msg=msg_dtype, kind=kind, words=offset, pay_word=pay_word,
                reads_weight="weight" in reads,
                reads_dst_gid="dst_gid" in reads, ident=ident)
    text = _head(info, True, native_ident, pay_ir is not None)
    text += [""] + _op_fn(op_ir)
    # pack: the record of the source vertex (and lane) at `at`
    pack = ["", "// the record of the source vertex (and lane) at `at`",
            "__device__ __forceinline__ void pack(const GenPtrs& p, "
            "long long at, int gid, int* rec) {", "  (void)gid;"]
    bind = {"src_gid": "gid"}
    for i, k in enumerate(ptr_fields):
        dt = schema[k].dtype
        pack.append(f"  const {_CT[dt]} f{i} = static_cast<const "
                    f"{_CT[dt]}*>(p.f[{i}])[at];")
        bind[f"s.{k}"] = f"f{i}"
    for name, (k, dt) in slots.items():
        pack += _write_word(dt, k, bind[name])
    if pay_ir is not None:
        lines, res = _code(pay_ir, bind, "q")
        pack += lines + [f"  rec[{pay_word}] = {res};"]
    pack.append("}")
    # emit: the message of an edge from its source's record
    emit = ["", "// the message of an edge from its source's record",
            "__device__ __forceinline__ Msg emit(const int* rec, "
            "float weight, int dst_gid) {",
            "  (void)rec; (void)weight; (void)dst_gid;"]
    ebind = {"weight": "weight", "dst_gid": "dst_gid"}
    ebind.update({name: _read_word(dt, k) for name, (k, dt) in slots.items()})
    lines, res = _code(emit_ir, ebind, "e")
    emit += lines + [f"  return {res};", "}"]
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
    big = float("inf") if dtype == _F32 else torch.iinfo(dtype).max
    return big if kind == "min" else -big


_MONOIDS: dict = {}


def translate_monoid(monoid, msg_dtype) -> Translation:
    """The combine alone (no emit) of a monoid with a custom op or
    identity, for K2's pre-emitted mode; cached per (monoid, dtype)."""
    key = (monoid, msg_dtype)
    if key not in _MONOIDS:
        base = dict(program=f"monoid {monoid.name}", msg_dtype=msg_dtype,
                    kind=monoid.kind)
        try:
            op_ir = None
            if monoid.op is not None:
                op_ir = _component_ir(
                    _trace("monoid", monoid.op, (("a", msg_dtype),
                                                 ("b", msg_dtype))),
                    msg_dtype)
            ident = _scalar(monoid.identity(msg_dtype), msg_dtype)
        except _Refuse as e:
            tr = Translation(**base, error=_refusal(
                f"monoid {monoid.name}", "monoid", e))
        else:
            native = monoid.identity_of is None or ident == _scalar(
                _native_identity(monoid.kind, msg_dtype), msg_dtype)
            info = dict(msg=msg_dtype, kind=monoid.kind, words=0,
                        pay_word=-1, reads_weight=False,
                        reads_dst_gid=False, ident=ident)
            text = _head(info, False, native, False)
            header = "\n".join(text + [""] + _op_fn(op_ir) + [
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
