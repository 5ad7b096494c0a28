"""First-class combine monoids for diffusive programs (PyTorch port of
``repro.core.monoid``).

A :class:`Monoid` carries the elementwise combine ``op``, its identity per
message dtype, the optional ``'argbest'`` payload rule, and ``kind`` — the
scatter class (``'min' | 'max' | 'sum'``) that implements it in the
segment/scatter kernels.  Engines route every elementwise merge, row
reduction and payload selection through these methods.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .msg import identity_for

__all__ = ["Monoid", "MONOIDS", "register_monoid", "as_monoid",
           "MIN", "MAX", "SUM"]

_KINDS = ("min", "max", "sum")


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Associative-commutative message combine.

    ``op``/``identity_of`` default to the ``kind``'s native operator; pass
    custom callables to register a new monoid of an existing scatter class.
    """

    name: str
    kind: str                              # scatter class: 'min'|'max'|'sum'
    op: Callable | None = None             # custom (a, b) -> combined
    identity_of: Callable | None = None    # custom dtype -> scalar
    payload: str | None = None             # 'argbest' | None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"monoid kind must be one of {_KINDS}, got {self.kind!r}")
        if self.payload not in (None, "argbest"):
            raise ValueError(f"unknown payload rule {self.payload!r}")
        if self.payload == "argbest" and self.kind == "sum":
            raise ValueError(
                "payload='argbest' needs a selection monoid (kind 'min' or"
                " 'max'); a sum-combined message is not any single input")

    # -- elementwise ----------------------------------------------------

    def identity(self, dtype):
        """The identity element for ``dtype`` as a Python scalar."""
        if self.identity_of is not None:
            return self.identity_of(dtype)
        return identity_for(self.kind, dtype)

    def elem(self, a, b):
        """Raw elementwise combine (both sides present)."""
        if self.op is not None:
            return self.op(a, b)
        if self.kind == "min":
            return torch.minimum(a, b)
        if self.kind == "max":
            return torch.maximum(a, b)
        return a + b

    def merge(self, a, b, b_has):
        """Fold ``b`` into accumulator ``a``; ``b_has`` masks absent
        messages (sum and custom ops must not touch them)."""
        if self.op is None:
            if self.kind == "sum":
                return a + torch.where(b_has, b, torch.zeros_like(b))
            return self.elem(a, b)
        return torch.where(b_has, self.op(a, b), a)

    def improves(self, new, old):
        """Would ``new`` replace ``old`` as the combined value?  Drives
        which message's payload rides in the outbox."""
        if self.kind == "min":
            return new < old
        if self.kind == "max":
            return new > old
        shape = torch.broadcast_shapes(new.shape, old.shape)
        return torch.ones(shape, dtype=torch.bool, device=new.device)

    # -- reductions -----------------------------------------------------

    def reduce_rows(self, arr, has, dim: int = 0):
        """Combine along ``dim`` (the mailbox merge of per-source rows);
        ``has`` masks absent entries."""
        if self.op is None:
            if self.kind == "min":
                return arr.amin(dim=dim)
            if self.kind == "max":
                return arr.amax(dim=dim)
            return torch.where(has, arr, torch.zeros_like(arr)).sum(
                dim=dim, dtype=arr.dtype)
        acc = arr.select(dim, 0)
        acc_has = has.select(dim, 0)
        for i in range(1, arr.shape[dim]):
            b, bh = arr.select(dim, i), has.select(dim, i)
            nxt = torch.where(acc_has & bh, self.op(acc, b),
                              torch.where(bh, b, acc))
            acc, acc_has = nxt, acc_has | bh
        return acc

    def argbest(self, arr, dim: int = 0):
        """Index of the winning row along ``dim`` (first on ties, like
        ``jnp.argmin``)."""
        if self.payload != "argbest":
            raise ValueError(
                f"monoid {self.name!r} has no payload rule; only "
                "payload='argbest' monoids select a winning message")
        return (torch.argmin if self.kind == "min" else torch.argmax)(
            arr, dim=dim)


MONOIDS: dict[str, Monoid] = {}


def register_monoid(m: Monoid) -> Monoid:
    """Register a monoid for name-based lookup in program specs."""
    MONOIDS[m.name] = m
    return m


def as_monoid(m) -> Monoid:
    """Coerce a registry name or Monoid instance to a Monoid."""
    if isinstance(m, Monoid):
        return m
    if m in MONOIDS:
        return MONOIDS[m]
    raise KeyError(
        f"unknown monoid {m!r}; registered: {sorted(MONOIDS)} "
        "(register_monoid to add)")


MIN = register_monoid(Monoid("min", "min", payload="argbest"))
MAX = register_monoid(Monoid("max", "max", payload="argbest"))
SUM = register_monoid(Monoid("sum", "sum"))
