"""Symbolic window objects: the tracing substrate of the stencil IR.

A :class:`SymArray` stands in for a field (or any expression derived from
one) during one abstract evaluation of the user's update function. It
implements the protocol the ``core.fd`` relative-slice operators rely on
(``__getitem__`` with unit-stride slices plus elementwise arithmetic) and
records, per upstream field and axis, the closed interval of index offsets
the expression reads:

    element ``j`` (in the expression's own frame) reads field cells
    ``j + d`` for every ``d`` in ``reads[field][axis]``.

Unlike a footprint-only tracer, this one keeps what a code generator needs:

  * every slice node records its start offsets, and every leaf its field;
  * scalars are :class:`SymScalar` symbols with their names, literal
    constants keep their values, and subtrees of scalars only
    (``_dx ** 2``, ``lam * dt``) stay scalar expressions that the caller
    evaluates on the host in Python numbers, as the plain path does;
  * operand order is kept for every binary operation, so ``1 - x`` and
    ``x - 1`` trace to different graphs.

Unsupported constructs (integer indexing, strided slices, broadcasting
between different shapes, ``torch.*`` calls on symbolic values, control
flow on symbolic values) raise :class:`TraceError`.
"""
from __future__ import annotations

import math
import numbers
import operator
from typing import Any, Mapping

__all__ = ["SymArray", "SymScalar", "TraceError", "field", "scalar"]


class TraceError(ValueError):
    """The update function used a construct the symbolic tracer cannot
    analyze."""


Interval = tuple[int, int]
Reads = Mapping[str, tuple[Interval, ...]]

BINARY_OPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
              "div": operator.truediv, "pow": operator.pow}
UNARY_OPS = {"neg": operator.neg, "abs": abs}
_SYMBOLS = {"add": "+", "sub": "-", "mul": "*", "div": "/", "pow": "**"}


def _merge_reads(a: Reads, b: Reads) -> dict:
    out = {k: tuple(v) for k, v in a.items()}
    for f, iv in b.items():
        if f not in out:
            out[f] = tuple(iv)
        else:
            out[f] = tuple(
                (min(x[0], y[0]), max(x[1], y[1])) for x, y in zip(out[f], iv)
            )
    return out


def _no_value(*_):
    raise TraceError(
        "symbolic stencil values have no concrete value while tracing: "
        "control flow or Python math on fields or scalars cannot be traced"
    )


class SymScalar:
    """A scalar expression: a named scalar argument (``op == "sym"``), a
    literal constant (``op == "const"``), or an operation on those."""

    __slots__ = ("op", "children", "value")

    def __init__(self, op: str, children: tuple = (), value: Any = None):
        self.op = op
        self.children = children
        self.value = value  # the name for "sym", the number for "const"

    @property
    def is_const(self) -> bool:
        return self.op == "const"

    def key(self) -> str:
        """A structural key (also a readable Python expression)."""
        if self.op == "sym":
            return str(self.value)
        if self.op == "const":
            return repr(self.value)
        if self.op in UNARY_OPS:
            return f"{self.op}({self.children[0].key()})"
        a, b = self.children
        return f"({a.key()} {_SYMBOLS[self.op]} {b.key()})"

    def evaluate(self, values: Mapping[str, Any]):
        """The expression's value in Python numbers, computed exactly as
        Python computes the same expression written on the scalars."""
        if self.op == "sym":
            return values[self.value]
        if self.op == "const":
            return self.value
        args = [c.evaluate(values) for c in self.children]
        if self.op in UNARY_OPS:
            return UNARY_OPS[self.op](args[0])
        return BINARY_OPS[self.op](*args)

    def __repr__(self):
        return f"SymScalar({self.key()})"

    def _binary(self, other, op: str, reflected: bool = False):
        if isinstance(other, SymArray):
            return NotImplemented
        other = as_scalar(other)
        if other is None:
            return NotImplemented
        kids = (other, self) if reflected else (self, other)
        return SymScalar(op, kids)

    def __add__(self, o):
        return self._binary(o, "add")

    def __radd__(self, o):
        return self._binary(o, "add", reflected=True)

    def __sub__(self, o):
        return self._binary(o, "sub")

    def __rsub__(self, o):
        return self._binary(o, "sub", reflected=True)

    def __mul__(self, o):
        return self._binary(o, "mul")

    def __rmul__(self, o):
        return self._binary(o, "mul", reflected=True)

    def __truediv__(self, o):
        return self._binary(o, "div")

    def __rtruediv__(self, o):
        return self._binary(o, "div", reflected=True)

    def __pow__(self, o):
        return self._binary(o, "pow")

    def __rpow__(self, o):
        return self._binary(o, "pow", reflected=True)

    def __neg__(self):
        return SymScalar("neg", (self,))

    def __abs__(self):
        return SymScalar("abs", (self,))

    def __pos__(self):
        return self

    __bool__ = __float__ = __int__ = __index__ = _no_value
    __lt__ = __le__ = __gt__ = __ge__ = _no_value


def as_scalar(v) -> SymScalar | None:
    """``v`` as a scalar expression: symbols pass through, plain numbers
    (and 0-d numpy values) become constants; anything else is ``None``."""
    if isinstance(v, SymScalar):
        return v
    if isinstance(v, numbers.Number):
        return SymScalar("const", value=v)
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        return SymScalar("const", value=v.item())
    return None


class SymArray:
    """One node of the traced stencil expression graph."""

    __slots__ = ("op", "shape", "reads", "children", "starts", "name")

    def __init__(self, op: str, shape: tuple[int, ...], reads: Reads,
                 children: tuple = (), starts: tuple[int, ...] | None = None,
                 name: str | None = None):
        self.op = op
        self.shape = tuple(int(s) for s in shape)
        self.reads = {k: tuple(tuple(p) for p in v) for k, v in reads.items()}
        self.children = children
        self.starts = starts  # slice nodes: the start offset per axis
        self.name = name      # leaf nodes: the field

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self):
        return f"SymArray({self.op}, shape={self.shape})"

    def __bool__(self):
        raise TraceError(
            "symbolic stencil values have no truth value: control flow on "
            "field data cannot be traced"
        )

    def __iter__(self):
        raise TraceError("symbolic stencil values are not iterable")

    # -- slicing ------------------------------------------------------------
    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if any(i is Ellipsis for i in idx):
            n_given = sum(1 for i in idx if i is not Ellipsis)
            fill = (slice(None),) * (self.ndim - n_given)
            pos = idx.index(Ellipsis)
            idx = idx[:pos] + fill + idx[pos + 1:]
        if len(idx) > self.ndim:
            raise TraceError(f"too many indices for symbolic array of rank {self.ndim}")
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        shape, shifts = [], []
        for a, (sl, n) in enumerate(zip(idx, self.shape)):
            if not isinstance(sl, slice):
                raise TraceError(
                    f"unsupported index {sl!r} along axis {a}: the stencil IR "
                    "traces unit-stride slices only (no integer/fancy indexing "
                    "inside @parallel update functions)"
                )
            start, stop, step = sl.indices(n)
            if step != 1:
                raise TraceError(
                    f"strided slice (step={step}) along axis {a} is outside "
                    "the relative-slice protocol"
                )
            if stop - start <= 0:
                raise TraceError(f"slice {sl} along axis {a} of extent {n} is empty")
            shape.append(stop - start)
            shifts.append(start)
        reads = {
            f: tuple((lo + sh, hi + sh) for (lo, hi), sh in zip(iv, shifts))
            for f, iv in self.reads.items()
        }
        return SymArray("slice", tuple(shape), reads, (self,), starts=tuple(shifts))

    # -- arithmetic ---------------------------------------------------------
    def _binary(self, other, op: str, reflected: bool = False):
        if isinstance(other, SymArray):
            if other.shape != self.shape:
                raise TraceError(
                    f"shape mismatch in '{op}': {self.shape} vs {other.shape}; "
                    "broadcasting between differently-shaped stencil "
                    "expressions is outside the relative-slice protocol"
                )
            reads = _merge_reads(self.reads, other.reads)
        else:
            s = as_scalar(other)
            if s is None:
                raise TraceError(
                    f"cannot combine a symbolic stencil value with "
                    f"{type(other).__name__} in '{op}': arrays must enter the "
                    "kernel as field arguments to be traced"
                )
            other, reads = s, self.reads
        kids = (other, self) if reflected else (self, other)
        return SymArray(op, self.shape, reads, kids)

    def __add__(self, o):
        return self._binary(o, "add")

    def __radd__(self, o):
        return self._binary(o, "add", reflected=True)

    def __sub__(self, o):
        return self._binary(o, "sub")

    def __rsub__(self, o):
        return self._binary(o, "sub", reflected=True)

    def __mul__(self, o):
        return self._binary(o, "mul")

    def __rmul__(self, o):
        return self._binary(o, "mul", reflected=True)

    def __truediv__(self, o):
        return self._binary(o, "div")

    def __rtruediv__(self, o):
        return self._binary(o, "div", reflected=True)

    def __pow__(self, o):
        return self._binary(o, "pow")

    def __rpow__(self, o):
        return self._binary(o, "pow", reflected=True)

    def __neg__(self):
        return SymArray("neg", self.shape, self.reads, (self,))

    def __abs__(self):
        return SymArray("abs", self.shape, self.reads, (self,))

    def __pos__(self):
        return self

    __lt__ = __le__ = __gt__ = __ge__ = _no_value


def field(name: str, shape) -> SymArray:
    """A symbolic leaf: element ``j`` of field ``name`` reads exactly field
    cell ``j`` (offset interval ``[0, 0]`` per axis)."""
    shape = tuple(int(s) for s in shape)
    return SymArray("leaf", shape, {name: ((0, 0),) * len(shape)}, name=name)


def scalar(name: str) -> SymScalar:
    """A symbolic scalar argument."""
    return SymScalar("sym", value=name)
