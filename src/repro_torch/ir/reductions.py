"""Named reduction epilogues fused into stencil launches.

An iterative solver checks ``err = max|dT|`` (or an L2 residual, or a
conserved quantity) every few sweeps. A :class:`Reduction` rides inside the
launch: each thread block folds its cells into its own slot of a partials
tensor while the updated values are still in registers, and a combine over
the partials (``finish``) gives the value, with no second pass over the
fields.

Kinds (all elementwise-map then associative-combine):

  * ``max_abs(F)``          ``max |F|``
  * ``max_abs_diff(F, G)``  ``max |F - G|``   (convergence check)
  * ``sum(F)``              ``sum F``         (conserved quantity)
  * ``sum_sq(F)``           ``sum F^2``       (L2 norm squared)
  * ``finite(F)``           ``max 1[!isfinite F]`` (health guard: 0 while
    every value is finite, 1 once a NaN or inf appears)
  * ``nan_count(F)``        ``sum 1[!isfinite F]`` (how many cells blew up)

The ``finite`` and ``nan_count`` kinds fold a non-finite indicator: the
map turns NaN and inf into exactly 1 and every other value into 0 before
the combine, so the folded value is never NaN, and a count below 2^24 is
an exact integer in f32.

Operands name fields of the launch: an output operand reduces the freshly
written values, an input operand the current values, so
``max_abs_diff(T2, T)`` is exactly ``max|T2_new - T|``.

Reductions reassociate: the fused value is reproducible only within one
program; comparisons across programs use a tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

__all__ = ["Reduction", "normalize_reductions", "REDUCTION_KINDS"]

# kind -> (arity, combine): combine is "max" or "sum"
REDUCTION_KINDS = {
    "max_abs": (1, "max"),
    "max_abs_diff": (2, "max"),
    "sum": (1, "sum"),
    "sum_sq": (1, "sum"),
    "finite": (1, "max"),
    "nan_count": (1, "sum"),
}

# kinds whose elementwise map is the non-finite indicator
INDICATOR_KINDS = ("finite", "nan_count")


@dataclasses.dataclass(frozen=True)
class Reduction:
    """One named reduction: ``kind`` over ``field`` (and ``other``)."""

    kind: str
    field: str
    other: str | None = None

    def __post_init__(self):
        if self.kind not in REDUCTION_KINDS:
            raise ValueError(
                f"reduction kind {self.kind!r} must be one of "
                f"{tuple(REDUCTION_KINDS)}"
            )
        arity, _ = REDUCTION_KINDS[self.kind]
        if arity == 2 and self.other is None:
            raise ValueError(
                f"reduction {self.kind!r} takes two operands, e.g. "
                f"Reduction('{self.kind}', 'T2', 'T')"
            )
        if arity == 1 and self.other is not None:
            raise ValueError(
                f"reduction {self.kind!r} takes one operand; got second "
                f"operand {self.other!r}"
            )

    @property
    def operands(self) -> tuple[str, ...]:
        return (self.field,) if self.other is None else (self.field, self.other)

    @property
    def combine(self) -> str:
        return REDUCTION_KINDS[self.kind][1]

    # -- torch realizations -------------------------------------------------
    def map_element(self, x, y=None):
        """The elementwise pre-combine map. Works on tensors and on the
        tracer's symbolic arrays (abs/sub/mul only)."""
        if self.kind in INDICATOR_KINDS:
            if hasattr(x, "flop_kind"):
                # a symbolic array, traced for the cost model: the indicator
                # is priced as one |.| of the operand (the same reads and
                # one operation per element)
                return abs(x)
            return (~torch.isfinite(x)).to(x.dtype if x.is_floating_point()
                                            else torch.float32)
        if self.kind == "max_abs":
            return abs(x)
        if self.kind == "max_abs_diff":
            return abs(x - y)
        if self.kind == "sum":
            return x
        return x * x  # sum_sq

    def fold(self, mapped: torch.Tensor) -> torch.Tensor:
        """Fold mapped values into a 0-d tensor."""
        return torch.amax(mapped) if self.combine == "max" else torch.sum(mapped)

    def finish(self, partials: torch.Tensor) -> torch.Tensor:
        """Combine per-block partials into the launch's scalar."""
        return self.fold(partials)

    def finish_rows(self, partials: torch.Tensor) -> torch.Tensor:
        """Combine a batched launch's partials, one row of blocks a sample
        (``(B, blocks)``), into a ``(B,)`` vector: each sample's value."""
        return (torch.amax(partials, dim=1) if self.combine == "max"
                else torch.sum(partials, dim=1))

    def all_reduce(self, value: torch.Tensor, group=None) -> torch.Tensor:
        """Finish across ranks: ONE ``dist.all_reduce`` (``MAX`` or ``SUM``)
        of the rank partials over ``group`` (a ``torch.distributed``
        process group; None: the default group). Rank-local values are
        valid partials, the combines being associative. A CUDA value on a
        gloo group crosses through the host; without an initialized
        process group (a world of one rank) the value is returned as is."""
        import torch.distributed as dist

        if not dist.is_initialized():
            return value
        op = dist.ReduceOp.MAX if self.combine == "max" else dist.ReduceOp.SUM
        staged = value.is_cuda and dist.get_backend(group) == "gloo"
        buf = value.detach().to("cpu" if staged else value.device, copy=True)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(value.device) if staged else buf

    def describe(self) -> str:
        return (f"{self.kind}({self.field})" if self.other is None
                else f"{self.kind}({self.field}, {self.other})")


def _parse(spec: str) -> Reduction:
    """``"max_abs_diff(T2, T)"``-style compact form."""
    s = spec.strip()
    if "(" not in s or not s.endswith(")"):
        raise ValueError(
            f"cannot parse reduction spec {spec!r}; expected "
            "'kind(field)' or 'kind(field, other)'"
        )
    kind, rest = s.split("(", 1)
    ops = [p.strip() for p in rest[:-1].split(",") if p.strip()]
    if not 1 <= len(ops) <= 2:
        raise ValueError(f"reduction spec {spec!r} needs 1 or 2 operands")
    return Reduction(kind.strip(), ops[0], ops[1] if len(ops) == 2 else None)


def normalize_reductions(
    reductions: Mapping[str, object] | None,
    field_names: Sequence[str] | None = None,
) -> dict[str, Reduction]:
    """Normalize ``{name: Reduction | "kind(field[, other])"}``. With
    ``field_names`` the operands are validated against the launch's field
    set."""
    out: dict[str, Reduction] = {}
    for name, spec in (reductions or {}).items():
        r = spec if isinstance(spec, Reduction) else _parse(str(spec))
        if field_names is not None:
            for op in r.operands:
                if op not in field_names:
                    raise ValueError(
                        f"reduction {name!r} = {r.describe()} reads "
                        f"{op!r}, which is not a field of this launch "
                        f"(fields: {tuple(field_names)})"
                    )
        out[str(name)] = r
    return out
