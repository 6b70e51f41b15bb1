"""Trace a stencil update function into a :class:`StencilIR`.

One abstract evaluation with :mod:`.sym` window objects yields, per output
field, the expression graph (the code generator's input) plus:

  * per-output write geometry: per-axis ``all``/``inn`` mode and
    interior-ring depth, derived from the traced update's shape;
  * per-(output, field) read intervals relative to the write position;
  * per-field exchange depths (``field_halo``) and the system's window
    halo (``halo``);
  * the equivalent scalar ``inferred_radius``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

from . import sym
from .reductions import Reduction, normalize_reductions
from .sym import SymArray, TraceError

__all__ = ["StencilIR", "trace_stencil", "write_geometry"]


@dataclasses.dataclass(frozen=True)
class StencilIR:
    """Symbolic description of one fused stencil launch."""

    base_shape: tuple[int, ...]
    field_shapes: dict[str, tuple[int, ...]]
    offsets: dict[str, tuple[int, ...]]           # staggering vs base_shape
    out_names: tuple[str, ...]
    out_shapes: dict[str, tuple[int, ...]]        # traced update extents
    write_modes: dict[str, tuple[str, ...]]       # 'all' | 'inn' per axis
    write_rings: dict[str, tuple[int, ...]]       # interior-ring depth w
    reads_rel: dict[str, dict[str, tuple[tuple[int, int], ...]]]
    field_halo: dict[str, tuple[tuple[int, int], ...]]
    halo: tuple[tuple[int, int], ...]             # system window halo
    inferred_radius: int
    scalar_names: tuple[str, ...] = ()
    exprs: dict[str, SymArray] = dataclasses.field(repr=False, default_factory=dict)
    reductions: dict[str, Reduction] = dataclasses.field(default_factory=dict)

    @property
    def ndim(self) -> int:
        return len(self.base_shape)

    @property
    def read_fields(self) -> tuple[str, ...]:
        """Fields actually read by the update (device-memory read set)."""
        return tuple(
            f for f in self.field_shapes
            if any(f in r for r in self.reads_rel.values())
        )

    def io_counts(self) -> tuple[int, int]:
        """(n_read, n_write): the paper's A_eff field counting."""
        return len(self.read_fields), len(self.out_names)

    def io_bytes(self, itemsize: int) -> int:
        """Bytes that must cross device memory per step under perfect reuse:
        every read field streams in once, every output streams out once."""
        names = self.read_fields + self.out_names
        return sum(math.prod(self.field_shapes[f]) * itemsize for f in names)


def write_geometry(
    update_shape: Sequence[int],
    field_shape: Sequence[int],
    off: Sequence[int],
    name: str,
) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Per-axis write semantics and interior-ring depth derived from the
    update's traced shape.

    ``all``: the update spans the field's whole extent (every cell is
    written; ring 0). ``inn``: it spans a symmetric interior (a ``w``-cell
    boundary ring keeps its previous values). Staggered axes must be
    ``all``.
    """
    modes, rings = [], []
    for a, (u, w, o) in enumerate(zip(update_shape, field_shape, off)):
        if u == w:
            modes.append("all")
            rings.append(0)
            continue
        margin = w - u
        if margin > 0 and margin % 2 == 0:
            if o > 0:
                raise ValueError(
                    f"output {name!r} is staggered along axis {a} (offset "
                    f"{o}) but its update covers only the interior there; "
                    "staggered axes must be written at full extent "
                    "(`all` semantics, e.g. qx = -k_face * d_xa(Pe)/dx)"
                )
            modes.append("inn")
            rings.append(margin // 2)
            continue
        raise ValueError(
            f"output {name!r} update has extent {u} along axis {a}; "
            f"expected {w} (`all` write) or an even interior margin "
            f"(`inn` write) of extent {w}"
        )
    return tuple(modes), tuple(rings)


def trace_stencil(
    update_fn: Callable[[Mapping[str, SymArray], Mapping[str, object]], Mapping],
    field_shapes: Mapping[str, Sequence[int]],
    out_names: Sequence[str],
    scalar_names: Sequence[str] = (),
    reductions: Mapping[str, object] | None = None,
) -> StencilIR:
    """Abstractly evaluate ``update_fn(fields, scalars)`` once.

    Scalars enter as named :class:`~.sym.SymScalar` symbols, so the graph
    keeps them (and literal constants) for code generation. Raises
    :class:`TraceError` for untraceable constructs and ``ValueError`` for
    invalid kernels (bad write extents, interior writes on staggered axes,
    staggered reduction operands).
    """
    shapes = {n: tuple(int(x) for x in s) for n, s in field_shapes.items()}
    if not shapes:
        raise TraceError("no fields to trace")
    nd = len(next(iter(shapes.values())))
    base = tuple(max(s[a] for s in shapes.values()) for a in range(nd))
    offsets = {n: tuple(b - x for b, x in zip(base, s)) for n, s in shapes.items()}
    out_names = tuple(out_names)
    for o in out_names:
        if o not in shapes:
            raise TraceError(f"output {o!r} is not a field")

    leaves = {n: sym.field(n, s) for n, s in shapes.items()}
    scalars = {n: sym.scalar(n) for n in scalar_names}
    try:
        updates = update_fn(leaves, scalars)
    except (TraceError, ValueError, NotImplementedError):
        raise
    except Exception as e:  # torch.* on SymArray, numpy coercion, ...
        raise TraceError(
            f"update function is not symbolically traceable "
            f"({type(e).__name__}: {e})"
        ) from e
    missing = set(out_names) - set(updates)
    if missing:
        raise ValueError(f"update_fn did not produce outputs {sorted(missing)}")

    out_shapes, write_modes, write_rings, reads_rel = {}, {}, {}, {}
    for o in out_names:
        u = updates[o]
        if not isinstance(u, SymArray):
            raise TraceError(
                f"output {o!r} update is {type(u).__name__}, not a traced "
                "stencil expression"
            )
        modes, rings = write_geometry(u.shape, shapes[o], offsets[o], o)
        out_shapes[o] = u.shape
        write_modes[o], write_rings[o] = modes, rings
        reads_rel[o] = {
            f: tuple((lo - w, hi - w) for (lo, hi), w in zip(iv, rings))
            for f, iv in u.reads.items()
        }

    field_halo = {n: ((0, 0),) * nd for n in shapes}
    halo = [(0, 0)] * nd
    for o in out_names:
        for f, iv in reads_rel[o].items():
            fh = list(field_halo[f])
            for a, (lo, hi) in enumerate(iv):
                fh[a] = (max(fh[a][0], -lo), max(fh[a][1], hi))
                halo[a] = (max(halo[a][0], -lo), max(halo[a][1], hi + offsets[f][a]))
            field_halo[f] = tuple(fh)
    # A staggered `all`-write output needs at least `off` extra cells on the
    # high side of its window even when its reads are shallower.
    for o in out_names:
        for a, off_a in enumerate(offsets[o]):
            halo[a] = (halo[a][0], max(halo[a][1], off_a))
    halo = tuple((max(lo, 0), max(hi, 0)) for lo, hi in halo)
    field_halo = {
        n: tuple((max(lo, 0), max(hi, 0)) for lo, hi in d)
        for n, d in field_halo.items()
    }
    r_inf = 0
    for lo, hi in halo:
        r_inf = max(r_inf, lo, hi)
    for rings in write_rings.values():
        r_inf = max(r_inf, *rings)

    reds = normalize_reductions(reductions, tuple(shapes))
    for name, r in reds.items():
        for op in r.operands:
            if any(offsets[op]):
                raise ValueError(
                    f"reduction {name!r} = {r.describe()} reads staggered "
                    f"field {op!r} (offsets {offsets[op]}); reduction "
                    "operands must be collocated with the base grid"
                )

    return StencilIR(
        base_shape=base,
        field_shapes=shapes,
        offsets=offsets,
        out_names=out_names,
        out_shapes=out_shapes,
        write_modes=write_modes,
        write_rings=write_rings,
        reads_rel=reads_rel,
        field_halo=field_halo,
        halo=halo,
        inferred_radius=r_inf,
        scalar_names=tuple(scalar_names),
        exprs={o: updates[o] for o in out_names},
        reductions=reds,
    )
