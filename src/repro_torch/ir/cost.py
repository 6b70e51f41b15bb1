"""Analytic cost models from the traced stencil IR (the reference's
``src/repro/ir/cost.py``, the same numbers for the same IR and tile).

Exact per-launch flop counts (a graph walk that counts each shared
subexpression once; scalar subexpressions are evaluated on the host and
count nothing) and device-memory byte counts (per-field extents,
staggering included) yield:

  * ``a_eff`` inputs for ``core.teff`` without hand-supplied
    ``n_read``/``n_write`` (:meth:`StencilCostModel.a_eff_bytes`);
  * a per-candidate (tile, nsteps, march axis) time prediction, combining
    fetched-window traffic with the redundant halo-cone compute of
    temporal blocking (:meth:`StencilCostModel.predict_per_step_s`);
  * the traffic of a marched launch beside the refetched all-parallel one
    (:meth:`StencilCostModel.a_eff_streamed`,
    :meth:`StencilCostModel.fetched_bytes_per_step`).

The tile is the block extent of a launch per field axis; the port's own
launch tile is ``kernels.stencil.StencilCall.cost_tile``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from .trace import StencilIR

__all__ = ["FlopCount", "count_flops", "StencilCostModel"]


@dataclasses.dataclass(frozen=True)
class FlopCount:
    """Elementwise operation counts (the FlopCount idiom of roofline
    tooling): adds/subs/negs, muls, divs and pow evaluations."""

    adds: int = 0
    muls: int = 0
    divs: int = 0
    pows: int = 0

    def total(self, pow_cost: int = 1) -> int:
        """Total flops; ``pow_cost`` weights transcendental pow calls."""
        return self.adds + self.muls + self.divs + pow_cost * self.pows

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(self.adds + other.adds, self.muls + other.muls,
                         self.divs + other.divs, self.pows + other.pows)

    def __mul__(self, k: int) -> "FlopCount":
        return FlopCount(self.adds * k, self.muls * k, self.divs * k,
                         self.pows * k)

    __rmul__ = __mul__

    def to_dict(self) -> dict:
        return {"adds": self.adds, "muls": self.muls, "divs": self.divs,
                "pows": self.pows, "total": self.total()}


def count_flops(exprs: Mapping[str, object]) -> FlopCount:
    """Walk the expression graphs of all outputs, counting each unique
    node once (Python-level sharing, the sharing a compiler's CSE
    recovers), at one op per element of the node's shape. Scalar nodes
    (``_dx ** 2``) are free: the host evaluates them."""
    seen: set[int] = set()
    counts = {"adds": 0, "muls": 0, "divs": 0, "pows": 0}

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in getattr(node, "children", ()):
            walk(c)
        kind = node.flop_kind()
        if kind is not None:
            counts[kind] += math.prod(node.shape)

    for e in exprs.values():
        walk(e)
    return FlopCount(**counts)


def _as_pairs(halo, nd: int) -> tuple[tuple[int, int], ...]:
    if isinstance(halo, int):
        return ((halo, halo),) * nd
    return tuple((int(p[0]), int(p[1])) if not isinstance(p, int) else (p, p)
                 for p in halo)


def halo_compute_overhead(block: Sequence[int],
                          halo: Sequence[tuple[int, int]] | int,
                          nsteps: int) -> float:
    """Redundant-work fraction of a k-fused launch vs k ideal sweeps,
    generalized to per-axis asymmetric halos (``teff.halo_compute_overhead``
    is the symmetric special case)."""
    k = max(int(nsteps), 1)
    block = tuple(int(b) for b in block)
    pairs = _as_pairs(halo, len(block))
    ideal = k * math.prod(block)
    total = sum(
        math.prod(b + (k - 1 - s) * (lo + hi)
                  for b, (lo, hi) in zip(block, pairs))
        for s in range(k)
    )
    return total / ideal - 1.0


@dataclasses.dataclass(frozen=True)
class StencilCostModel:
    """Analytic per-step cost of one fused stencil launch."""

    shape: tuple[int, ...]                    # base (cell-centered) extent
    itemsize: int
    flops: FlopCount                          # one sweep, whole grid
    read_bytes: int                           # exact per-sweep device-memory reads
    write_bytes: int                          # exact per-sweep device-memory writes
    halo: tuple[tuple[int, int], ...]         # per-axis (lo, hi), one sweep
    field_offsets: tuple[tuple[int, ...], ...]  # staggering of fetched fields
    check_read_bytes: int = 0                 # one SEPARATE check pass's reads
    check_flops: FlopCount = FlopCount()      # fused epilogue map + fold
    n_reductions: int = 0                     # named reductions per launch
    # Mixed precision: per-field STORAGE itemsizes, aligned with
    # ``field_offsets`` (None -> every field at ``itemsize``), and the
    # width reduction partials cross device memory at (accumulation dtype, never
    # narrower than f32 — None -> max(4, itemsize)). Keeping these
    # per-field keeps a_eff / roofline / autotune pruning honest when
    # bf16 storage rides next to f32 accumulators.
    field_itemsizes: tuple[int, ...] | None = None
    partials_itemsize: int | None = None

    @classmethod
    def from_ir(cls, ir: StencilIR, itemsize: int,
                field_itemsizes=None,
                partials_itemsize: int | None = None) -> "StencilCostModel":
        """``field_itemsizes`` may be a ``{field: itemsize}`` mapping or a
        sequence aligned with ``ir.field_shapes`` order; omitted fields /
        None fall back to ``itemsize``."""
        if field_itemsizes is None:
            by_name = {f: int(itemsize) for f in ir.field_shapes}
        elif isinstance(field_itemsizes, Mapping):
            by_name = {f: int(field_itemsizes.get(f, itemsize))
                       for f in ir.field_shapes}
        else:
            by_name = {f: int(s)
                       for f, s in zip(ir.field_shapes, field_itemsizes)}
            for f in ir.field_shapes:
                by_name.setdefault(f, int(itemsize))
        rb = sum(math.prod(ir.field_shapes[f]) * by_name[f]
                 for f in ir.read_fields)
        wb = sum(math.prod(ir.field_shapes[o]) * by_name[o]
                 for o in ir.out_names)
        # the reduction epilogue's flops: the traced elementwise map plus
        # one combine op per element for the fold tree
        cf = count_flops(ir.red_exprs)
        cf = cf + FlopCount(adds=sum(math.prod(e.shape)
                                     for e in ir.red_exprs.values()))
        return cls(
            shape=ir.base_shape,
            itemsize=int(itemsize),
            flops=count_flops(ir.exprs),
            read_bytes=rb,
            write_bytes=wb,
            halo=ir.halo,
            # the launch fetches a window for EVERY field argument
            # (outputs ride along as boundary-copy sources), so the
            # tile/k traffic model must count them all — only a_eff
            # (ideal reuse) restricts to the read set
            field_offsets=tuple(ir.offsets[f] for f in ir.field_shapes),
            check_read_bytes=ir.check_io_bytes(itemsize,
                                               field_itemsizes=by_name),
            check_flops=cf,
            n_reductions=len(ir.reductions),
            field_itemsizes=tuple(by_name[f] for f in ir.field_shapes),
            partials_itemsize=(max(4, int(itemsize))
                               if partials_itemsize is None
                               else int(partials_itemsize)),
        )

    def a_eff_bytes(self, nsteps: int = 1) -> float:
        """Ideal per-step device-memory traffic (the paper's A_eff) under k-step
        temporal blocking — derived, not hand-counted."""
        return (self.read_bytes + self.write_bytes) / max(int(nsteps), 1)

    def check_bytes_per_step(self, check_every: int = 1,
                             fused: bool = True,
                             tile: Sequence[int] | None = None) -> float:
        """Per-step device-memory traffic of the convergence check, amortized over
        its cadence (``check_every=m``: one check per m steps).

        ``fused=False`` prices the separate post-pass: every operand
        field streams in again (``check_read_bytes``). ``fused=True``
        prices the in-launch epilogue: only the per-tile partials cross
        device memory: one scalar per tile per reduction — which a ``tile``
        geometry makes exact and a missing one rounds to zero."""
        m = max(int(check_every), 1)
        if not fused:
            return self.check_read_bytes / m
        if tile is None or not self.n_reductions:
            return 0.0
        n_blocks = math.prod(-(-s // int(b))
                             for s, b in zip(self.shape, tile))
        # partials cross device memory at the accumulation width, not storage
        psz = (self.partials_itemsize if self.partials_itemsize is not None
               else max(4, self.itemsize))
        return n_blocks * self.n_reductions * psz / m

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (flop/byte) of one sweep."""
        bytes_ = self.read_bytes + self.write_bytes
        return self.flops.total() / bytes_ if bytes_ else 0.0

    def fetched_bytes_per_step(self, tile: Sequence[int], nsteps: int,
                               march_axis: int | None = None,
                               check_every: int | None = None,
                               fused_checks: bool = True) -> float:
        """Device-memory bytes actually moved per time step by the tiled launch:
        every block fetches its (overlapping) halo-extended windows and
        writes its output block; a k-fused launch amortizes both over k
        steps. This is the footprint-aware refinement of ``a_eff`` that
        makes small tiles with deep halos look as expensive as they are.

        With ``march_axis`` the launch streams: windows overlap only on
        the *non*-marching axes — along the march axis each tile column
        fetches every plane once (plus ``Lhi`` clamped drain blocks), the
        halo planes riding in the scratch queue instead of being
        refetched. This is the model that makes temporal blocking and
        streaming composable in the autotuner: deep ``k*r`` halos stop
        multiplying the traffic along the marched axis.

        ``check_every=m`` adds the convergence-check traffic at its
        cadence (:meth:`check_bytes_per_step`): the fused epilogue costs
        ~one partial per tile, the separate post-pass re-reads every
        operand field — the honest accounting that keeps a checked
        solver's T_eff table from hiding its norm passes."""
        check = 0.0
        if check_every is not None:
            check = self.check_bytes_per_step(check_every, fused_checks,
                                              tile)
        k = max(int(nsteps), 1)
        tile = tuple(int(b) for b in tile)
        nd = len(tile)
        offs = self.field_offsets or ((0,) * nd,)
        # per-field storage widths (mixed precision); fall back to the
        # uniform itemsize when unset or misaligned with the offsets
        if self.field_itemsizes and len(self.field_itemsizes) == len(offs):
            sizes = self.field_itemsizes
        else:
            sizes = (self.itemsize,) * len(offs)
        if march_axis is None:
            n_blocks = math.prod(-(-s // b) for s, b in zip(self.shape, tile))
            win = sum(
                math.prod(b + k * (lo + hi) - o
                          for b, (lo, hi), o in zip(tile, self.halo, off))
                * isz
                for off, isz in zip(offs, sizes)
            )
            return (n_blocks * win + self.write_bytes) / k + check
        m = int(march_axis)
        bm = tile[m]
        lhi = -(-k * self.halo[m][1] // bm)
        planes = self.shape[m] + lhi * bm      # fetch steps * bm per column
        n_cols = math.prod(-(-s // b) for a, (s, b)
                           in enumerate(zip(self.shape, tile)) if a != m)
        win = sum(
            planes * math.prod(
                tile[a] + k * (self.halo[a][0] + self.halo[a][1]) - off[a]
                for a in range(nd) if a != m) * isz
            for off, isz in zip(offs, sizes)
        )
        return (n_cols * win + self.write_bytes) / k + check

    def a_eff_streamed(self, tile: Sequence[int], nsteps: int = 1,
                       march_axis: int = 0) -> float:
        """Analytic per-step device-memory traffic of the *streamed* launch — the
        ``a_eff``-style number the roofline records report next to the
        ideal (:meth:`a_eff_bytes`) and the refetched all-parallel
        traffic (:meth:`fetched_bytes_per_step` without a march axis).
        Equals ``fetched_bytes_per_step(tile, nsteps, march_axis)``;
        named for the T_eff table column it fills. ``march_axis`` must
        name a real axis: for a launch that fell back to all-parallel
        (``run.march_axis is None``) use ``fetched_bytes_per_step`` —
        returning refetched traffic under this name would corrupt any
        table built from it."""
        if march_axis is None:
            raise ValueError(
                "a_eff_streamed needs a concrete march_axis; an all-"
                "parallel launch's traffic is fetched_bytes_per_step(...)"
            )
        return self.fetched_bytes_per_step(tile, nsteps, march_axis)

    def predict_per_step_s(self, tile: Sequence[int], nsteps: int,
                           hw, march_axis: int | None = None,
                           check_every: int | None = None,
                           fused_checks: bool = True) -> float:
        """Roofline-style per-step runtime prediction for one
        (tile, k, march_axis) candidate on ``hw`` (any object with ``peak_bw`` in bytes/s and
        ``peak_flops`` in flop/s):
        max of the memory term (fetched windows — streamed traffic when
        marching, plus check traffic at its cadence) and the compute term
        inflated by the redundant halo-cone work of temporal blocking
        (plus the amortized check flops)."""
        k = max(int(nsteps), 1)
        t_mem = self.fetched_bytes_per_step(
            tile, k, march_axis, check_every=check_every,
            fused_checks=fused_checks) / hw.peak_bw
        overhead = halo_compute_overhead(tile, self.halo, k)
        flops = self.flops.total() * (1.0 + overhead)
        if check_every is not None:
            flops += self.check_flops.total() / max(int(check_every), 1)
        t_comp = flops / hw.peak_flops
        return max(t_mem, t_comp)
