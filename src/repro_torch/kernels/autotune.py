"""Empirical launch autotuner of the generated ``@parallel`` kernel.

The counterpart of the reference's ``src/repro/kernels/autotune.py``. The
port lays each generated kernel out by tables committed after timing
candidates on the H100 (``codegen.kernel_shape``, ``codegen.PAIRS``,
``codegen.SLABS``, ``codegen_steps.steps_shape``). This module closes the
loop at run time for a caller's own shape and dtype: it times candidate
layouts on the card with ``teff.measure`` (CUDA events) and keeps the
fastest per problem class, in process memory and, with ``cache_path``, in a
JSON file, so the search is paid once per card, shape and dtype pair.

Candidates, for each (k steps a launch, march axis): the table's layout
first, as the reference puts its derived block first, then its nearest
neighbours (:func:`tile_candidates`) among the lists
``launch/tune_stencil.py`` times: :func:`candidates` (single step),
:data:`STEPS_3D`/:data:`STEPS_2D` (k steps), :func:`march_candidates` and
:func:`steps_march_candidates` (marched). The knobs searched are the tile,
planes per step, resident blocks, ``vec``, the march axis and k; the waves
of a launch are not: the tuner sets no module constant. A layout the plan
refuses (``codegen.layout_refusal``, a printer's shared-memory rule) is
left out before anything is built, as the reference leaves out blocks over
its VMEM budget, and is not counted as tried.

With a cost model and a hardware spec each candidate is priced by
``StencilCostModel.predict_per_step_s`` at its launch tile
(``StencilCall.cost_tile``); given a ``prune_ratio``, those slower than
that many times the best prediction are dropped before anything is
built. No ratio is the default, unlike the reference's 2.0: on the H100
(80GB HBM3, 700 W; PERF.md §7) the model prices FIG1's k = 4 launch at
half its measured time a step and its single step 1.5 times too high (it
counts each refetched halo plane, which L2 serves), 3.2-3.4 times apart
where they measured 5-8% apart, so a ratio below that drops layouts
untimed that are within a few percent of the fastest. The survivors are
built together (``build.compile_many``); only then is anything timed.
Each is launched once on seeded fields and held bitwise to the table
layout (k single steps for a k-step candidate; a marched one equals its
all-parallel twin), a ``RuntimeError`` otherwise. A build or launch error
raises: no candidate is passed over.

On ``device="cpu"`` the ``torch`` backend has no layout to tune:
:func:`autotune_diffusion3d` tunes k alone there, timed by the host clock,
as the reference's ``jnp`` backend does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Mapping, Sequence

import torch

from .. import telemetry as _telemetry
from ..core import fd3d as fd, teff
from . import build, codegen, codegen_steps, stencil as _stencil

Shape = codegen.KernelShape

# ---------------------------------------------------------------- the lists
# single-step one-cell layouts, by rank and whether the program has stages
STAGED_3D = [Shape((32, 8), p, b) for p in (1, 2, 4) for b in (4, 5, 6)]
PLAIN_3D = [Shape((32, 8), p, b) for p in (1, 2, 4) for b in (6, 8)]
STAGED_2D = [Shape((256, 1), p, b) for p in (2, 4) for b in (4, 5, 6)] + [Shape((128, 1), 4, 8)]
PLAIN_2D = [Shape((256, 1), p, b) for p in (1, 2, 4) for b in (6, 8)]
# all-parallel k-step layouts: (z, y) cells, planes per step, resident blocks,
# threads of a block
STEPS_3D = [Shape(t, p, b, block=n) for t, p, b, n in (
    ((32, 32), 1, 2, 256), ((32, 32), 1, 3, 256), ((32, 32), 1, 4, 256), ((32, 32), 2, 2, 256),
    ((32, 16), 1, 2, 256), ((32, 16), 1, 4, 256), ((32, 16), 2, 4, 256), ((64, 16), 1, 2, 256),
    ((32, 32), 1, 2, 512), ((32, 16), 2, 2, 256), ((32, 32), 2, 2, 512), ((32, 32), 2, 3, 256),
    ((32, 16), 1, 2, 512), ((32, 8), 2, 4, 256), ((32, 16), 2, 3, 256), ((32, 24), 2, 2, 256),
    ((32, 24), 2, 3, 256), ((32, 16), 2, 2, 512), ((32, 24), 2, 2, 512))]
STEPS_2D = [Shape(t, p, b, block=n) for t, p, b, n in (
    ((224, 1), 1, 4, 256), ((224, 1), 2, 4, 256), ((224, 1), 4, 4, 256), ((224, 1), 2, 2, 256),
    ((224, 1), 4, 2, 256), ((224, 1), 2, 6, 256), ((224, 1), 2, 8, 256), ((480, 1), 2, 2, 512),
    ((480, 1), 4, 2, 512))]
# async slab layouts (tile, planes) tried along the contiguous axis, by rank
SLABS = {3: [*dict.fromkeys([*codegen.SLABS[(3, False)], *codegen.SLABS[(3, True)],
                             ((32, 8), 16), ((32, 4), 32), ((16, 4), 32), ((32, 2), 16)])],
         2: [*dict.fromkeys([*codegen.SLABS[(2, True)], ((128, 1), 16), ((256, 1), 8),
                             ((32, 1), 32), ((64, 1), 32)])]}
# k-step layouts (tile, planes) tried along the contiguous axis, by rank
STEPS_SLABS = {3: [*codegen_steps.SLABS[3], ((32, 4), 16), ((16, 8), 16), ((32, 4), 4),
                   ((32, 8), 8)],
               2: [*codegen_steps.SLABS[2], ((128, 1), 16), ((64, 1), 16), ((256, 1), 8)]}
# pair layouts (``KernelShape.vec``) tried for 2-byte fields, by rank: 2 and 4
# cells a thread, planes per step, resident blocks
PAIRS_3D = [Shape(t, p, b, vec=v) for v, t, bs in ((2, (16, 8), (6, 7, 8, 10)),
                                                   (4, (8, 8), (8, 10, 12, 16)))
            for p in (2, 4) for b in bs] + [
    Shape((16, 8), 1, 8, vec=2), Shape((16, 8), 1, 10, vec=2), Shape((16, 8), 8, 6, vec=2),
    Shape((8, 8), 8, 8, vec=4), Shape((16, 16), 4, 4, vec=2), Shape((16, 16), 2, 3, vec=2),
    Shape((16, 16), 4, 3, vec=2), Shape((8, 16), 2, 6, vec=4), Shape((8, 16), 2, 5, vec=4),
    Shape((8, 16), 1, 6, vec=4), Shape((8, 16), 1, 8, vec=4), Shape((8, 8), 1, 10, vec=4),
    Shape((8, 8), 1, 12, vec=4), Shape((8, 8), 1, 14, vec=4), Shape((16, 8), 1, 7, vec=2)]
PAIRS_2D = [Shape(t, p, b, vec=v) for v, t, bs in ((2, (128, 1), (6, 8, 10)),
                                                   (4, (64, 1), (8, 10, 12, 16))) for p in (2, 4)
            for b in bs] + [Shape((256, 1), 4, 4, vec=2), Shape((128, 1), 4, 8, vec=4),
                            Shape((128, 1), 2, 6, vec=4), Shape((64, 1), 8, 12, vec=4),
                            Shape((128, 1), 8, 6, vec=2), Shape((32, 1), 2, 24, vec=4)]


def candidates(call) -> list:
    """The one-cell layouts of the call's rank, and for 2-byte fields the
    pair layouts beside them."""
    p = call.program
    if p.ndim == 3:
        cells = STAGED_3D if p.stages else PLAIN_3D
    else:
        cells = STAGED_2D if p.stages else PLAIN_2D
    if call.dtype.itemsize == 2:
        return [*cells, *(PAIRS_3D if p.ndim == 3 else PAIRS_2D)]
    return cells


def steps_candidates(kern, fields, scalars, nsteps: int) -> list:
    """The k-step calls of ``kern`` over its chosen layout and those of
    ``STEPS_3D`` or ``STEPS_2D`` whose queues fit a block's shared memory;
    at ``nsteps`` 1 the k-step printer's single sweep."""
    ir = kern.compiled(**fields, **scalars).ir
    chosen = kern.compiled(nsteps=max(nsteps, 2), **fields, **scalars).shape
    calls = []
    for shape in dict.fromkeys([chosen, *(STEPS_3D if ir.ndim == 3 else STEPS_2D)]):
        try:
            calls.append(_stencil.StencilCall(ir, kern.label, kern.bc, shape, nsteps,
                                              kern.rotations, kern.ps.dtype))
        except codegen.LayoutRefused:   # its queues exceed a block's shared memory
            continue
    return calls


def march_candidates(call) -> list:
    """A marched single-step call's layouts: its own (``kernel_shape``), the
    all-parallel twin's, and along the contiguous axis the synchronous
    slab (``codegen.slab_layout(..., False)``) and the async slabs of
    ``SLABS`` that fit."""
    p = call.program
    shapes = [call.shape, codegen.kernel_shape(dataclasses.replace(p, layout=()))]
    if p.z_strided:
        shapes.append(codegen.slab_layout(p, False))
        shapes += [s for tile, planes in SLABS[p.ndim]
                   if (s := codegen.slab_shape(p, tile, planes)) is not None]
    return list(dict.fromkeys(shapes))


def steps_march_candidates(call) -> list:
    """A k-step call marching the contiguous axis: its own layout and those
    of ``STEPS_SLABS`` that fit."""
    shapes = [call.shape] + [
        s for tile, planes in STEPS_SLABS[call.program.ndim]
        if (s := codegen_steps.slab_shape(call.program, call.rotations, call.nsteps, tile,
                                          planes)) is not None]
    return list(dict.fromkeys(shapes))


def _distance(a: Shape, b: Shape) -> int:
    """How many of two layouts' knobs differ."""
    return sum(x != y for x, y in zip(dataclasses.astuple(a), dataclasses.astuple(b)))


def tile_candidates(kern, fields: Mapping, scalars: Mapping, nsteps: int = 1,
                    march_axis: int | None = None, max_candidates: int = 4) -> list[Shape]:
    """The layouts to time for ``kern``'s launch of ``nsteps`` sweeps
    marching ``march_axis`` on a field set (arguments as for
    ``StencilKernel.stencil_ir``): the layout it launches today (its tile,
    else the table's) first, then at most ``max_candidates - 1`` of the
    listed layouts nearest to it (fewest knobs changed, then list order)
    that the plan accepts. None where the march falls back to the
    all-parallel launch (an extent too short for its plane queue): that
    launch is the all-parallel candidate's."""
    k = kern.marched(march_axis)
    table = k.compiled(nsteps=nsteps, **fields, **scalars)
    if table.march_fallback:
        return []
    if nsteps == 1:
        others = march_candidates(table) if table.march_axis is not None else candidates(table)
    elif table.march_axis is None:
        others = STEPS_3D if table.program.ndim == 3 else STEPS_2D
    else:
        others = steps_march_candidates(table) if table.program.z_strided else []
    out = [table.shape]
    for shape in sorted(dict.fromkeys(s for s in others if s != table.shape),
                        key=lambda s: _distance(s, table.shape)):
        if len(out) >= max_candidates:
            break
        try:
            _stencil.StencilCall(table.ir, k.label, k.bc, shape, nsteps,
                                 k.rotations if nsteps > 1 else None, k.ps.dtype,
                                 march_axis=march_axis, strict=True)
        except ValueError:          # the plan refuses it: never built, not tried
            continue
        out.append(shape)
    return out


# ---------------------------------------------------------------- the result
def _tile_json(tile):
    if isinstance(tile, Shape):
        d = dataclasses.asdict(tile)
        d["tile"] = list(tile.tile)
        return {"layout": codegen.layout_name(tile), "shape": d}
    return None if tile is None else [int(b) for b in tile]


def _tile_from_json(v):
    if isinstance(v, dict):
        return Shape(**{**v["shape"], "tile": tuple(v["shape"]["tile"])})
    return None if v is None else tuple(int(b) for b in v)


def _tile_label(tile):
    """A tile as telemetry and cache keys name it."""
    if isinstance(tile, Shape):
        return codegen.layout_name(tile)
    return None if tile is None else tuple(int(b) for b in tile)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """The winner: ``tile`` a ``KernelShape`` (for ``parallel(tile=)``), a
    per-axis tuple (the generic :func:`autotune`'s own tiles) or None (a
    backend with no layout), ``nsteps`` per launch, the time a step, and
    how many candidates were timed and pruned."""

    tile: object
    nsteps: int
    per_step_s: float
    candidates_tried: int
    candidates_pruned: int = 0
    march_axis: int | None = None

    def to_json(self) -> dict:
        return {"tile": _tile_json(self.tile), "nsteps": self.nsteps,
                "per_step_s": self.per_step_s, "candidates_tried": self.candidates_tried,
                "candidates_pruned": self.candidates_pruned, "march_axis": self.march_axis}

    @classmethod
    def from_json(cls, d: dict) -> "TuneResult":
        march = d.get("march_axis")
        return cls(_tile_from_json(d["tile"]), int(d["nsteps"]), float(d["per_step_s"]),
                   int(d.get("candidates_tried", 0)), int(d.get("candidates_pruned", 0)),
                   None if march is None else int(march))


# The winners of this process, by cache key; the serving pool runs kernels
# from threads, so every read and write of it holds _LOCK.
_CACHE: dict[tuple, TuneResult] = {}
_LOCK = threading.Lock()

# Persistent-cache schema: the port's own tag. Its keys carry the card's
# name and the (storage, compute) dtype pair and its tiles are the port's
# layouts, so a file of any other version, the reference's (integer
# versions, Pallas blocks) included, is ignored and re-tuned, never trusted.
CACHE_VERSION = "repro_torch/1"


def card_name(device) -> str:
    """The name of the card ``device`` names (``torch.cuda.get_device_name``,
    the device the kernels run on), or ``"cpu"``: the cache key's
    hardware."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return str(dtype).removeprefix("torch.")


def _tiles_key(tiles):
    if tiles is None:
        return None
    if isinstance(tiles, Mapping):
        return tuple((km, _tiles_key(ts)) for km, ts in sorted(tiles.items(), key=repr))
    return tuple(_tile_label(t) for t in tiles)


def cache_key(shape, dtype, radius: int, n_fields: int, tag: str = "",
              nsteps_candidates: Sequence[int] = (), tiles=None,
              field_offsets: Sequence[Sequence[int]] | None = None,
              prune: tuple | None = None,
              march_candidates: Sequence[int | None] | None = None,
              halos: Sequence[tuple[int, int]] | None = None,
              reductions: Sequence[str] | None = None,
              check_every: int | None = None,
              dtypes: Sequence[str] | None = None, card: str | None = None) -> tuple:
    """The memo key: the whole search space, as the reference's (the
    candidate set, the field set's staggering, the pruning configuration,
    the march candidates, the halos, the check workload, the (storage,
    compute) dtype pair), and the card (``card_name``): a winner tuned on
    one card, or for another candidate set, is never handed to another.
    The reference's VMEM budget has no counterpart here: a layout's shared
    memory is the plan's rule, not a search parameter."""
    return (tag, tuple(int(s) for s in shape), _dtype_name(dtype), int(radius), int(n_fields),
            tuple(int(k) for k in nsteps_candidates), _tiles_key(tiles),
            None if field_offsets is None else tuple(
                tuple(int(o) for o in off) for off in field_offsets),
            prune,
            None if march_candidates is None else tuple(
                None if m is None else int(m) for m in march_candidates),
            None if halos is None else tuple((int(lo), int(hi)) for lo, hi in halos),
            None if reductions is None else tuple(sorted(str(r) for r in reductions)),
            None if check_every is None else int(check_every),
            None if dtypes is None else tuple(str(d) for d in dtypes),
            card)


def _measure(fn: Callable[[], object], iters: int, device) -> teff.Measurement:
    """CUDA events on the card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return teff.measure(fn, iters=iters, warmup=1)
    return teff.measure_host(fn, iters=iters, warmup=1)


def _hit(col, tag: str, hit: TuneResult, cache: str) -> TuneResult:
    if col.enabled:
        col.event("autotune.decision", tag=tag, cache=cache, tile=_tile_label(hit.tile),
                  nsteps=hit.nsteps, march_axis=hit.march_axis, per_step_s=hit.per_step_s)
        col.count("autotune.cache_hits", 1)
    return hit


def autotune(
    make_step: Callable[..., Callable[[], object]],
    *,
    shape: Sequence[int],
    dtype,
    radius: int = 1,
    n_fields: int = 3,
    nsteps_candidates: Sequence[int] = (1, 2, 4),
    tiles=None,
    iters: int = 5,
    tag: str = "",
    cache_path: str | None = None,
    field_offsets: Sequence[Sequence[int]] | None = None,
    cost_model=None,
    hw=None,
    prune_ratio: float | None = None,
    march_candidates: Sequence[int | None] | None = None,
    halos: Sequence[tuple[int, int]] | None = None,
    reductions: Sequence[str] | None = None,
    check_every: int | None = None,
    compute_dtype=None,
    cost_tile: Callable | None = None,
    prepare: Callable[[list], None] | None = None,
    report: list | None = None,
    device="cuda",
) -> TuneResult:
    """The fastest (tile, nsteps[, march_axis]) of a stencil problem class.

    ``make_step(tile, k)`` (``make_step(tile, k, march_axis)`` with
    ``march_candidates``) returns a function of no arguments that advances
    k steps in that configuration; the median time a step decides, timed
    on ``device`` (CUDA events on the card, the host clock on the CPU).
    ``tiles`` is the candidate layouts: one list for every (k, march), a
    mapping from (k, march) to a list, or None (one candidate, ``tile``
    None, per (k, march): a backend with no layout to tune).

    With ``cost_model`` (``ir.StencilCostModel``) and ``hw`` (anything with
    ``peak_bw`` and ``peak_flops``) every candidate is priced by
    ``predict_per_step_s`` at ``cost_tile(tile, k, march)`` (by default the
    tile itself, a per-axis tuple), and with ``prune_ratio`` those above
    that many times the best prediction are dropped before any is built
    (none by default: module docstring); ``reductions`` and
    ``check_every`` key the winner to a check workload and price its
    check. ``prepare(candidates)`` runs once on the survivors' ``(tile, k,
    march)`` before the first ``make_step``: where the caller builds them
    all at once. ``report``, a list, receives one dict a candidate
    (``tile``, ``nsteps``, ``march_axis``, ``predicted_s``, ``measured_s``,
    ``pruned``). Winners are memoized per key (:func:`cache_key`) in this
    process and, with ``cache_path``, in a JSON file."""
    priced = cost_model is not None and hw is not None
    prune_tag = (None if not priced or prune_ratio is None
                 else (getattr(hw, "name", "hw"), float(prune_ratio)))
    st = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    cd = _stencil.default_compute_dtype(st) if compute_dtype is None else compute_dtype
    key = cache_key(shape, st, radius, n_fields, tag, nsteps_candidates, tiles, field_offsets,
                    prune_tag, march_candidates, halos, reductions, check_every,
                    dtypes=(_dtype_name(st), _dtype_name(cd)), card=card_name(device))
    col = _telemetry.get()
    with _LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return _hit(col, tag, hit, "memory_hit")
    if cache_path and os.path.exists(cache_path):
        hit = _load_cache(cache_path).get(_key_str(key))
        if hit is not None:
            with _LOCK:
                _CACHE[key] = hit
            return _hit(col, tag, hit, "disk_hit")

    pass_march = march_candidates is not None
    marches = (None,) if march_candidates is None else tuple(march_candidates)
    ks = [int(k) for k in nsteps_candidates]
    # the reference's order (tiles, then k, then march): ties go to the first
    if isinstance(tiles, Mapping):
        cands = [(t, k, m) for k in ks for m in marches for t in tiles.get((k, m), ())]
    else:
        cands = [(t if isinstance(t, Shape) or t is None else tuple(int(b) for b in t), k, m)
                 for t in ((None,) if tiles is None else tiles) for k in ks for m in marches]
    preds = {}
    pruned = 0
    if priced and len(cands) > 1:
        price = cost_tile or (lambda tile, k, march: tile)
        preds = {c: cost_model.predict_per_step_s(price(*c), c[1], hw, c[2],
                                                  check_every=check_every) for c in cands}
    if prune_tag is not None and len(cands) > 1:
        best_pred = min(preds.values())
        survivors = [c for c in cands if preds[c] <= prune_ratio * best_pred]
        pruned = len(cands) - len(survivors)
        if report is not None:
            report += [_row(c, preds, None, True) for c in cands if c not in survivors]
        cands = survivors
    if not cands:
        raise RuntimeError("no autotune candidate to time")
    if prepare is not None:
        prepare(list(cands))
    best: TuneResult | None = None
    tried = 0
    for tile, k, march in cands:
        fn = make_step(tile, k, march) if pass_march else make_step(tile, k)
        per_step = _measure(fn, iters, device).median_s / k
        tried += 1
        if report is not None:
            report.append(_row((tile, k, march), preds, per_step, False))
        if best is None or per_step < best.per_step_s:
            best = TuneResult(tile, k, per_step, tried, march_axis=march)
    best = dataclasses.replace(best, candidates_tried=tried, candidates_pruned=pruned)
    if col.enabled:
        col.event("autotune.decision", tag=tag, cache="miss", tile=_tile_label(best.tile),
                  nsteps=best.nsteps, march_axis=best.march_axis, per_step_s=best.per_step_s,
                  candidates_tried=tried, candidates_pruned=pruned)
        col.count("autotune.cache_misses", 1)
        col.count("autotune.candidates_pruned", pruned)
        col.count("autotune.candidates_tried", tried)
    with _LOCK:
        _CACHE[key] = best
    if cache_path:
        disk = _load_cache(cache_path) if os.path.exists(cache_path) else {}
        disk[_key_str(key)] = best
        _save_cache(cache_path, disk)
    return best


def _row(cand, preds, measured_s, pruned) -> dict:
    tile, k, march = cand
    return {"tile": _tile_label(tile), "nsteps": k, "march_axis": march,
            "predicted_s": preds.get(cand), "measured_s": measured_s, "pruned": pruned}


def diffusion3d_kernel(ps, tile: Shape | None = None):
    """The paper's Fig. 1 step on ``ps`` laid out as ``tile``; named
    ``step`` as ``examples.quickstart.make_step``'s, so both share their
    built libraries."""
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, tile=tile)
    def step(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx ** 2 + fd.d2_yi(T) * _dy ** 2 + fd.d2_zi(T) * _dz ** 2))}
    return step


def autotune_diffusion3d(
    shape: Sequence[int],
    dtype="float32",
    nsteps_candidates: Sequence[int] = (1, 2, 4),
    iters: int = 5,
    cache_path: str | None = None,
    hw=None,
    prune_ratio: float | None = None,
    march_candidates: Sequence[int | None] | None = None,
    max_candidates: int = 4,
    report: list | None = None,
    device="cuda",
) -> TuneResult:
    """Tune the Fig. 1 diffusion step on ``device`` (the card unless the
    caller asks for the CPU).

    On the card (the ``cuda`` backend) each (k, march) takes
    :func:`tile_candidates`, at most ``max_candidates`` layouts; every
    candidate is built up front, launched once on seeded fields and held
    bitwise to k single steps of the table layout, then timed with CUDA
    events. On the CPU (the ``torch`` backend) only k is tuned, as the
    reference's ``jnp`` backend does. With ``hw`` (a
    ``teff.HardwareSpec``) the kernel's traced cost model prices the
    candidates, and with ``prune_ratio`` prunes them before anything is
    built (:func:`autotune`); ``march_candidates`` (e.g.
    ``(None, 0)``) adds marched launches. ``report`` receives one dict a
    candidate: :func:`autotune`'s, and ``bitwise``, whether it was held
    bitwise to the table layout (every candidate timed was)."""
    from ..core import init_parallel_stencil

    dev = torch.device(device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    shape = tuple(int(s) for s in shape)
    ps = init_parallel_stencil(backend=backend, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    T = torch.rand(shape, generator=gen, device=dev).to(dtype)
    Ci = (torch.rand(shape, generator=gen, device=dev) + 0.5).to(dtype)
    fields = {"T2": T.clone(), "T": T, "Ci": Ci}   # T2 starts as T: k steps equal k launches
    inv = [float(n - 1) for n in shape]
    # a stable step: dt * Ci * 2 * sum(inv^2) < 1 for Ci < 1.5
    sc = dict(lam=1.0, dt=1.0 / (6.1 * 1.5 * max(inv) ** 2), _dx=inv[0], _dy=inv[1], _dz=inv[2])
    sizes = {n: shape for n in fields}
    kernels = {None: diffusion3d_kernel(ps)}

    def kernel(tile):
        if tile not in kernels:
            kernels[tile] = diffusion3d_kernel(ps, tile)
        return kernels[tile]

    probe = kernels[None]
    halos = probe.stencil_ir(**sizes, **sc).halo
    cost_model = None if hw is None else probe.cost_model(**sizes, **sc)
    marches = (None,) if march_candidates is None else tuple(march_candidates)
    tiles = None
    if backend == "cuda":
        tiles = {(int(k), m): tile_candidates(probe, sizes, sc, int(k), m, max_candidates)
                 for k in nsteps_candidates for m in marches}
    n_sm = _stencil.sm_count(dev) if dev.type == "cuda" else 132

    def call(tile, k, march):
        return kernel(tile).marched(march).compiled(nsteps=k, **sizes, **sc)

    want, checked = {}, set()

    def prepare(cands):
        if backend == "cuda":
            build.compile_many([(c.lib_name, c.source) for c in
                                [probe.compiled(**sizes, **sc), *(call(*c) for c in cands)]])
        for k in {k for _, k, _ in cands}:          # k single steps, the table's layout
            cur = dict(fields)
            for s in range(k):
                out = probe(**cur, **sc)
                if s < k - 1:
                    cur["T2"], cur["T"] = cur["T"], out
            want[k] = out

    def make_step(tile, k, march=None):
        kern = kernel(tile).marched(march)
        got = kern.run_steps(k, **fields, **sc)
        if not torch.equal(got, want[k]):
            name = "the torch backend" if tile is None else codegen.layout_name(tile)
            raise RuntimeError(f"autotune: {name} (k = {k}, march {march}) is not bitwise "
                               f"equal to {k} single steps of the table layout")
        checked.add((tile, k, march))
        return lambda: kern.run_steps(k, **fields, **sc)

    rows = [] if report is not None else None
    res = autotune(make_step, shape=shape, dtype=dtype, radius=1, n_fields=3,
                   nsteps_candidates=nsteps_candidates, tiles=tiles, iters=iters,
                   tag=f"diffusion3d/{backend}", cache_path=cache_path, cost_model=cost_model,
                   hw=hw, prune_ratio=prune_ratio, march_candidates=march_candidates,
                   halos=halos, cost_tile=lambda t, k, m: call(t, k, m).cost_tile(n_sm),
                   prepare=prepare, report=rows, device=dev)
    if report is not None:
        held = {(_tile_label(t), k, m) for t, k, m in checked}
        report += [{**r, "bitwise": (r["tile"], r["nsteps"], r["march_axis"]) in held}
                   for r in rows]
    return res


# ---------------- JSON persistence ----------------
def _key_str(key: tuple) -> str:
    return json.dumps(key, separators=(",", ":"))


def _load_cache(path: str) -> dict[str, TuneResult]:
    """The entries of a cache file, or nothing for a file of another
    :data:`CACHE_VERSION` (re-tuned, never trusted) or one that cannot be
    read; transient read failures are retried with backoff first."""
    from ..distributed import fault

    def read():
        fault.FaultPlan.active_on_io(path)
        with open(path) as f:
            return json.load(f)

    try:
        raw = fault.retry(read, exceptions=(OSError,))
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
            return {}
        return {k: TuneResult.from_json(v) for k, v in raw.get("entries", {}).items()}
    except (OSError, ValueError, KeyError, TypeError):
        return {}


def _save_cache(path: str, cache: dict[str, TuneResult]) -> None:
    from ..distributed import fault

    def write():
        fault.FaultPlan.active_on_io(path)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION,
                       "entries": {k: v.to_json() for k, v in cache.items()}}, f, indent=1)
        os.replace(tmp, path)

    fault.retry(write, exceptions=(OSError,))
