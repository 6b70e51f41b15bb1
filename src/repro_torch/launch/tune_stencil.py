"""Time the generated ``@parallel`` kernel's layouts on the card.

    PYTHONPATH=src python -m repro_torch.launch.tune_stencil [--waves 8,16,24,32]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --steps [--waves 2,4,8] [--ks 1,2]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --dtype bfloat16 [--steps]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --march 0,1,2 [--ks 1,2]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --split [--dtype bfloat16] [--sass DIR]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --steps --split [--sass DIR]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --hand [--against DIR] [--sass DIR]
    PYTHONPATH=src python -m repro_torch.launch.tune_stencil --batched [--dtype bfloat16] [--sass DIR]

For the coupled solvers' kernels at their full sizes (porosity 8192^2, GP
512^3) and the Fig. 1 step at 512^3, it builds each candidate
:class:`~repro_torch.kernels.codegen.KernelShape` (tile, planes per step,
resident blocks) in parallel, holds each launch bitwise against the
``torch`` backend, and prints one JSON line per kernel: for each candidate
and number of waves (``stencil.WAVES``) the CUDA-event median ms, ptxas's
registers and spill bytes; a launch that is not bitwise stops it with a
``RuntimeError``. ``codegen.kernel_shape`` and ``stencil.WAVES``
are this tool's choice: the fastest candidate without spills. With
``--steps`` it times the k-step kernels (``kernels/codegen_steps.py``) of
FIG1's step and porosity's fused kernel (k = 2, 3, 4) and GP's (k = 2, 3)
the same way, each launch held bitwise against k single-step launches, over
the layouts in ``STEPS_3D``/``STEPS_2D`` and values of ``stencil.STEPS_WAVES``;
``codegen_steps.PARALLEL`` (through ``steps_shape``) and ``stencil.STEPS_WAVES`` are its choice.
``--ks 1`` times the k-step printer's single sweep beside the single-step
kernel of ``kernels/codegen.py`` on the same fields. ``--dtype bfloat16`` or
``float16`` times every kernel with its fields stored at 2 bytes a cell
(computed in f32; the fields rounded once from the f32 ones), the pair
layouts of ``PAIRS_2D``/``PAIRS_3D`` (``KernelShape.vec``: 2 or 4 cells of
the contiguous axis a thread, ``kernels/codegen_pairs.py``) beside the
one-cell layouts; ``codegen.PAIRS`` is its choice (``--kernels`` picks
kernels by name). ``--march 0,1,2`` times the marched
variants (``march_axis``) of FIG1's step, porosity's and GP's fused kernels
along each of those axes they have, single step over the layouts of
``march_candidates`` (along the contiguous axis: the async slabs of
``SLABS`` beside the synchronous slab and the strided layout) and k = 2
(``--ks``; along the contiguous axis the async slabs of ``STEPS_SLABS``),
beside its all-parallel twin's time in the same run, with ``--waves`` the
values of the layout's waves constant (``stencil.waves_attr``: ``WAVES``,
``STEPS_WAVES`` or ``SLAB_WAVES``) to time; each launch is held bitwise
against the twin's, and ``codegen.kernel_shape`` (``codegen.SLABS``,
``codegen_steps.SLABS``) for a marched program is its choice. ``--split``
times the all-parallel kernel of FIG1's step, porosity's and GP's fused
kernels in parts (loads and conversions alone, and compute, the whole
kernel: ``codegen.cuda_source``'s ``part``), at ``--dtype`` beside the f32
twin and a pair layout beside its one-cell layout, in turns; ``--sass DIR`` writes each library's SASS there and counts
the instructions per cell of its march loop (``sass_loop``). ``--steps --split`` prints each k-step kernel's chosen
layout (``steps_layout``: registers, spills, resident blocks, shared bytes, halo cone, the lead's share of a chunk),
timed and held bitwise to k single steps, and with ``--sass DIR`` its SASS instructions per cell by barrier segment
(``sass_steps``). ``--split
--march 2`` times each kernel's march along the contiguous axis in parts,
the synchronous slab and the async slabs of ``SPLIT_SLABS`` (staging alone,
staging and compute, the whole kernel), beside the twin, in turns. ``--hand``
times the hand kernel ``csrc/diffusion3d.cu`` at 512^3 (:func:`tune_hand`):
another checkout's (``--against``) beside this one in turns, then each
variant of its k-step layout (:data:`HAND_VARIANTS`) and ``--waves``, each
launch bitwise to the plain version, with ``--sass DIR`` its SASS a cell by
class and barrier segment (:func:`sass_hand`). ``--batched`` times the
batched kernels of a batched solve (the sample axis) in each layout and
number of waves (:func:`tune_batched`): for the serving step, plain and
guarded, the column march's candidates (:data:`COLUMN_3D`: tile, planes
unrolled, resident blocks, loads ahead; waves :data:`COLUMN_WAVES_TRIED`)
beside its one-cell layout before the redesign (:data:`ONE_CELL`), each
timed alone and through ``run_batch``; then the split (:func:`batch_split`) of the
serving step at :data:`BATCH_SPLIT`'s shapes (B = 1 x 512^3 beside the solo
step, 16 and 64 x 128^3, 8 x 64^3), the one-cell layout beside the
chosen one, with ``--sass DIR`` the march loop's SASS a cell
(:func:`sass_loop`, :func:`sass_column_loop`) and its ``LDG.E`` against
``LDG.E.CONSTANT`` loads (:func:`sass_loads`); then at f32 a serving chunk
in the column march and in the one-cell layout, in turns
(:func:`serve_chunk`). It needs the card and measures nothing on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import inspect
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import torch

from ..core import init_parallel_stencil, teff
from ..examples import gross_pitaevskii as gp, porosity_waves as pw, quickstart
from ..configs import FIG1
from ..kernels import build, codegen, codegen_steps, stencil
# the layouts this tool times, one definition shared with the run-time autotuner
# (``kernels/autotune.py``: ``candidates``, ``STEPS_3D``/``STEPS_2D``, ``PAIRS_3D``/``PAIRS_2D``,
# ``SLABS``, ``STEPS_SLABS``)
from ..kernels.autotune import (candidates, march_candidates, steps_candidates,
                                steps_march_candidates)

Shape = codegen.KernelShape
SCALARS = dict(dtau=1e-3, g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0)
STEPS_KS = {"stencil": (2, 3, 4), "porosity_fused[neumann0]": (2, 3, 4),
            "gp_fused[none]": (2, 3)}
MARCH_KERNELS = ("stencil", "porosity_fused[neumann0]", "gp_fused[none]")


def random_fields(kern, base, porosity, gen, dev, lead: tuple = ()) -> dict:
    """Seeded fields of a coupled kernel at ``base`` (porosity's fluxes one
    cell shorter along their axis), each with the ``lead`` axes in front:
    porosities 0.005-0.015, porosity's pressures within 0.005 of 0, GP's in
    [0, 1)."""
    out = {}
    for f, shape in field_shapes(kern, base).items():
        u = torch.rand([*lead, *shape], generator=gen, device=dev)
        out[f] = 0.005 + 0.01 * u if f.startswith("phi") else (
            (u - 0.5) * 0.01 if porosity else u)
    return out


def field_shapes(kern, base) -> dict:
    """Each field's shape at ``base``: porosity's fluxes one cell shorter
    along their axis."""
    return {f: tuple(b - o for b, o in zip(base, {"qx": (1, 0), "qy": (0, 1)}.get(
                f, (0,) * len(base))))
            for f in inspect.signature(kern.fn).parameters if f not in SCALARS}


def kernels(dev, dtype: torch.dtype = torch.float32) -> dict:
    """``name: (kernel, plain twin, fields, scalars)`` at full size, the
    fields stored as ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(20260715)

    def solver(mod, cfg_cls, n, pick, reductions=None, **kw):
        pair = []
        for backend in ("cuda", "torch"):
            cfg = cfg_cls(n=n, device="cuda", backend=backend, **kw)
            k = mod.make_step(mod.make_grid(cfg), cfg).kernels[pick]
            pair.append(k.with_reductions(reductions))
        return pair

    def fields(kern, base, porosity):
        return random_fields(kern, base, porosity, gen, dev)

    out = {}
    pw_n, gp_n = 8192, 512
    for name, pair, porosity in (
            ("porosity_fused[neumann0]", solver(pw, pw.PorosityConfig, pw_n, 0, bc="neumann"), 1),
            ("porosity_fused[neumann0]+err", solver(pw, pw.PorosityConfig, pw_n, 0,
                                                    {"err": "max_abs_diff(Pe2, Pe)"},
                                                    bc="neumann"), 1),
            ("porosity_fluxes", solver(pw, pw.PorosityConfig, pw_n, 0, flux_split=True), 1),
            ("gp_fused[none]", solver(gp, gp.GPConfig, gp_n, 0), 0),
            ("gp_fused[none]+mass", solver(gp, gp.GPConfig, gp_n, 0,
                                           {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}), 0),
            ("gp_step_re", solver(gp, gp.GPConfig, gp_n, 0, fused=False), 0)):
        k = pair[0]
        base = (pw_n,) * 2 if porosity else (gp_n,) * 3
        names = inspect.signature(k.fn).parameters
        out[name] = (*pair, fields(k, base, porosity),
                     {n: v for n, v in SCALARS.items() if n in names})
    step = quickstart.make_step(init_parallel_stencil())
    plain = quickstart.make_step(init_parallel_stencil(backend="torch", device="cuda"))
    _, f, sc = quickstart.initial_state(FIG1, "cuda")
    out["stencil+err"] = (step.with_reductions({"err": "max_abs_diff(T2, T)"}),
                          plain.with_reductions({"err": "max_abs_diff(T2, T)"}), f, sc)
    out["stencil"] = (step, plain, f, sc)
    return {n: (k.with_dtype(dtype), p.with_dtype(dtype), {a: t.to(dtype) for a, t in f.items()},
                sc) for n, (k, p, f, sc) in out.items()}


def ptxas(log: str) -> dict:
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    return {"registers": max(regs, default=None),
            "spill_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))}


def steps_choice(call) -> str:
    """The layout ``codegen_steps.steps_shape`` gives the call's program and
    k, with the current ``stencil.STEPS_WAVES``, as the candidates are named."""
    sh = codegen_steps.steps_shape(call.program, call.rotations, call.nsteps, dtype=call.dtype)
    return f"{layout_name(sh)}/w{stencil.STEPS_WAVES}"


def tune_steps(todo: dict, waves: list, iters: int, ks: list | None = None) -> None:
    """Time each k-step kernel's candidate layouts (one JSON line per
    kernel and k, for the k of ``STEPS_KS`` or of ``ks``); every launch must
    equal k single-step launches of the same program bitwise (a
    ``RuntimeError`` otherwise); outputs start as copies of their targets.
    At k = 1 the line also gives the single-step kernel's time on the same
    fields (``single_step_ms``), the printers' comparison."""
    tuned = {}
    for n, default_ks in STEPS_KS.items():
        if n not in todo:
            continue
        k, _, f, sc = solver_state(todo, n)
        todo[n] = (k, None, f, sc)
        for nsteps in (default_ks if ks is None else ks):
            tuned[(n, nsteps)] = steps_candidates(k, f, sc, nsteps)
    t0 = time.perf_counter()
    logs = iter(build.compile_many([(t.lib_name, t.source) for ts in tuned.values()
                                    for t in ts]))
    print(json.dumps({"built": sum(map(len, tuned.values())),
                      "seconds": time.perf_counter() - t0}), flush=True)
    default_waves = stencil.STEPS_WAVES
    for (n, nsteps), calls in tuned.items():
        k, _, f, sc = todo[n]
        cur = dict(f)
        for _ in range(nsteps):
            res = k(**cur, **sc)
            res = res[0] if k.reductions else res
            outs = {k.outputs[0]: res} if len(k.outputs) == 1 else res
            for o, t in k.rotations.items():
                cur[o], cur[t] = cur[t], outs[o]
        row = {}
        for t in calls:
            found = ptxas(next(logs).log)
            for w in waves:
                stencil.STEPS_WAVES = w
                outs, _ = t.run(f, sc)
                if not all(torch.equal(outs[o], cur[tgt]) for o, tgt in k.rotations.items()):
                    raise RuntimeError(f"{t.label} at {t.shape}, {w} waves: not bitwise equal "
                                       f"to {nsteps} single-step launches")
                ms = teff.measure(lambda: t.run(f, sc), iters=iters, warmup=3).median_s * 1e3
                row[f"{layout_name(t.shape)}/w{w}"] = {
                    "ms": ms, "ms_per_step": ms / nsteps, **found}
        stencil.STEPS_WAVES = default_waves
        line = {"kernel": n, "k": nsteps, "chosen": steps_choice(calls[0]), "candidates": row}
        if nsteps == 1:
            one = k.compiled(**f, **sc)
            line["single_step_ms"] = teff.measure(lambda: one.run(f, sc), iters=iters,
                                                  warmup=3).median_s * 1e3
        print(json.dumps(line), flush=True)


def solver_state(todo: dict, n: str):
    """A kernel's fields with each output starting as its rotation target (as
    in the solvers, and as ``run_steps(k)`` equals k launches), porosity at
    its own pseudo-time step (``SCALARS``' 1e-3 overflows within a few steps
    at 8192^2)."""
    k, plain, f, sc = todo[n]
    f = dict(f)
    for o, t in (k.rotations or {}).items():
        f[o] = f[t].clone()
    if "dtau" in sc:
        cfg = pw.PorosityConfig(n=8192, device="cuda")
        sc = dict(sc, dtau=pw.timestep(cfg, pw.make_grid(cfg)))
    return k, plain, f, sc


def tune_march(todo: dict, axes: list, waves: list | None, iters: int, ks: list) -> None:
    """Time each marched kernel's candidate layouts (one JSON line per
    kernel, axis and k) beside its all-parallel twin; each launch must equal
    the twin's bitwise (a ``RuntimeError`` otherwise)."""
    tuned, twins = {}, {}
    for n in MARCH_KERNELS:
        k, _, f, sc = todo[n] = solver_state(todo, n)
        for nsteps in ks:
            twins[(n, nsteps)] = k.compiled(nsteps=nsteps, **f, **sc)
            for a in (a for a in axes if a < k.ps.ndims):
                call = k.marched(a).compiled(nsteps=nsteps, **f, **sc)
                shapes = march_candidates(call) if nsteps == 1 else \
                    steps_march_candidates(call) if call.program.z_strided else [call.shape]
                tuned[(n, a, nsteps)] = [
                    stencil.StencilCall(call.ir, k.label, k.bc, shape, nsteps,
                                        k.rotations if nsteps > 1 else None, k.ps.dtype,
                                        march_axis=a) for shape in shapes]
    t0 = time.perf_counter()
    sources = [(t.lib_name, t.source) for t in twins.values()]
    sources += [(t.lib_name, t.source) for ts in tuned.values() for t in ts]
    logs = build.compile_many(sources)
    print(json.dumps({"built": len(sources), "seconds": time.perf_counter() - t0}), flush=True)
    logs = iter(logs[len(twins):])
    for (n, a, nsteps), calls in tuned.items():
        k, _, f, sc = todo[n]
        twin = twins[(n, nsteps)]
        want, _ = twin.run(f, sc)
        twin_ms = teff.measure(lambda: twin.run(f, sc), iters=iters, warmup=3).median_s * 1e3
        row = {}
        for t in calls:
            found = ptxas(next(logs).log)
            attr = stencil.waves_attr(t.shape, nsteps > 1)
            default_waves = getattr(stencil, attr)
            for w in waves or [default_waves]:
                setattr(stencil, attr, w)
                outs, _ = t.run(f, sc)
                if not all(torch.equal(outs[o], want[o]) for o in k.outputs):
                    raise RuntimeError(f"{t.label} at {t.shape}, {w} waves: not bitwise equal "
                                       "to its all-parallel twin")
                ms = teff.measure(lambda: t.run(f, sc), iters=iters, warmup=3).median_s * 1e3
                row[f"{layout_name(t.shape)}/w{w}"] = {
                    "ms": ms, "grid": list(t.derive(132).grid), "xc": t.derive(132).xc,
                    "queue_planes": t.queue_planes, **found}
            setattr(stencil, attr, default_waves)
        print(json.dumps({"kernel": n, "march_axis": a, "k": nsteps, "twin_ms": twin_ms,
                          "z_strided": calls[0].program.z_strided,
                          "chosen": f"{layout_name(calls[0].shape)}/w"
                                    f"{stencil.waves_of(calls[0].shape, nsteps > 1)}",
                          "candidates": row}), flush=True)


PARTS = ("stage", "compute")
# async slab layouts split besides the chosen one, by rank
SPLIT_SLABS = {3: [((32, 4), 16)], 2: [((64, 1), 16)]}


def variant(call, source: str, suffix: str):
    """``call`` launching ``source``, built under a name of its own."""
    out = copy.copy(call)
    out.source, out.lib_name = source, f"{call.lib_name}_{suffix}"
    out.launch_info, out._lib = {}, None
    return out


def part_call(call, part: str):
    """``call`` printed as a timing variant (``codegen.cuda_source``'s
    ``part``: "stage" or "compute")."""
    return variant(call, codegen.cuda_source(call.program, call.shape, call.dtype, part=part),
                   part)


def relaid(kern, call, shape):
    """``kern``'s single-step ``call`` laid out as ``shape``, built under a
    name of its own."""
    out = stencil.StencilCall(call.ir, kern.label, kern.bc, shape, dtype=call.dtype,
                              march_axis=call.march_axis)
    out.lib_name += "_" + layout_name(shape).replace("/", "_")
    return out


def tune_split(todo: dict, iters: int, rounds: int = 2) -> None:
    """Time each kernel's march along the contiguous axis in parts (one JSON
    line per kernel), the synchronous slab and the async one: the
    field queues' staging alone, staging and compute, the whole kernel,
    beside the all-parallel twin, in turns over ``rounds`` rounds. Each
    whole kernel is held bitwise to the twin; the parts keep nothing."""
    runs = {}
    for n in MARCH_KERNELS:
        k, _, f, sc = todo[n] = solver_state(todo, n)
        call = k.marched(k.ps.ndims - 1).compiled(**f, **sc)
        p = call.program
        slabs = {"sync": codegen.slab_layout(p, False), "async": call.shape}
        slabs.update({layout_name(sh): sh for tile, planes in SPLIT_SLABS[p.ndim]
                      if (sh := codegen.slab_shape(p, tile, planes)) is not None})
        runs[n] = {"twin": k.compiled(**f, **sc)}
        for name, sh in slabs.items():
            c = runs[n][name] = relaid(k, call, sh)
            runs[n].update({f"{name}_{part}": part_call(c, part) for part in PARTS})
    t0 = time.perf_counter()
    calls = [c for r in runs.values() for c in r.values()]
    logs = build.compile_many([(c.lib_name, c.source) for c in calls])
    print(json.dumps({"built": len(calls), "seconds": time.perf_counter() - t0}), flush=True)
    found = {c.lib_name: ptxas(b.log) for c, b in zip(calls, logs)}
    for n, r in runs.items():
        k, _, f, sc = todo[n]
        want, _ = r["twin"].run(f, sc)
        for v in (v for v in r if v != "twin" and not v.endswith(PARTS)):
            got, _ = r[v].run(f, sc)
            if not all(torch.equal(got[o], want[o]) for o in k.outputs):
                raise RuntimeError(f"{n}: the {v} slab is not bitwise equal to its twin")
        ms = {v: [] for v in r}
        for _ in range(rounds):
            for v, c in r.items():
                ms[v].append(teff.measure(lambda: c.run(f, sc), iters=iters,
                                          warmup=3).median_s * 1e3)
        print(json.dumps({"kernel": n, "march_axis": k.ps.ndims - 1,
                          "layouts": {v: layout_name(c.shape) for v, c in r.items()},
                          "ms": ms, "ptxas": {v: found[c.lib_name] for v, c in r.items()}}),
              flush=True)


# the all-parallel kernel's timing parts (``codegen.cuda_source``'s ``part``)
PARALLEL_PARTS = ("load", "compute")


def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump``, or None."""
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return path if os.access(path, os.X_OK) else None


def write_sass(library, path) -> bool:
    """Write the SASS of a built library to ``path`` (False without
    ``cuobjdump``)."""
    exe = cuobjdump()
    if exe is None:
        return False
    out = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True)
    pathlib.Path(path).write_text(out.stdout + out.stderr)
    return True


_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)"
                        r"(?:\.[A-Z0-9_.]+)?\s*([^;]*);")


def sass_loop(text: str, cells: int) -> dict:
    """Instructions of a single-step kernel's march loop in SASS
    (``cuobjdump -sass``): the loop is the widest backward branch; its
    stage part runs from its start to the first barrier, less the spans
    of the forward branches there (a stage's partial last iteration, which
    only some threads run); its core is the longest branch-free block after
    the barrier with the most stores (the unrolled core program over a
    step's planes; without stages the loop has no barrier). Per cell: a
    thread's stage part and core block over its ``cells`` a step (planes
    times cells a thread), by opcode
    (``loads``, ``stores``: global; ``shared``; ``fp``: f32 arithmetic;
    ``convert``)."""
    ins = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in map(_SASS_LINE.match,
                                                                   text.splitlines()) if m]
    branches = [(a, int(t, 16)) for a, op, arg in ins if op == "BRA"
                for t in re.findall(r"0x([0-9a-f]+)\s*$", arg)]
    back = [(t, a) for a, t in branches if t < a]
    if not back:
        return {}
    lo, hi = max(back, key=lambda b: b[1] - b[0])
    body = [(a, op) for a, op, _ in ins if lo <= a <= hi]
    bar = next((a for a, op in body if op == "BAR"), lo)
    skipped = set()
    for a, t in branches:
        if lo <= a < bar and a < t <= bar:
            skipped.update(range(a + 16, t, 16))
    stage = [op for a, op in body if a < bar and a not in skipped and op != "BAR"]
    # basic blocks after the barrier: each ends after a branch or before a target
    bounds = sorted({a + 16 for a, _ in branches if bar < a <= hi}
                    | {t for _, t in branches if bar < t <= hi} | {bar + 16, hi + 16})
    blocks = [[op for a, op in body if b0 <= a < b1] for b0, b1 in zip(bounds, bounds[1:])]
    core = max(blocks, key=lambda b: (b.count("STG"), len(b)))
    kinds = {"loads": ("LDG", "LD"), "stores": ("STG", "ST"), "shared": ("LDS", "STS"),
             "fp": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "MUFU"),
             "convert": ("F2F", "F2FP", "PRMT", "HADD2", "I2F", "F2I")}
    per_cell = {"all": (len(stage) + len(core)) / cells}
    for k, ops in kinds.items():
        per_cell[k] = sum(op in ops for op in stage + core) / cells
    return {"loop": len(body), "stage": len(stage), "core_block": len(core),
            "per_cell": per_cell}


def tune_split_parallel(todos: dict, iters: int, rounds: int = 2, sass: str | None = None) -> None:
    """Time each kernel's all-parallel launch in parts (one JSON line per
    kernel and storage dtype; ``todos``: ``{dtype name: kernels()}``): its
    loads and conversions alone, those and the compute without the core
    cells' stores, the whole kernel, in turns over ``rounds`` rounds; a
    pair layout also in its one-cell layout (dtype ``.../cells``). Each
    whole kernel is held bitwise to the ``torch`` backend; the parts keep
    nothing. With ``sass`` each library's SASS goes to that directory."""
    runs = {}
    for dt, todo in todos.items():
        for n in MARCH_KERNELS:
            k, _, f, sc = todo[n] = solver_state(todo, n)
            call = k.compiled(**f, **sc)
            layouts = {dt: call}
            if call.shape.vec > 1:
                layouts[f"{dt}/cells"] = relaid(k, call, codegen.kernel_shape(call.program))
            for tag, c in layouts.items():
                runs[(n, tag)] = {"whole": c,
                                  **{part: part_call(c, part) for part in PARALLEL_PARTS}}
    t0 = time.perf_counter()
    calls = [c for r in runs.values() for c in r.values()]
    logs = build.compile_many([(c.lib_name, c.source) for c in calls])
    print(json.dumps({"built": len(calls), "seconds": time.perf_counter() - t0}), flush=True)
    found = {c.lib_name: ptxas(b.log) for c, b in zip(calls, logs)}
    counts = {}
    if sass:
        pathlib.Path(sass).mkdir(parents=True, exist_ok=True)
        for (n, dt), r in runs.items():
            for v, c in r.items():
                path = pathlib.Path(sass) / f"{n}_{dt.replace('/', '_')}_{v}.sass"
                if write_sass(build.library_path(c.lib_name, c.source), path) and v == "whole":
                    counts[(n, dt)] = sass_loop(path.read_text(), c.shape.planes * c.shape.vec)
    for (n, dt), r in runs.items():
        k, plain, f, sc = todos[dt.split("/")[0]][n]
        want = plain(**f, **sc)
        want = want[0] if k.reductions else want
        want = {k.outputs[0]: want} if len(k.outputs) == 1 else want
        got, _ = r["whole"].run(f, sc)
        if not all(torch.equal(got[o], want[o]) for o in k.outputs):
            raise RuntimeError(f"{n} ({dt}): not bitwise equal to the torch backend")
        ms = {v: [] for v in r}
        for _ in range(rounds):
            for v, c in r.items():
                ms[v].append(teff.measure(lambda: c.run(f, sc), iters=iters,
                                          warmup=3).median_s * 1e3)
        print(json.dumps({"kernel": n, "dtype": dt, "layout": layout_name(r["whole"].shape),
                          "cells": math.prod(r["whole"].ir.base_shape), "ms": ms,
                          "libraries": {v: c.lib_name for v, c in r.items()},
                          "ptxas": {v: found[c.lib_name] for v, c in r.items()},
                          "sass": counts.get((n, dt))}), flush=True)


layout_name = codegen.layout_name

_INTEGER = ("IADD3", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "IMNMX", "SEL", "IABS", "SGXT",
            "P2R", "R2P", "PLOP3", "VIADD", "IADD", "ISCADD", "MOV")


def steps_layout(call, n_sm: int = 132, registers: int | None = None) -> dict:
    """A k-step call's layout: tile, threads, planes, resident blocks (shared
    memory, threads and ``registers`` a thread), the
    plan's lead and its share of a chunk (the planes a chunk computes
    before its first written one, over all it computes), the halo cone
    (cells every phase computes over the tile's, per sweep and phase,
    less 1) and each phase's region, lag, slots and a thread's cells a
    step (planes times rounds of the block's threads)."""
    pl, sh = call.plan, call.shape
    xc = call.derive(n_sm).xc
    tile = sh.tile[0] * sh.tile[1]
    phases, cone = [], 0
    for ph in pl.phases:
        n = math.prod(pl.region(ph, sh))
        cone += n
        if not call.program.layout:
            r, width = codegen_steps.rounds(pl, ph, sh)
        else:
            r, width = -(-n // sh.threads), sh.threads
        phases.append({"phase": ph.name, "region": list(pl.region(ph, sh)), "lag": ph.lag,
                       "slots": ph.slots, "rounds": r, "width": width,
                       "cells_per_thread": sh.planes * r,
                       "barrier": ph.barrier})
    blocks = codegen_steps.resident_blocks(call.program, call.rotations, call.nsteps, sh,
                                           registers) if sh.block else sh.min_blocks
    return {"layout": layout_name(sh), "tile": list(sh.tile), "threads": sh.threads,
            "planes": sh.planes, "blocks": blocks,
            "smem_bytes": codegen_steps.shared_bytes(call.program, pl, sh, call.dtype),
            "lead": pl.lead, "xc": xc, "lead_share": pl.lead / (xc + pl.lead),
            "halo_cone": cone / (len(pl.phases) * tile) - 1, "phases": phases}


def sass_steps(text: str, phases: list) -> list:
    """Instructions of a k-step kernel's march loop in SASS, by barrier
    segment (the phases between two barriers; ``phases`` as
    :func:`steps_layout` gives them): the loop is the widest backward
    branch; in each segment the longest branch-free block (the fast
    cells, unrolled) counted by class over the cells a thread computes in
    it a step (``fp``: f32 arithmetic; ``integer``; ``shared``: loads and
    stores; ``loads``, ``stores``: device memory), and the segment's
    instructions in all."""
    ins = [(int(m.group(1), 16), m.group(3), m.group(4))
           for m in map(_SASS_LINE.match, text.splitlines()) if m]
    branches = [(a, int(t, 16)) for a, op, arg in ins if op == "BRA"
                for t in re.findall(r"0x([0-9a-f]+)\s*$", arg)]
    back = [(t, a) for a, t in branches if t < a]
    if not back:
        return []
    lo, hi = max(back, key=lambda b: b[1] - b[0])
    body = [(a, op) for a, op, _ in ins if lo <= a <= hi]
    bars = [a for a, op in body if op == "BAR"]
    edges = [lo, *[b + 16 for b in bars], hi + 16]
    groups, cur = [], []
    for ph in phases:
        cur.append(ph)
        if ph["barrier"]:
            groups.append(cur)
            cur = []
    groups.append(cur)
    kinds = {"fp": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "MUFU"),
             "integer": _INTEGER, "shared": ("LDS", "STS"), "loads": ("LDG",),
             "stores": ("STG",)}
    out = []
    for (s0, s1), group in zip(zip(edges, edges[1:]), groups):
        seg = [(a, op) for a, op in body if s0 <= a < s1]
        cuts = sorted({a + 16 for a, _ in branches if s0 <= a < s1}
                      | {t for _, t in branches if s0 < t < s1} | {s0, s1})
        blocks = [[op for a, op in seg if b0 <= a < b1] for b0, b1 in zip(cuts, cuts[1:])]
        fast = max(blocks, key=len) if blocks else []
        cells = sum(ph["cells_per_thread"] for ph in group)
        out.append({"phases": [ph["phase"] for ph in group], "instructions": len(seg),
                    "fast_block": len(fast), "cells_per_thread": cells,
                    "per_cell": {"all": len(fast) / cells, **{
                        k: sum(op in ops for op in fast) / cells for k, ops in kinds.items()}}})
    return out


def tune_steps_split(todo: dict, iters: int, sass: str | None = None) -> None:
    """One JSON line per k-step kernel and k of ``STEPS_KS`` in its
    chosen layout: its median ms (held bitwise to k single-step launches),
    ptxas's registers and spills, :func:`steps_layout`, and with ``sass``
    its SASS (written to that directory) counted by :func:`sass_steps`."""
    runs = {}
    for n, ks in STEPS_KS.items():
        if n not in todo:
            continue
        k, _, f, sc = todo[n] = solver_state(todo, n)
        for nsteps in ks:
            runs[(n, nsteps)] = k.compiled(nsteps=nsteps, **f, **sc)
    t0 = time.perf_counter()
    logs = build.compile_many([(c.lib_name, c.source) for c in runs.values()])
    print(json.dumps({"built": len(runs), "seconds": time.perf_counter() - t0}), flush=True)
    for ((n, nsteps), call), log in zip(runs.items(), logs):
        k, _, f, sc = todo[n]
        cur = dict(f)
        for _ in range(nsteps):
            res = k(**cur, **sc)
            res = res[0] if k.reductions else res
            outs = {k.outputs[0]: res} if len(k.outputs) == 1 else res
            for o, t in k.rotations.items():
                cur[o], cur[t] = cur[t], outs[o]
        got, _ = call.run(f, sc)
        if not all(torch.equal(got[o], cur[t]) for o, t in k.rotations.items()):
            raise RuntimeError(f"{call.label}: not bitwise equal to {nsteps} single-step launches")
        ms = teff.measure(lambda: call.run(f, sc), iters=iters, warmup=3).median_s * 1e3
        found = ptxas(log.log)
        lay = steps_layout(call, registers=found["registers"])
        line = {"kernel": n, "k": nsteps, "ms": ms, "ms_per_step": ms / nsteps, **found, **lay}
        if sass:
            pathlib.Path(sass).mkdir(parents=True, exist_ok=True)
            path = pathlib.Path(sass) / f"{n}_k{nsteps}.sass"
            if write_sass(build.library_path(call.lib_name, call.source), path):
                line["sass"] = sass_steps(path.read_text(), lay["phases"])
        print(json.dumps(line), flush=True)


# ---- the hand kernel (csrc/diffusion3d.cu) ------------------------------------
HAND_DTYPES = ("float32", "bfloat16", "float16")
HAND_SHAPE = (512, 512, 512)
# scalars: FIG1's spacings at f32; at 2 bytes ones at which every product
# rounds and nothing overflows f16 (chip_smoke.HAND_MIXED_ARGS; FIG1's
# inverse spacings squared do)
HAND_ARGS = {"float32": (1.0, 1e-4, 511.0, 511.0, 511.0),
             "bfloat16": (0.7, 1e-3, 8.3, 9.1, 10.7), "float16": (0.7, 1e-3, 8.3, 9.1, 10.7)}
# the hand kernel's times by a checkout's own wrapper (``root``/src), the
# API every version of it has: the single step into a new buffer and in
# place, and k = 2-4 in place, at each storage dtype; one JSON line of ms
HAND_TIMES = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.core import teff
from repro_torch.kernels import diffusion3d
shape, args, iters = json.loads(sys.argv[2]), json.loads(sys.argv[3]), int(sys.argv[4])
gen = torch.Generator(device="cuda").manual_seed(11)
out = {}
for name, sc in args.items():
    dt = getattr(torch, name)
    T = torch.rand(shape, generator=gen, device="cuda").to(dt)
    Ci = (torch.rand(shape, generator=gen, device="cuda") + 0.5).to(dt)
    T2 = T.clone()
    out[name + "/k1"] = teff.measure(lambda: diffusion3d.diffusion3d_step(
        T2, T, Ci, *sc, alias=False), iters=iters, warmup=3).median_s * 1e3
    for k in (1, 2, 3, 4):
        out[name + "/k%d/in_place" % k] = teff.measure(lambda: diffusion3d.diffusion3d_step(
            T2, T, Ci, *sc, nsteps=k, alias=True), iters=iters, warmup=3).median_s * 1e3
    del T, T2, Ci
print(json.dumps(out))
"""


def hand_times(root: str, iters: int) -> dict:
    """:data:`HAND_TIMES` run by the checkout at ``root`` in a process of its
    own (its build directory, its wrapper and source)."""
    done = subprocess.run([sys.executable, "-c", HAND_TIMES, str(root), json.dumps(HAND_SHAPE),
                           json.dumps(HAND_ARGS), str(iters)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"hand times at {root} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def hand_variant(text: str, ci: bool | None = None, cap: int | None = None,
                 rows: int | None = None) -> str:
    """The hand kernel's source with a choice of its k-step layout fixed,
    each None keeping the source's own: ``ci`` (True every k-step instance
    stages Ci through its ring, False each sweep reads it: ``stage_ci``),
    ``cap`` (``kMaxResident``), ``rows`` (the tile's rows, ``tile_rows``)."""
    subs = []
    if ci is not None:
        subs.append((r"(constexpr bool stage_ci\(int k, int bytes\) \{\n  return )[^;]*;",
                     rf"\g<1>{'true' if ci else 'false'};"))
    if cap is not None:
        subs.append((r"constexpr int kMaxResident = \d+;", f"constexpr int kMaxResident = {cap};"))
    if rows is not None:
        subs.append((r"(constexpr int tile_rows\(int k, int bytes\) \{\n  return )[^;]*;",
                     rf"\g<1>{rows};"))
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise RuntimeError(f"{pattern!r} not found in the hand kernel's source")
    return text


# elements past the allocator's address a new output buffer is also timed at
# (the single step into a buffer of its own, beside in place)
HAND_PADS = (0, 2048, 32768, 1 << 20)
# the hand kernel's k-step variants tuned beside its own: each changes one
# choice of the source (hand_variant's keywords)
HAND_VARIANTS = {"own": {}, "ci-ldg": {"ci": False}, "b3": {"cap": 3},
                 "rows16": {"rows": 16}, "rows24": {"rows": 24}, "rows32": {"rows": 32}}


def hand_ptxas(log: str, dtype: str, k: int, pairs: bool = False) -> dict:
    """ptxas's registers and spill bytes of the hand kernel's instance at
    ``dtype`` and k steps; k = 1: the single step of the pair layout or the
    one-cell one, in place and (``copy_``) the instance that copies T2's
    ring into a buffer of its own."""
    mangled = HAND_MANGLED[dtype]
    names = ({"": f"diffusion3d_steps_kernelILi{k}E{mangled}E"} if k > 1 else
             {pre: f"diffusion3d_{'pairs_' if pairs else ''}kernelILb{b}E{mangled}E"
              for pre, b in (("", 0), ("copy_", 1))})
    out = {}
    for part in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        for pre, name in names.items():
            if name in part.split("\n", 1)[0]:
                out.update({pre + key: v for key, v in ptxas(part).items()})
    return out


def sass_function(text: str, name: str) -> str:
    """The SASS of the one function of ``cuobjdump -sass`` output whose
    mangled name matches the regular expression ``name``."""
    parts = re.split(r"(?=\n\s*Function : )", text)
    found = [p for p in parts if re.search(r"Function : \S*" + name, p)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions match {name!r} in the SASS")
    return found[0]


_SASS_STORE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?STG(\S*)")
HAND_MANGLED = {"float32": "f", "bfloat16": "13__nv_bfloat16", "float16": "6__half"}
_HAND_KINDS = {"fp32": ("FADD", "FMUL", "FFMA"), "packed": ("HADD2", "HMUL2", "HFMA2"),
               "convert": ("F2F", "F2FP"), "moves": ("PRMT",), "integer": _INTEGER,
               "shared": ("LDS", "STS", "LDGSTS"), "loads": ("LDG",), "stores": ("STG",)}


def sass_hand(text: str, dtype: str, k: int) -> list:
    """SASS instructions a cell of the hand kernel's instance at ``dtype``
    and k steps, by class (F2F/F2FP conversions, HADD2/HMUL2/HFMA2 packed
    arithmetic, PRMT word moves, ...), in its march loop (the widest
    backward branch): k = 1 the single step's loop of each layout (in place)
    over its cells a thread an iteration; k > 1 each barrier segment (the
    landing of the step's staged planes, each sweep, the first with the next
    step's copies, then the last sweep) over its cells a thread a step."""
    from ..kernels import diffusion3d

    mangled = HAND_MANGLED[dtype]
    if k == 1:        # cells an iteration: counted from its stores below
        kernels = [("diffusion3d_kernelILb0E", ["cells"], [None])]
        if dtype != "float32":
            kernels.append(("diffusion3d_pairs_kernelILb0E", ["pairs"], [None]))
    else:
        rows = diffusion3d.tile_rows(k, torch.finfo(getattr(torch, dtype)).bits // 8)
        h_rounds = [-(-(32 + 2 * h) * (rows + 2 * h) // 256) for h in range(k + 1)]
        kernels = [(f"diffusion3d_steps_kernelILi{k}E",
                    ["land"] + [f"sweep{k - 1 - h}" for h in range(k - 1, -1, -1)],
                    [2 * h_rounds[k]] + [2 * h_rounds[h] for h in range(k - 1, -1, -1)])]
    out = []
    for kern, names, cells in kernels:
        fn = sass_function(text, f"{kern}{mangled}E")
        ins = [(int(m.group(1), 16), m.group(3), m.group(4))
               for m in map(_SASS_LINE.match, fn.splitlines()) if m]
        back = [(int(t, 16), a) for a, op, arg in ins if op == "BRA"
                for t in re.findall(r"0x([0-9a-f]+)\s*$", arg) if int(t, 16) < a]
        lo, hi = max(back, key=lambda b: b[1] - b[0])
        body = [(a, op) for a, op, _ in ins if lo <= a <= hi]
        bars = [a for a, op in body if op == "BAR"]
        edges = [lo, *[b + 16 for b in bars], hi + 16]
        for name, n, (s0, s1) in zip(names, cells, zip(edges, edges[1:])):
            ops = [op for a, op in body if s0 <= a < s1]
            if n is None:     # the single step's loop, unrolled: a store a cell (a word
                # a pair of cells: the pair layout's 2-byte stores are its edge words)
                pairs = name == "pairs"
                n = (2 if pairs else 1) * max(1, sum(
                    1 for m in map(_SASS_STORE.match, fn.splitlines())
                    if m and s0 <= int(m.group(1), 16) < s1
                    and not (pairs and ".U16" in m.group(2))))
            out.append({"kernel": kern, "segment": name, "instructions": len(ops),
                        "cells_per_thread": n, "per_cell": {
                            "all": len(ops) / n, **{c: sum(op in kinds for op in ops) / n
                                                    for c, kinds in _HAND_KINDS.items()}}})
    return out


def off_word(t: torch.Tensor) -> torch.Tensor:
    """A copy of a 2-byte tensor two bytes off a 4-byte word."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def tune_hand(iters: int, waves: list | None, against: str | None, sass: str | None,
              ks: list | None) -> None:
    """One JSON line per timing of the hand kernel at 512^3: with
    ``against`` (a checkout of another version, e.g. the parent commit)
    both versions' :data:`HAND_TIMES` in turns (other, this, this, other);
    then for each dtype and k (``ks``, default 1-4) each variant of this
    source in place (:data:`HAND_VARIANTS`: the Ci choice, the resident
    cap, the tile's rows; those two blocks of
    which would not fit are skipped; with the source's own choices
    ``waves``, the values of ``PAIR_WAVES`` or ``STEPS_WAVES`` to time),
    each launch held bitwise against the plain version, with its shared
    memory and ptxas's registers and spills; with ``sass`` each instance's
    SASS counted a cell by segment (:func:`sass_hand`)."""
    from ..kernels import diffusion3d, ref

    root = pathlib.Path(__file__).resolve().parents[3]
    if against:
        runs = []
        for where in (against, root, root, against):
            runs.append({"root": str(where), "ms": hand_times(str(where), iters)})
            print(json.dumps({"hand_turn": len(runs), **runs[-1]}), flush=True)
        mine = {k: (runs[1]["ms"][k] + runs[2]["ms"][k]) / 2 for k in runs[1]["ms"]}
        other = {k: (runs[0]["ms"][k] + runs[3]["ms"][k]) / 2 for k in runs[0]["ms"]}
        print(json.dumps({"hand_in_turns": {k: {"this": mine[k], "other": other[k],
                                                "ratio": mine[k] / other[k]} for k in mine}}),
              flush=True)
    text = build.read_source(diffusion3d.SOURCE)
    variants = {n: hand_variant(text, **kw) for n, kw in HAND_VARIANTS.items()}
    names = {n: f"diffusion3d_{n.replace('-', '_')}" for n in variants}
    t0 = time.perf_counter()
    logs = dict(zip(variants, build.compile_many([(names[n], v)
                                                  for n, v in variants.items()])))
    print(json.dumps({"built": len(variants), "seconds": time.perf_counter() - t0}), flush=True)
    libs = {n: build.Library(names[n], v, diffusion3d._ARGTYPES) for n, v in variants.items()}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in HAND_DTYPES:
        dt = getattr(torch, dtype)
        item = dt.itemsize
        T = torch.rand(HAND_SHAPE, generator=gen, device="cuda").to(dt)
        Ci = (torch.rand(HAND_SHAPE, generator=gen, device="cuda") + 0.5).to(dt)
        T2 = T.clone()
        args = HAND_ARGS[dtype]
        for k in ks or (1, 2, 3, 4):
            want = ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k)
            row = {}
            for n in (["own"] if k == 1 else variants):
                kw = HAND_VARIANTS[n]
                ci = kw.get("ci", diffusion3d.stage_ci(k, item))
                cap = kw.get("cap", diffusion3d.MAX_RESIDENT)
                rows = kw.get("rows", diffusion3d.tile_rows(k, item))
                if k > 1 and 2 * diffusion3d.shared_bytes(k, item, ci, rows) > 232448:
                    continue                       # one block: the two-block rule refuses it
                for pairs in ([False, True] if k == 1 and item == 2 else [False]):
                    # in place, as the main path runs it; the one-cell layout at 2
                    # bytes on fields two bytes off a word, which the pair rule refuses
                    fs = ([off_word(t) for t in (T2, T, Ci)] if k == 1 and item == 2
                          and not pairs else [T2.clone(), T, Ci])
                    if k == 1 and diffusion3d.pairs_fit(HAND_SHAPE[2], *fs) != pairs:
                        raise RuntimeError("the fields do not take the layout timed")
                    for w in (waves or [None]) if n == "own" else [None]:
                        launch = diffusion3d.column_launch(HAND_SHAPE, n_sm, k, item, pairs, w,
                                                           ci, cap, rows)

                        def run(launch=launch, n=n, fs=fs):
                            diffusion3d.launch_on(libs[n], launch, fs[0], *fs, args, k)

                        fs[0].copy_(T2)
                        run()
                        if not torch.equal(fs[0], want):
                            raise RuntimeError(f"hand {dtype} k={k} {n} pairs={pairs} waves={w}:"
                                               " not bitwise equal to the plain version")
                        ms = teff.measure(run, iters=iters, warmup=3).median_s * 1e3
                        tag = f"{n}{'/pairs' if pairs else '/cells' if k == 1 else ''}/w{w or '-'}"
                        # and into a buffer of its own (T2's ring copied), at the
                        # allocator's address and at addresses ``pad`` elements past it
                        for pad in (HAND_PADS if k == 1 else ()):
                            buf = torch.empty(fs[0].numel() + pad, dtype=dt, device="cuda")
                            own_out = buf[pad:].view(HAND_SHAPE)

                            def run_new(launch=launch, n=n, fs=fs, own_out=own_out):
                                diffusion3d.launch_on(libs[n], launch, own_out, *fs, args, 1)

                            run_new()
                            if not torch.equal(own_out, want):
                                raise RuntimeError(f"hand {dtype} {n} pairs={pairs} waves={w}:"
                                                   " not bitwise equal into a new buffer")
                            row[f"{tag}/new_buffer+{pad}"] = {
                                "ms": teff.measure(run_new, iters=iters, warmup=3).median_s * 1e3,
                                "offset_mod_2^28": (own_out.data_ptr() - fs[1].data_ptr())
                                % (1 << 28)}
                            del buf, own_out
                        row[tag] = {"ms": ms, "ms_per_step": ms / k,
                                    "smem_bytes": diffusion3d.shared_bytes(k, item, ci, rows),
                                    **hand_ptxas(logs[n].log, dtype, k, pairs)}
            print(json.dumps({"hand": dtype, "k": k, "in_place": True, "variants": row}),
                  flush=True)
        del T, T2, Ci
        torch.cuda.empty_cache()
    if sass:
        pathlib.Path(sass).mkdir(parents=True, exist_ok=True)
        path = pathlib.Path(sass) / "diffusion3d.sass"
        if write_sass(build.library_path(names["own"], variants["own"]), path):
            text = path.read_text()
            for dtype in HAND_DTYPES:
                for k in ks or (1, 2, 3, 4):
                    print(json.dumps({"hand_sass": dtype, "k": k,
                                      "per_cell": sass_hand(text, dtype, k)}), flush=True)


# batched layouts (``StencilCall(batched=)``) tried, by rank and whether the
# program has stages: (z, y) cells, planes per step, resident blocks (at
# most 2048 threads an SM)
BATCHED_STAGED_3D = [Shape(t, p, b) for t in ((32, 8), (32, 4), (64, 4)) for p in (2, 4)
                     for b in (3, 4, 5, 6)]
BATCHED_2D = [Shape(t, p, b) for t in ((128, 1), (256, 1), (512, 1)) for p in (2, 4)
              for b in (3, 4, 5, 6, 8) if b * t[0] <= 2048]
# the column march of a 3-D program without stages (``kernels/codegen_columns.py``):
# (z, y) cells, planes of the march unrolled, resident blocks, planes the loads
# run ahead
COLUMN_3D = [Shape(t, p, b, column=True, ahead=a) for t in ((32, 8), (64, 4))
             for p, b, a in ((2, 8, 0), (2, 8, 2), (2, 6, 0), (2, 5, 0), (2, 4, 0), (2, 4, 2),
                             (2, 4, 4), (4, 4, 2))]
# the one-cell layouts the serving step took before the column march (the
# fastest of that sweep), by reductions and whether the fields are stored at
# 4 bytes: the baseline the split and chip_smoke time the column march beside
ONE_CELL = {(False, True): Shape((32, 8), 2, 6), (True, True): Shape((32, 8), 2, 8),
            (False, False): Shape((32, 8), 2, 6), (True, False): Shape((32, 8), 2, 6)}
BATCH = 16
BATCH_WAVES_TRIED = (4, 8, 16, 24)
COLUMN_WAVES_TRIED = (4, 8, 16)
# the split's (samples, grid extent): one 512^3 sample beside the solo step,
# the serving bucket at 16 and 64 samples, the small bucket
BATCH_SPLIT = ((1, 512), (16, 128), (64, 128), (8, 64))


def batched_kernels(dev) -> dict:
    """``name: (kernel, base shape, porosity)`` on ``dev`` of the batched programs at
    ``BATCH`` samples a launch: the serving demo's diffusion step (128^3)
    plain and with its ``max_abs_diff`` check and the finite guard that
    ``iterate.make_batched_solver`` adds, porosity's fused update with its
    check (1024^2) and GP's with its mass sums (128^3)."""
    from ..core import iterate
    from ..ir import Reduction
    from ..serve.procworker import demo_kernel

    serve = demo_kernel(dev)
    out = {"serve": (serve.with_reductions(None), (128,) * 3, False),
           "serve+guard": (serve.with_reductions(dict(serve.reductions, **{
               iterate.GUARD_NAME: Reduction("finite", serve.outputs[0])})), (128,) * 3, False)}
    for name, mod, cfg, base, red, kw in (
            ("porosity_fused[neumann0]+err", pw, pw.PorosityConfig, (1024, 1024),
             {"err": "max_abs_diff(Pe2, Pe)"}, {"bc": "neumann"}),
            ("gp_fused[none]+mass", gp, gp.GPConfig, (128,) * 3,
             {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}, {})):
        c = cfg(n=base[0], device=torch.device(dev).type, **kw)
        out[name] = (mod.make_step(mod.make_grid(c), c).kernels[0].with_reductions(red), base,
                     name.startswith("porosity"))
    return out


def one_cell(program, dtype: torch.dtype) -> Shape:
    """The one-cell batched layout of a 3-D program without stages before
    the column march (:data:`ONE_CELL`)."""
    return ONE_CELL[(bool(program.reductions), dtype.itemsize == 4)]


def batched_candidates(program, dtype: torch.dtype = torch.float32) -> list:
    """The layouts :func:`tune_batched` times: for a 3-D program without
    stages its one-cell baseline and the column march's candidates, else
    the one-cell layouts of its rank."""
    if program.ndim == 3 and not program.stages:
        return [one_cell(program, dtype), *COLUMN_3D]
    return BATCHED_STAGED_3D if program.ndim == 3 else BATCHED_2D


def waves_tried(shape) -> tuple:
    return COLUMN_WAVES_TRIED if shape.column else BATCH_WAVES_TRIED


def serve_batch(k, base, porosity, gen, dev, nb: int, dtype: torch.dtype, serve: bool = True):
    """``(bufs, scalars, live, odd)`` of ``nb`` all-live samples of both
    parities: the serving step's (``serve``) fields at a tenth of
    ``random_fields``' and its dt per sample, another program's at their
    own."""
    bufs = random_fields(k, base, porosity, gen, dev, (nb,))
    if serve:
        bufs = {f: 0.1 * t for f, t in bufs.items()}
        scalars = [{"dt": 0.08 + 0.005 * (i % 4)} for i in range(nb)]
    else:
        scalars = [scalars_of(k)] * nb
    live = torch.ones(nb, dtype=torch.bool, device=dev)
    odd = torch.tensor([i % 2 == 1 for i in range(nb)], device=dev)
    return {f: t.to(dtype) for f, t in bufs.items()}, scalars, live, odd


def batch_bound_ms(call, nb: int) -> float:
    """The least time the card could take for one launch of the batched
    ``call`` over ``nb`` live samples: the bytes of each sample's step over
    3.35 TB/s (``teff.H100_BYTES_PER_S``), for a plain all-parallel update
    the cells it reads and writes (``teff.sample_step_cost``), for any other
    every field it reads and writes once (``teff.a_eff_from_ir``)."""
    try:
        nbytes = teff.sample_step_cost(call)[0]
    except ValueError:
        nbytes = teff.a_eff_from_ir(call.ir, call.dtype.itemsize)
    return nb * nbytes / teff.H100_BYTES_PER_S * 1e3


def held_to_plain(t, bufs, scalars, live, odd, want, r_want, params) -> bool:
    """One launch of batched call ``t`` on copies of ``bufs`` against the
    plain version's ``want`` and ``r_want``: fields bitwise, max reductions
    bitwise, sums within 1e-5."""
    got = {f: x.clone() for f, x in bufs.items()}
    r_got = t.run_batch(got, scalars, live, odd, 0, params)
    return all(torch.equal(got[f], want[f]) for f in got) and all(
        torch.equal(r_got[m], r_want[m]) if r.combine == "max" else
        torch.allclose(r_got[m], r_want[m], rtol=1e-5, atol=0.0)
        for m, r in t.program.reductions)


def tune_batched(iters: int, names: list | None = None, dtype: torch.dtype = torch.float32,
                 chunk: bool = True, sass: str | None = None) -> None:
    """Each batched program (:func:`batched_kernels`) at ``BATCH`` samples
    in every layout of :func:`batched_candidates` and each of its waves
    (``BATCH_WAVES_TRIED``; for the column march ``COLUMN_WAVES_TRIED``):
    the CUDA-event median ms of the kernel alone (``StencilCall.batch_launcher``) and
    of ``run_batch`` (``call_ms``: the launch and the wrapper's host work,
    the finish of its per-sample reductions too) on all-live samples of both
    parities, the chunk planes ``xc``, ptxas's registers and spills, each
    launch held to
    the plain version (``codegen.evaluate_batch_torch``: fields bitwise, max
    reductions bitwise, sums within 1e-5; one that differs is marked
    ``differs`` and not timed); one JSON line a program, beside
    ``codegen.batch_shape`` and its waves (``stencil.BATCH_WAVES``,
    ``BATCH_WAVES_NARROW`` at 2 bytes, ``BATCH_COLUMN_WAVES``), which are
    this tool's choice. Then the split (:func:`batch_split`), with ``sass``
    the SASS counts of its kernels' march loops, and with ``chunk`` one
    serving chunk of the demo (:func:`serve_chunk`). The fields are stored
    as ``dtype`` (rounded once from the f32 ones)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    todo = batched_kernels(dev)
    todo = {n: (k.with_dtype(dtype), base, por) for n, (k, base, por) in todo.items()
            if not names or n in names}
    tuned, best = {}, {}
    for n, (k, base, _) in todo.items():
        call = k.batched_call(**field_shapes(k, base), **scalars_of(k))
        tuned[n] = (call, [stencil.StencilCall(call.ir, k.label, k.bc, shape,
                                               batched=k.rotations, dtype=dtype)
                           for shape in batched_candidates(call.program, dtype)])
    t0 = time.perf_counter()
    logs = iter(build.compile_many([(t.lib_name, t.source) for _, ts in tuned.values()
                                    for t in ts]))
    print(json.dumps({"built": sum(len(ts) for _, ts in tuned.values()),
                      "seconds": time.perf_counter() - t0}), flush=True)
    for n, (k, base, porosity) in todo.items():
        call, variants = tuned[n]
        bufs, scalars, live, odd = serve_batch(k, base, porosity, gen, dev, BATCH, dtype,
                                               n.startswith("serve"))
        want = {f: t.clone() for f, t in bufs.items()}
        r_want = codegen.evaluate_batch_torch(call.program, call.batched, want, scalars, live, odd)
        row = {}
        for t in variants:
            found = ptxas(next(logs).log)
            params = t.batch_params(scalars, dev)
            attr = stencil.waves_attr(t.shape, False, dtype.itemsize)
            default_waves = getattr(stencil, attr)
            for w in waves_tried(t.shape):
                setattr(stencil, attr, w)
                t._batch_launches.clear()
                if not held_to_plain(t, bufs, scalars, live, odd, want, r_want, params):
                    # recorded, not timed: the sweep goes on to the other layouts
                    row[f"{layout_name(t.shape)}/w{w}"] = {"differs": True, **found}
                    continue
                ms = teff.measure(t.batch_launcher(bufs, params, live, odd), iters=iters,
                                  warmup=3).median_s * 1e3
                call_ms = teff.measure(lambda: t.run_batch(bufs, scalars, live, odd, 0, params),
                                       iters=iters, warmup=3).median_s * 1e3
                launch = t.derive(stencil.sm_count(dev), samples=BATCH)
                row[f"{layout_name(t.shape)}/w{w}"] = {"ms": ms, "call_ms": call_ms,
                                                       "xc": launch.xc,
                                                       "blocks": launch.n_blocks, **found}
            setattr(stencil, attr, default_waves)
            t._batch_launches.clear()
        del bufs, want
        fastest = min(((v["ms"], k) for k, v in row.items()
                       if "ms" in v and not v["spill_bytes"] and "/col" in k), default=None)
        if fastest is not None and n.startswith("serve"):
            t = next(t for t in variants if fastest[1].startswith(layout_name(t.shape) + "/w"))
            best[n] = (t.shape, int(fastest[1].rsplit("/w", 1)[1]))
        waves = stencil.waves_of(call.shape, False, dtype.itemsize)
        print(json.dumps({"kernel": n, "dtype": str(dtype), "samples": BATCH, "base": list(base),
                          "bound_ms": batch_bound_ms(call, BATCH),
                          "chosen": f"{layout_name(call.shape)}/w{waves}",
                          "candidates": row}), flush=True)
    if not names or any(n.startswith("serve") for n in names):
        batch_split(iters, dtype, sass, best)
    if chunk:
        print(json.dumps({"chunk": serve_chunk()}), flush=True)


def sass_loads(text: str) -> dict:
    """Global loads of a kernel's SASS by kind: ``LDG.E`` (through L1) and
    ``LDG.E.CONSTANT`` (the read-only path, ``__ldg``)."""
    ops = re.findall(r"\bLDG\.E(?:\.[A-Z0-9_]+)*", text)
    return {"LDG.E": sum(".CONSTANT" not in o for o in ops),
            "LDG.E.CONSTANT": sum(".CONSTANT" in o for o in ops)}


_SASS_OP = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def sass_column_loop(text: str, planes: int) -> dict:
    """The column march's core loop in SASS (``cuobjdump -sass``): of the
    backward branches, the widest loop that stores and loads only through
    the read-only path (the loops of the planes outside the core load the
    direct program's taps through L1), and its instructions and global
    loads a cell, over the ``planes`` it unrolls."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3))
           for m in map(_SASS_OP.match, text.splitlines()) if m]
    loops = [(int(t, 16), a) for a, op, arg in ins if op.startswith("BRA")
             for t in re.findall(r"0x([0-9a-f]+)\s*$", arg) if int(t, 16) < a]
    best = []
    for lo, hi in loops:
        body = [op for a, op, _ in ins if lo <= a <= hi]
        plain = any(op.startswith("LDG") and "CONSTANT" not in op for op in body)
        if any(op.startswith("STG") for op in body) and not plain and len(body) > len(best):
            best = body
    if not best:
        return {}
    return {"instructions": len(best) / planes,
            "loads": sum(op.startswith("LDG") for op in best) / planes,
            "integer": sum(op.split(".")[0] in _INTEGER for op in best) / planes,
            "fp": sum(op.split(".")[0] in ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL")
                      for op in best) / planes}


def batch_split(iters: int, dtype: torch.dtype = torch.float32, sass: str | None = None,
                best: dict | None = None) -> None:
    """The serving step, plain and guarded, at each of ``BATCH_SPLIT``'s
    (samples, extent), all samples live: the CUDA-event median ms (the
    kernel alone, and ``call_ms`` through ``run_batch``) of the
    one-cell layout it took before the column march (:data:`ONE_CELL`, at
    ``BATCH_WAVES``) and of ``codegen.batch_shape``'s layout at its waves
    (or ``best[name]``'s ``(layout, waves)``, the sweep's fastest without
    spills), in turns over two rounds, each beside its bound
    (:func:`batch_bound_ms` of the live samples) and launch; at one 512^3
    sample also the solo step of the same program (``kernel.compiled``).
    Every launch is held to the plain version first. With ``sass`` each
    library's SASS goes to that directory, and the line counts its march
    loop's instructions a cell (:func:`sass_loop`) and its global loads by
    kind (:func:`sass_loads`)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261019)
    todo = {n: v for n, v in batched_kernels(dev).items() if n.startswith("serve")}
    calls, waves = {}, {}
    for n, (k, _, _) in todo.items():
        k = k.with_dtype(dtype)
        shp = field_shapes(k, (8, 8, 8))
        new = k.batched_call(**shp, **scalars_of(k))
        if best and n in best:
            new = stencil.StencilCall(new.ir, k.label, k.bc, best[n][0], batched=k.rotations,
                                      dtype=dtype)
        waves[n] = best[n][1] if best and n in best else \
            stencil.waves_of(new.shape, False, dtype.itemsize)
        old = stencil.StencilCall(new.ir, k.label, k.bc, one_cell(new.program, dtype),
                                  batched=k.rotations, dtype=dtype)
        calls[n] = {"one_cell": old, "column": new}
    t0 = time.perf_counter()
    flat = [c for cs in calls.values() for c in cs.values()]
    builds = build.compile_many([(c.lib_name, c.source) for c in flat])
    found = {c.lib_name: ptxas(b.log) for c, b in zip(flat, builds)}
    print(json.dumps({"split_built": len(flat), "seconds": time.perf_counter() - t0}), flush=True)
    counts = {}
    if sass and cuobjdump():
        pathlib.Path(sass).mkdir(parents=True, exist_ok=True)
        for n, cs in calls.items():
            for v, c in cs.items():
                path = pathlib.Path(sass) / f"batched_{n}_{v}_{dtype_name(dtype)}.sass"
                write_sass(build.library_path(c.lib_name, c.source), path)
                text = path.read_text()
                loop = (sass_column_loop(text, c.shape.planes) if c.shape.column
                        else sass_loop(text, c.shape.planes)["per_cell"])
                counts[(n, v)] = {"per_cell": loop, **sass_loads(text)}
    n_sm = stencil.sm_count(dev)
    for nb, n in BATCH_SPLIT:
        for name, (k, _, _) in todo.items():
            k = k.with_dtype(dtype)
            runs = {}
            for v, proto in calls[name].items():
                runs[v] = stencil.StencilCall(k.batched_call(**field_shapes(k, (n,) * 3), dt=1.0).ir,
                                              k.label, k.bc, proto.shape, batched=k.rotations,
                                              dtype=dtype)
            attr = stencil.waves_attr(runs["column"].shape, False, dtype.itemsize)
            default_waves = getattr(stencil, attr)
            setattr(stencil, attr, waves[name])
            bufs, scalars, live, odd = serve_batch(k, (n,) * 3, False, gen, dev, nb, dtype)
            want = {f: t.clone() for f, t in bufs.items()}
            first = runs["column"]
            r_want = codegen.evaluate_batch_torch(first.program, first.batched, want, scalars,
                                                  live, odd)
            params = first.batch_params(scalars, dev)
            for v, t in runs.items():
                if not held_to_plain(t, bufs, scalars, live, odd, want, r_want, params):
                    raise RuntimeError(f"{t.label} {v} at {nb} x {n}^3 differs from its plain "
                                       "version")
            del want
            ms = {v: [] for v in runs}
            call_ms = {v: [] for v in runs}
            for _ in range(2):
                for v, t in runs.items():
                    ms[v].append(teff.measure(t.batch_launcher(bufs, params, live, odd),
                                              iters=iters, warmup=3).median_s * 1e3)
                    call_ms[v].append(teff.measure(
                        lambda: t.run_batch(bufs, scalars, live, odd, 0, params), iters=iters,
                        warmup=3).median_s * 1e3)
            bound = batch_bound_ms(first, nb)
            row = {"kernel": name, "dtype": str(dtype), "samples": nb, "base": [n] * 3,
                   "bound_ms": bound}
            for v, t in runs.items():
                launch = t.derive(n_sm, samples=nb)
                row[v] = {"layout": layout_name(t.shape), "ms": ms[v], "call_ms": call_ms[v],
                          "share": bound / min(ms[v]), "grid": list(launch.grid),
                          "xc": launch.xc, "blocks": launch.n_blocks,
                          "ptxas": found[calls[name][v].lib_name],
                          "sass": counts.get((name, v))}
            if nb == 1:
                solo = k.with_reductions(k.reductions).compiled(**field_shapes(k, (n,) * 3),
                                                                dt=1.0)
                fields = {f: t[0] for f, t in bufs.items()}
                sc = scalars[0]
                solo_ms = [teff.measure(lambda: solo.run(fields, sc), iters=iters,
                                        warmup=3).median_s * 1e3 for _ in range(2)]
                row["solo"] = {"layout": layout_name(solo.shape), "ms": solo_ms,
                               "share": bound / min(solo_ms)}
            row["column"]["waves"] = waves[name]
            setattr(stencil, attr, default_waves)
            print(json.dumps({"batch_split": row}), flush=True)
            del bufs


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@contextlib.contextmanager
def one_cell_batched():
    """``codegen.BATCHED`` with the serving step's one-cell layouts
    (:data:`ONE_CELL`) in place of the column march while the block runs:
    the batched calls made inside keep them."""
    keys = [k for k in codegen.BATCHED if k[:2] == (3, False)]
    saved = {k: codegen.BATCHED[k] for k in keys}
    codegen.BATCHED.update({k: ONE_CELL[k[2:]] for k in keys})
    try:
        yield
    finally:
        codegen.BATCHED.update(saved)


def serve_chunk(rounds: int = 5) -> dict:
    """One serving chunk at B = 16 x 128^3 through ``BatchEngine.run_chunk``,
    samples that never converge, in two engines: the column march
    (``codegen.BATCHED``) and the one-cell layout it replaced
    (:func:`one_cell_batched`), in turns (column, one-cell, then the other
    way round). For each, by layout: the wall ms of each of ``rounds``
    chunks to a synchronisation, the host's ms to enqueue a chunk, a
    chunk's device ms between two CUDA events, and the layouts its plain
    and checked launches took."""
    import numpy as np

    from ..core import iterate
    from ..ir import Reduction
    from ..serve import RequestQueue, ServePolicy, SolveRequest
    from ..serve.engine import BatchEngine
    from ..serve.procworker import demo_kernel

    n = 128
    pol = ServePolicy(max_batch=BATCH, chunk_steps=64, check_every=4)
    engines = {}
    for v, ctx in (("column", contextlib.nullcontext), ("one_cell", one_cell_batched)):
        kern = demo_kernel("cuda")
        q = RequestQueue(64)
        tickets = []
        for i in range(BATCH):
            T = np.zeros((n, n, n), np.float32)
            T[n // 2, n // 2, n // 2] = 1.0 + 0.1 * i
            tickets.append(q.submit(SolveRequest(fields={"T": T, "T2": T.copy()},
                                                 scalars={"dt": 0.08 + 0.005 * (i % 4)},
                                                 tol=1e-12, max_iters=10 ** 6)))
        with ctx():     # the first chunk makes the engine's batched calls
            eng = BatchEngine(kern, pol)
            state = eng.start(tickets)
            eng.run_chunk(state)
        # the calls the chunk launched (memoized on the kernel's variants)
        checked = kern.with_reductions(dict(kern.reductions, **{
            iterate.GUARD_NAME: Reduction("finite", "T2")}))
        layouts = {name: layout_name(k.batched_call(T2=(n,) * 3, T=(n,) * 3, dt=0.1).shape)
                   for name, k in (("plain", kern.with_reductions(None)), ("checked", checked))}
        torch.cuda.synchronize()
        engines[v] = (eng, state, {"layouts": layouts, "wall_ms": [], "host_enqueue_ms": [],
                                   "device_ms": []})
    for r in range(rounds):
        for v in (("column", "one_cell") if r % 2 == 0 else ("one_cell", "column")):
            eng, state, out = engines[v]
            t0 = time.perf_counter()
            eng.run_chunk(state)
            torch.cuda.synchronize()
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            eng.run_chunk(state)
            out["host_enqueue_ms"].append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            out["device_ms"].append(start.elapsed_time(end))
    for eng, state, _ in engines.values():
        eng.harvest(state)
    return {"samples": BATCH, "base": [n] * 3, "steps": pol.chunk_steps,
            "check_every": pol.check_every, **{v: e[2] for v, e in engines.items()}}


def scalars_of(kern) -> dict:
    """The kernel's scalars from :data:`SCALARS`."""
    names = inspect.signature(kern.fn).parameters
    return {n: v for n, v in SCALARS.items() if n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", default=None,
                    help="values of stencil.WAVES (with --steps: STEPS_WAVES) to time")
    ap.add_argument("--steps", action="store_true", help="tune the k-step kernels")
    ap.add_argument("--march", default=None,
                    help="tune the marched kernels along these axes, e.g. 0,1,2")
    ap.add_argument("--split", action="store_true",
                    help="time the all-parallel kernel in parts (with --march: the "
                         "contiguous-axis march)")
    ap.add_argument("--sass", default=None,
                    help="with --split or --batched: write each library's SASS into this "
                         "directory")
    ap.add_argument("--ks", default=None,
                    help="with --steps: the k to time, e.g. 1,2 (default: STEPS_KS)")
    ap.add_argument("--kernels", default=None,
                    help="only these kernels (names as printed, comma-separated)")
    ap.add_argument("--hand", action="store_true",
                    help="tune the hand diffusion3d kernel (csrc/diffusion3d.cu)")
    ap.add_argument("--against", default=None,
                    help="with --hand: a checkout of another version to time in turns")
    ap.add_argument("--batched", action="store_true",
                    help="tune the batched kernels (sample axis) and time a serving chunk")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "float16"],
                    help="the fields' storage dtype (compute stays f32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_stencil: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name, power = teff.card_info(0)
    print(json.dumps({"card": name, "power_limit": power, "dtype": args.dtype}), flush=True)
    if args.batched:
        tune_batched(args.iters, args.kernels.split(",") if args.kernels else None,
                     getattr(torch, args.dtype), args.dtype == "float32", args.sass)
        return 0
    if args.hand:
        tune_hand(args.iters, [int(w) for w in args.waves.split(",")] if args.waves else None,
                  args.against, args.sass, [int(x) for x in args.ks.split(",")] if args.ks
                  else None)
        return 0
    todo = kernels(dev, getattr(torch, args.dtype))
    if args.kernels:
        todo = {n: todo[n] for n in args.kernels.split(",")}
    if args.split and args.march:
        tune_split(todo, args.iters)
        return 0
    if args.split and args.steps:
        tune_steps_split(todo, args.iters, args.sass)
        return 0
    if args.split:
        todos = {args.dtype: todo}
        if args.dtype != "float32":     # beside the f32 twin
            todos["float32"] = kernels(dev, torch.float32)
        tune_split_parallel(todos, args.iters, sass=args.sass)
        return 0
    if args.march:
        tune_march(todo, [int(a) for a in args.march.split(",")],
                   [int(w) for w in args.waves.split(",")] if args.waves else None, args.iters,
                   [int(x) for x in (args.ks or "1,2").split(",")])
        return 0
    waves = [int(w) for w in (args.waves or ("2,4,8" if args.steps else "8,16,24,32"))
             .split(",")]
    if args.steps:
        tune_steps(todo, waves, args.iters,
                   [int(x) for x in args.ks.split(",")] if args.ks else None)
        return 0
    tuned, chosen = {}, {}
    for n, (k, _, f, sc) in todo.items():
        call = k.compiled(**f, **sc)
        chosen[n] = call.shape
        tuned[n] = []
        for shape in candidates(call):
            try:
                tuned[n].append(stencil.StencilCall(call.ir, k.label, k.bc, shape,
                                                    dtype=call.dtype))
            except (ValueError, NotImplementedError):   # pairs the extents do not fit
                continue

    t0 = time.perf_counter()
    logs = iter(build.compile_many([(t.lib_name, t.source) for ts in tuned.values()
                                    for t in ts]))
    print(json.dumps({"built": sum(map(len, tuned.values())),
                      "seconds": time.perf_counter() - t0}), flush=True)
    default_waves = stencil.WAVES
    for n, (k, plain, f, sc) in todo.items():
        want = plain(**f, **sc)
        want = want[0] if k.reductions else want
        want = {k.outputs[0]: want} if len(k.outputs) == 1 else want
        row = {}
        for t in tuned[n]:
            found = ptxas(next(logs).log)
            for w in waves:
                stencil.WAVES = w
                outs, _ = t.run(f, sc)
                if not all(torch.equal(outs[o], want[o]) for o in k.outputs):
                    raise RuntimeError(f"{t.label} at {t.shape}, {w} waves: not bitwise equal "
                                       "to the torch backend")
                ms = teff.measure(lambda: t.run(f, sc), iters=args.iters, warmup=3).median_s * 1e3
                row[f"{layout_name(t.shape)}/w{w}"] = {"ms": ms, **found}
        stencil.WAVES = default_waves
        print(json.dumps({"kernel": n, "chosen": f"{layout_name(chosen[n])}/w{default_waves}",
                          "candidates": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
