#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

It builds every CUDA kernel of the port from the sources in the checkout
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card, and drives the port's two main paths:
the paper's FIG1 (512^3 f32: 100 @parallel steps, the same steps with the
explicit kernel, then solve_until) and Zamba2-1.2B serving at full width
and depth (batch 4, a 1024-token prompt, 32 generated tokens, random
weights from a seed) through ``repro_torch.launch.serve``, whose prefill
runs the conv1d, SSD and attention kernels; the serving run's prefill
logits are held against the same run on the plain versions. The paper's two coupled solvers follow
through ``repro_torch.examples.porosity_waves`` (2-D, 8192^2: staggered
Darcy fluxes, every boundary condition, the flux-split scheme, a fixed run
and a ``--tol`` run) and ``repro_torch.examples.gross_pitaevskii`` (3-D,
512^3: the fused radius-2 update, every boundary condition, the two-launch
scheme, a fixed run and the drift-guarded run); each of their generated
kernels is first held bitwise against the ``torch`` backend at small odd
shapes and at those sizes. The k-step kernels (``run_steps(k)``: FIG1's
step, porosity's and GP's fused kernels for every in-launch bc with their
epilogues, a staggered rotation, k = 2-4; the hand kernel's ``nsteps``, in
place and not) are each held bitwise against k single-step launches at
small odd shapes and at full size, against their plain version (the
``torch`` backend's k steps, ``ref.diffusion3d_steps``) at full size on the
fields they are timed on, and against it where outputs and targets differ
on the ring; their main path is each solver's
own state advanced 12 steps as ``run_steps(k)`` launches, which must equal
12 single steps, with the launch counts set to 0 before each run and read
after. It then times
each kernel beside its plain version, the PyTorch library call that
computes the same function (where there is one) and its bound: for the
attention and SSD kernels, whose products run on the tensor cores at f32
accuracy (3xTF32), at 165 TFLOP/s, with the f32 CUDA-core bound beside it.
Every generated kernel must build without register spills; its time is
also given as a ratio to the hand ``diffusion3d`` kernel's in the same run,
GP's fused kernel is timed on the solver's own state too, and a
``targets`` line says which of the generated kernel's speed targets the run
met. ``times_k_steps`` gives each k-step kernel's ms per launch and per step
beside its bound per step (the launch's bytes over 3.35 TB/s or its
operations, halo cone included, over 67 TFLOP/s, whichever is larger),
the share of it, T_eff per step over the copy bandwidth, the layout
(tile, threads, planes per step, resident blocks), shared memory,
registers and spills, the halo cone (``halo_compute_overhead``), the
lead's share of a chunk, and whether a step of the launch takes no longer
than the single step of the same variant and dtype timed in the same run
(``at_most_single_step``; a k-step kernel is launched either way).

Then all of it with the fields stored bf16 and f16 (computed in f32): every
generated variant above (``check_mixed`` for FIG1's three and the generic
kernel, ``check_coupled`` and ``check_k_steps`` rows with a ``dtype``) held
bitwise against the ``torch`` backend at the same dtype at the small shapes
and at full size, k-step ones against k single-step launches, and the hand
kernel (``check_hand_steps``, k = 1-4, in place and not, computing at the
storage dtype) against its plain version at that dtype; the hand kernel's
packed bf16/f16 arithmetic against f32-then-round over every pair of 16-bit
operands (``check_packed_ops``), and its 2-byte single step on fields two
bytes off a word, its one-cell layout, against the pair layout and the
plain version (``check_hand_off_word``). An f16 field that
leaves its range must hold inf and NaN where the plain version does; the
rows count them. The mixed main path (``main_path_mixed``) drives FIG1 at
512^3 through ``init_parallel_stencil(dtype=...)`` and ``solve_until``
beside the f32 run (one step held to the f32 step within 4 eps max|T|, T_eff
at storage bytes), porosity 8192^2 ``--dtype`` through the twin's
``solve``, GP's fused kernel on its state, and the k-step main path at each
dtype, with the launch counts set to 0 before each run and read after;
``times_mixed`` gives each kernel's ms beside its bound at storage bytes,
its plain ms, registers and spills, the hand single step in its pair
layout beside its one-cell layout in turns, and ``hand_targets``.

Then ``march_axis`` streaming and the ``finite``/``nan_count`` reductions.
``check_march``: every generated variant above that can march (FIG1's
three and its guarded check, the generic kernel, the coupled fused kernels
with their bcs and epilogues, GP's two launches, the staggered rotation,
each k-step case) marched along each
axis no field of it is staggered along, bitwise to the ``torch`` backend at
small odd shapes, each ``run_steps(k)`` bitwise to k marched launches, FIG1,
porosity's and GP's fused kernels also at bf16 and f16 and at full size;
porosity's flux-split kernels must refuse every axis (staggered), and a
march of 3 planes must fall back to the all-parallel launch and say so.
``check_finite``: a health-guard kernel with NaN, inf and -inf at known
cells and 40000 where 2 T overflows f16 on store, at f32, bf16 and f16,
all-parallel, marched and k = 2: ``finite`` and ``nan_count`` equal to the
``torch`` backend's, counts exact. ``main_path_march``: FIG1 512^3 through
``quickstart.run(march_axis=a, guard=True)`` for each axis beside the
all-parallel run (bitwise, the same iterations; ms per step and T_eff over
the copy of ``solve_until``, host syncs), then FIG1's ``run_steps(k)`` and
porosity's and GP's fused kernels marched along each axis on the solvers'
own states, bitwise to their all-parallel steps. ``times_march``: each
marched kernel's ms beside its all-parallel twin in the same run, the
twin's bound, its plain ms, registers, spills, plane queue and the cost
model's streamed and refetched bytes at the port's own launch tile. Along
the contiguous axis every marched kernel, single step and k steps, is an
async slab (field queues filled by asynchronous copies a step ahead, the
outputs stored from a step buffer a step later); ``check_march`` rows and
``times_march`` name each kernel's layout, and ``times_march`` times each
contiguous-axis kernel beside its synchronous layout (the slab staged
through registers, or strided k-step loads and stores) on the same fields,
bitwise to each other, in turns (``sync_ms``).

Then the checkpointed main path (``main_path_checkpoint``): porosity's
--tol run at 8192^2 (cap 400 steps, a check every 10, a save every 10
checks) uninterrupted without and with checkpoints, then in a child process
under ``REPRO_FAULT_PLAN={"kill_at_step": 200}`` (exit code 113, LATEST at
200) and resumed here, all bitwise equal; the same kill and resume at bf16
through ``solve_until`` to its cap; GP's drift-guarded run at 512^3
checkpointed against its plain run. Each row gives the bytes per save, the
device-to-host snapshot, the loop's stall per save, the write seconds and
the ms per step with and without checkpoints. ``main_path_telemetry``
runs FIG1's ``solve_until`` at 512^3 with telemetry off and twice into a
JSONL log, which must validate under the port's schema, and prints the
warm solve's roofline fraction (the least time of its A_eff at the copy
bandwidth over the measured step, which must lie in (0, 1]) and T_eff.

Then the distributed runtime. ``main_path_distributed``: FIG1 512^3 on a
gang of 4 rank processes on the one card (2 x 2, gloo, halos staged
through pinned host buffers; every kernel the ranks launch is built here
first), through ``elastic_solve_until`` with ``overlapped_step`` to the
error one process reaches after 50 steps: the gathered fields, the
iterations and the error bitwise equal to one process's ``solve_until``;
``sequential_step`` against ``overlapped_step`` bitwise; ``multi_step(k=2)``
on 2-deep ghost rings against two single steps on the owned interior; the
bf16 and int8 wires within their bounds; each rank's ms per step of both
steps, its exchange's parts and its bytes on the wire, beside the card's
name and power limit (four processes take turns on one card: these times
measure the protocol, not the paper's scaling). ``main_path_distributed_gp``:
GP 512^3 on 2 ranks along x, fields bitwise, sums within 1e-5.
``main_path_multihost``: the launcher's supervised drill (``python -m
repro_torch.launch.multihost --demo --world 4 --backend gloo --kill-rank 1
--kill-at 20 --device cuda`` at 130^3) must exit 113, replan to 2 ranks,
resume at 20 and equal an uninterrupted run within 1e-5. ``nccl``: a
world-1 NCCL group runs the periodic self-wrap and the check's all-reduce,
bitwise to the same solve without a group, and two NCCL ranks on this one
card are refused with a pointed error. ``times_distributed`` times every
(kernel, shape) the gangs launched beside its torch-backend twin.

It prints JSON lines; the line before the last lists the kernels, the one
before that is the card's name and power limit as nvidia-smi gives them,
and the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without a card, or without the repository
beside it, it exits non-zero at once.
"""
import collections
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(33, 20, 130), (64, 64, 64), (512, 512, 512)]
ALL_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}
ERR = {"err": "max_abs_diff(T2, T)"}
# Sums fold in another order than torch.sum; every addend here is positive,
# so each order's relative error is at most its longest chain of additions
# (about 130 + 8 + 15 here) times 2^-24, under 1e-5.
SUM_RTOL = 1e-5
# NVIDIA's H100 SXM data sheet: memory rate and f32 rate outside the tensor
# cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s dense) per f32 product (3xTF32), the route of the attention and
# SSD kernels
PEAK_3XTF32_PER_S = 495e12 / 3
T_RANGE = (1.7, 2.7)      # the maximum principle for the Fig. 1 initial state
T_SLACK = 2.0 ** -20      # a few f32 ulps of rounding at T ~ 2

# The coupled solvers: small odd shapes, then the sizes their users run
# (porosity 8192^2: four 268 MB fields per fused step; GP 512^3, FIG1's
# size: five 537 MB fields per fused step).
COUPLED_SMALL = {"porosity": (33, 20), "gp": (13, 17, 130)}
COUPLED_FULL = {"porosity": (8192, 8192), "gp": (512, 512, 512)}
PW_STEPS, PW_TOL_CAP, PW_TOL = 200, 200, 1e-9
GP_STEPS, GP_TOL_CAP, GP_TOL = 50, 50, 1e-3
SHORT_STEPS = {"porosity": 20, "gp": 5}    # the other bc and scheme variants
AGREE_STEPS = {"porosity": 5, "gp": 3}     # full size, cuda against torch backend

# k steps per launch (``run_steps(k)``): the generated FIG1 step, porosity's
# and GP's fused kernels and a staggered rotation, each held bitwise against k
# single-step launches of its program at a small odd shape and at full size.
# GP stops at k = 3 (its k = 4 cone needs 136-197 KB of a block's 227 KB of
# shared memory), as does the staggered kernel, a check of the rotation only.
STEPS_KS = {"fig1": (2, 3, 4), "porosity": (2, 3, 4), "gp": (2, 3), "staggered": (2, 3)}
STEPS_SMALL = {"fig1": (33, 20, 130), "porosity": (33, 20), "gp": (13, 17, 130),
               "staggered": (33, 20)}
STEPS_FULL = {"fig1": (512, 512, 512), "porosity": (8192, 8192), "gp": (512, 512, 512),
              "staggered": (8192, 8192)}
STEPS_RUN = 12      # steps of each k-step main-path run, a multiple of every k
HAND_KS = (2, 3, 4)

# Sub-f32 storage: the fields stored bf16 or f16 and computed in f32 (the
# hand kernel computes at the storage dtype, as its reference does). Every
# generated variant above and the hand kernel are held bitwise against their
# plain versions at both dtypes; the main path is FIG1 (MIXED_STEPS steps,
# then solve_until) and porosity (fixed and --tol runs) at each, GP's fused
# kernel on its state, and the k-step kernels of MIXED_K_VARIANTS.
MIXED_TAGS = {"bf16": "bfloat16", "f16": "float16"}
MIXED_STEPS = 100
MIXED_K_VARIANTS = ("stencil", "porosity_fused[neumann0]")
# The hand kernel computes at the storage dtype, its scalars rounded to it:
# FIG1's inv_dx^2 (261121 at 512^3) is beyond f16's 65504, so at f16 it runs
# only at these scalars (every product rounds, the step stable), as at bf16
# in the checks and times; the f16 hand kernel is off the main path.
HAND_MIXED_ARGS = (0.7, 1e-3, 8.3, 9.1, 10.7)
# one bf16 step against one f32 step from the same state: the reference's own
# bound (benchmarks/bench_teff.py::bench_mixed), 4 eps max|T|
MIXED_ONE_STEP_EPS = 4

# Zamba2-1.2B serving at full width and depth; the kernels' shapes on its
# prefill path (conv over d_conv_in = 4224 channels with K = 4; SSD with 64
# heads of P = N = 64, one group, chunk 64; attention with 32 heads of 64).
LM_ARCH = "zamba2-1.2b"
LM_SERVE = dict(batch=4, prompt_len=1024, gen_len=32)
# (rtol, atol) of each LM kernel against its plain version, f32: conv1d sums
# its taps in the plain version's order, and SiLU's exponential differs by a
# few ulp; attention's online softmax over key tiles rounds otherwise than
# one softmax per row, and each 3xTF32 product is about 2^-21 relative off;
# the SSD kernel sums its 3xTF32 products in another order, over 64-step
# chunks where the plain version's pick_chunk may take 1-step ones.
LM_TOL = {"conv1d": (1e-5, 1e-6), "ssd": (1e-4, 1e-4), "attention": (1e-5, 1e-5)}
# Prefill logits (O(1) for these random weights) of the kernels against the
# plain versions after 38 Mamba2 layers and 6 shared-block applications,
# each a few f32 roundings apart.
LOGITS_TOL = (1e-3, 1e-3)


START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line carries the seconds since the
    script started (``t_s``), so a run shows where its time goes."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import FIG1, Diffusion3DConfig
    from repro_torch.core import init_parallel_stencil, teff
    from repro_torch.examples import quickstart
    from repro_torch.kernels import attention, build, conv1d, diffusion3d, ref, ssd, stencil

    torch.manual_seed(0)
    dev = torch.device("cuda", 0)

    # ---- 1. card ------------------------------------------------------
    card_name, card_power = teff.card_info(0)
    emit({"phase": "card", "name": card_name, "power_limit": card_power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ---- 2. build -----------------------------------------------------
    ps = init_parallel_stencil()
    ps_plain = init_parallel_stencil(backend="torch", device="cuda")
    step = quickstart.make_step(ps)
    step_plain = quickstart.make_step(ps_plain)
    generic, generic_plain = make_generic(ps), make_generic(ps_plain)
    shape_kw = {n: (8, 8, 8) for n in ("T2", "T", "Ci")}
    sc_names = dict.fromkeys(("lam", "dt", "_dx", "_dy", "_dz"), 1.0)
    calls = [step.compiled(**shape_kw, **sc_names),
             step.with_reductions(ERR).compiled(**shape_kw, **sc_names),
             step.with_reductions(ALL_REDS).compiled(**shape_kw, **sc_names),
             generic.compiled(**{n: (8, 8, 8) for n in ("A2", "B2", "A", "B")}, c=1.0, h=1.0)]
    coupled = coupled_variants(torch, dev)
    calls += [v["kernel"].compiled(**v["shapes"](COUPLED_SMALL[v["solver"]]), **v["scalars"])
              for v in coupled.values()]
    ksteps = k_step_variants(coupled, step, step_plain)
    calls_k = {(name, k): v["kernel"].compiled(nsteps=k, **v["shapes"](STEPS_SMALL[v["solver"]]),
                                               **v["scalars"])
               for name, v in ksteps.items() for k in STEPS_KS[v["solver"]]}
    # every variant above with its fields stored bf16 and f16
    single = [("stencil", step, shape_kw, sc_names),
              ("stencil+err", step.with_reductions(ERR), shape_kw, sc_names),
              ("stencil+4red", step.with_reductions(ALL_REDS), shape_kw, sc_names),
              ("generic", generic, {n: (8, 8, 8) for n in ("A2", "B2", "A", "B")},
               dict(c=1.0, h=1.0)),
              *((n, v["kernel"], v["shapes"](COUPLED_SMALL[v["solver"]]), v["scalars"])
                for n, v in coupled.items())]
    calls_mixed = {}
    for tag, name in MIXED_TAGS.items():
        dt = getattr(torch, name)
        for n, kern, shp, scl in single:
            calls_mixed[f"{n}:{tag}"] = kern.with_dtype(dt).compiled(**shp, **scl)
        for (n, k) in calls_k:
            v = ksteps[n]
            calls_mixed[f"{n}/k{k}:{tag}"] = v["kernel"].with_dtype(dt).compiled(
                nsteps=k, **v["shapes"](STEPS_SMALL[v["solver"]]), **v["scalars"])
    # every marched variant (march_axis) and the health guard (finite, nan_count)
    march_v = march_variants(torch, step, step_plain, (generic, generic_plain), coupled, ksteps)
    calls_march = march_calls(torch, march_v)
    # the one-cell layouts of the single steps that take the pair layout at 2 bytes
    kern_of = {n: kern for n, kern, _, _ in single}
    calls_cells = [cell_twin(kern_of[n.split(":")[0]], c) for n, c in calls_mixed.items()
                   if "/k" not in n and c.shape.vec > 1]
    t0 = time.perf_counter()
    lm_kernels = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    sources = ([("diffusion3d", build.read_source(diffusion3d.SOURCE))]
               + [(n, build.read_source(m.SOURCE)) for n, m in lm_kernels.items()]
               + [(c.lib_name, c.source) for c in calls]
               + [(c.lib_name, c.source) for c in calls_k.values()]
               + [(c.lib_name, c.source) for c in calls_mixed.values()]
               + [(c.lib_name, c.source) for c in calls_march]
               + [(c.lib_name, c.source) for c in calls_cells])
    builds = build.compile_many(sources)
    cell_ptx = {str(b.library): ptxas_summary(b.log)
                for b in builds[len(builds) - len(calls_cells):]}
    builds = builds[:len(builds) - len(calls_cells)]
    sources = sources[:len(sources) - len(calls_cells)]
    call_names = ["stencil", "stencil+err", "stencil+4red", "generic", *coupled]
    variant_of = {c.source: name for name, c in zip(call_names, calls)}
    variant_of.update({c.source: f"{name}/k{k}" for (name, k), c in calls_k.items()})
    variant_of.update({c.source: name for name, c in calls_mixed.items()})
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "builds": [{"name": b.name, "variant": variant_of.get(src), "seconds": b.seconds,
                      "ptxas": [ln.strip() for ln in b.log.splitlines()
                                if "entry function" in ln or "registers" in ln
                                or "spill" in ln]}
                     for b, (_, src) in zip(builds, sources)]})
    n_gen = len(calls) + len(calls_k) + len(calls_mixed)
    march_ptx = {b.name: ptxas_summary(b.log) for b in builds[len(builds) - len(calls_march):]}
    ptxas = {name: ptxas_summary(b.log)
             for name, b in zip(call_names + [f"{n}/k{k}" for n, k in calls_k] + list(calls_mixed),
                                builds[-n_gen - len(calls_march):len(builds) - len(calls_march)])}
    hand = hand_ptxas(builds[0].log)
    # the single step (two instances merged) and k = 2-4, for f32, bf16 and
    # f16; the pair layout's single step for bf16 and f16
    require(len(hand) == 3 * (1 + len(HAND_KS)) + len(MIXED_TAGS),
            f"ptxas's lines of the hand kernel's instances not all found: {sorted(hand)}")
    ptxas.update(hand)
    require(all(not p["spills"] for p in ptxas.values()),
            f"ptxas spills registers in a generated kernel: {ptxas}")
    require(all(not p["spills"] for p in march_ptx.values()),
            f"ptxas spills registers in a marched or guarded kernel: {march_ptx}")
    require(all(not p["spills"] for p in cell_ptx.values()),
            f"ptxas spills registers in a one-cell layout: {cell_ptx}")
    require(all(calls_mixed[f"{n}:{t}"].shape.vec > 1 for t in MIXED_TAGS for n in PAIR_VARIANTS),
            "a kernel redesigned for 2-byte fields did not take the pair layout")

    # ---- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device="cpu").manual_seed(20260714)
    # each generated variant beside its torch-backend twin: the two the main
    # path launches, and the one with every reduction kind
    variants = {
        "stencil": (step, step_plain),
        "stencil+err": (step.with_reductions(ERR), step_plain.with_reductions(ERR)),
        "stencil+4red": (step.with_reductions(ALL_REDS), step_plain.with_reductions(ALL_REDS)),
    }
    err_at = {}
    for shape in SHAPES:
        T = torch.rand(shape, generator=gen).to(dev)
        T2 = torch.rand(shape, generator=gen).to(dev)
        Ci = (torch.rand(shape, generator=gen) + 0.5).to(dev)
        sc = {"lam": 1.0, "dt": 1e-4, "_dx": float(shape[0] - 1),
              "_dy": float(shape[1] - 1), "_dz": float(shape[2] - 1)}
        args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
        d_hand = max_abs_diff(diffusion3d.diffusion3d_step(T2, T, Ci, *args, alias=False),
                              ref.diffusion3d_step(T2, T, Ci, *args))
        require(d_hand == 0.0, f"diffusion3d differs from its plain version at {shape}")
        err_at[shape] = {"diffusion3d": d_hand}
        row = {"phase": "check", "shape": list(shape), "diffusion3d_max_abs_diff": d_hand}
        for label, (kern, plain) in variants.items():
            got, want = kern(T2=T2, T=T, Ci=Ci, **sc), plain(T2=T2, T=T, Ci=Ci, **sc)
            (o_k, r_k), (o_p, r_p) = (got, want) if kern.reductions else ((got, {}), (want, {}))
            d = max_abs_diff(o_k, o_p)
            reds = {n: {"kernel": float(r_k[n]), "plain": float(r_p[n])} for n in r_k}
            require(d == 0.0, f"{label} differs from the torch backend at {shape}")
            for n, r in kern.reductions.items():
                a, b = reds[n]["kernel"], reds[n]["plain"]
                if r.combine == "max":
                    require(a == b, f"{label}: {n} differs at {shape}")
                else:
                    require(math.isclose(a, b, rel_tol=SUM_RTOL),
                            f"{label}: {n} outside rtol {SUM_RTOL} at {shape}")
            # the error of what the variant returns: its output, and its
            # max-kind reductions (held bitwise above)
            err_at[shape][label] = max([d] + [abs(reds[n]["kernel"] - reds[n]["plain"])
                                              for n, r in kern.reductions.items()
                                              if r.combine == "max"])
            row[label] = {"max_abs_diff": d, "reductions": reds}
            del got, want, o_k, o_p
        if shape != SHAPES[-1]:
            fa = {n: torch.rand(shape, generator=gen).to(dev) for n in ("A2", "B2", "A", "B")}
            (ga, gr), (pa, pr) = generic(**fa, c=0.3, h=0.7), generic_plain(**fa, c=0.3, h=0.7)
            row["generic_max_abs_diff"] = max(max_abs_diff(ga[n], pa[n]) for n in ga)
            row["generic_reductions"] = {n: [float(gr[n]), float(pr[n])] for n in gr}
            require(row["generic_max_abs_diff"] == 0.0, f"generic kernel differs at {shape}")
            require(float(gr["d"]) == float(pr["d"]), f"generic max_abs_diff differs at {shape}")
            require(math.isclose(float(gr["s"]), float(pr["s"]), rel_tol=SUM_RTOL),
                    f"generic sum outside rtol at {shape}")
        emit(row)
        del T, T2, Ci

    # ---- 3b. the LM kernels against their plain versions -------------------
    lm_cases = lm_kernel_cases(torch, dev, gen)
    lm_failures = []     # every case is checked and printed before any fails
    for label, case in lm_cases.items():
        kernel = case["name"]
        got = case["kernel"]()
        torch.cuda.synchronize()
        want = case["plain"]()
        rtol, atol = LM_TOL[kernel]
        row = {"phase": "check_lm", "kernel": kernel, "case": label, "shape": case["shape"],
               "rtol": rtol, "atol": atol}
        for part, g, w in zip(case["parts"], got, want):
            row[part] = close_report(torch, g, w, rtol, atol)
        emit(row)
        lm_failures += [f"{kernel} ({label}): {part} outside rtol {rtol}, atol {atol}: "
                        f"{row[part]}" for part in case["parts"] if not row[part]["ok"]]
        if label.endswith("zamba2"):
            err_at[kernel] = max(row[part]["max_abs_err"] for part in case["parts"])
        del got, want
    require(not lm_failures, "; ".join(lm_failures))

    # ---- 3c. the coupled solvers' generated kernels against the torch backend
    cgen = torch.Generator(device=dev).manual_seed(20260715)
    # what PyTorch computes on the card for a tensor divided by a Python
    # scalar (the porosity updates divide by phi0, dx and dy): the kernels
    # emit a product with the reciprocal taken in double, rounded to f32
    x = (torch.rand(1 << 20, generator=cgen, device=dev) + 0.5)
    xc, probe = x.cpu(), {}
    for sc_ in (0.01, 10.0 / 23, 10.0 / 8191, 3.0):
        got, f32 = (x / sc_).cpu(), torch.tensor(sc_, dtype=torch.float32)
        cases = {"x * f32(1 / s)": xc * torch.tensor(1.0 / sc_, dtype=torch.float32),
                 "x * (1 / f32(s))": xc * (torch.tensor(1.0) / f32),
                 "x / f32(s)": xc / f32,
                 "f32(x / s) in double": (xc.double() / sc_).float()}
        probe[repr(sc_)] = {k: bool(torch.equal(got, v)) for k, v in cases.items()}
    emit({"phase": "division_probe", "cases": probe})
    require(all(c["x * f32(1 / s)"] for c in probe.values()),
            f"PyTorch's CUDA division by a scalar is not what the kernels emit: {probe}")
    del x, xc
    for shapes in (COUPLED_SMALL, COUPLED_FULL):
        for name, v in coupled.items():
            d = check_coupled(torch, name, v, shapes[v["solver"]], cgen)
            if shapes is COUPLED_FULL:
                err_at[name] = d
        torch.cuda.empty_cache()

    # ---- 3d. k steps per launch against k single-step launches ------------------
    for shapes in (STEPS_SMALL, STEPS_FULL):
        for name, v in ksteps.items():
            for k in STEPS_KS[v["solver"]]:
                d = check_k_steps(torch, name, v, k, shapes[v["solver"]], cgen)
                if shapes is STEPS_FULL:
                    err_at[f"{name}/k{k}"] = d
        for base in ((13, 17, 130), (33, 20, 131), (33, 20, 130), STEPS_FULL["fig1"]):
            err_at.update(check_hand_steps(torch, base, cgen))
        torch.cuda.empty_cache()
    check_ring_rule(torch, ksteps, cgen)

    # ---- 3e. bf16 and f16 storage: every variant against its plain version -----
    # the generated kernels bitwise against the torch backend at the same
    # storage dtype, at the small shapes and at full size (k-step ones against
    # k single-step launches); the hand kernel (k = 1-4) against its plain
    # version at storage dtype, in place and not
    mixed_v = {}
    check_pair_conversions(torch, dev)
    check_packed_ops(torch, dev)
    for tag, name in MIXED_TAGS.items():
        dt = getattr(torch, name)
        err_at.update(check_fig1_mixed(torch, variants, (generic, generic_plain), dt, tag,
                                       gen, dev))
        coupled_t, ksteps_t = retyped(coupled, dt), retyped(ksteps, dt)
        mixed_v[tag] = (dt, coupled_t, ksteps_t)
        for shapes in (COUPLED_SMALL, COUPLED_FULL):
            for n, v in coupled_t.items():
                d = check_coupled(torch, f"{n}:{tag}", v, shapes[v["solver"]], cgen)
                if shapes is COUPLED_FULL:
                    err_at[f"{n}:{tag}"] = d
            torch.cuda.empty_cache()
        for n, d in check_pairs(torch, coupled_t, tag, cgen).items():
            err_at[f"{n}:{tag}"] = max(err_at[f"{n}:{tag}"], d)
        for shapes in (STEPS_SMALL, STEPS_FULL):
            for n, v in ksteps_t.items():
                for k in STEPS_KS[v["solver"]]:
                    d = check_k_steps(torch, f"{n}:{tag}", v, k, shapes[v["solver"]], cgen)
                    if shapes is STEPS_FULL:
                        err_at[f"{n}/k{k}:{tag}"] = d
            torch.cuda.empty_cache()
        for base in ((13, 17, 130), (33, 20, 131), (33, 20, 130), STEPS_FULL["fig1"]):
            err_at.update(check_hand_steps(torch, base, cgen, dt, (1, *HAND_KS)))
        err_at.update(check_hand_off_word(torch, cgen, dt))
        check_ring_rule(torch, ksteps_t, cgen)
        torch.cuda.empty_cache()

    # ---- 3f-3g. marched kernels, the refusals, finite and nan_count ------------
    err_at.update(march_checks(torch, march_v, coupled, step, step_plain, cgen))

    # ---- 4. the main path at FIG1 ------------------------------------------
    stencil.launches.clear()
    diffusion3d.launches = 0
    t0 = time.perf_counter()
    r = quickstart.run(FIG1, device="cuda", tol=1e-7, max_iters=1000, check_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"step": stencil.launches["step"], "step[err]": stencil.launches["step[err]"],
              "diffusion3d": diffusion3d.launches}
    final = {"T": r.T, "T_explicit": r.T_explicit, "solve_T": r.solve.output(r.step)}
    stats = {n: {"finite": bool(torch.isfinite(t).all()), "min": float(t.min()),
                 "max": float(t.max())} for n, t in final.items()}
    explicit_diff = max_abs_diff(r.T, r.T_explicit)
    emit({"phase": "main_path", "config": "FIG1", "shape": list(FIG1.shape), "nt": FIG1.nt,
          "wall_s": wall, "launches": counts, "fields": stats,
          "explicit_vs_parallel_max_abs_diff": explicit_diff,
          "solve": {"iters": r.solve.iters, "host_syncs": r.solve.host_syncs,
                    "err": r.solve.err, "tol": 1e-7, "max_iters": 1000, "check_every": 10}})
    for n, s in stats.items():
        require(s["finite"], f"{n} holds non-finite values")
        require(T_RANGE[0] - T_SLACK <= s["min"] and s["max"] <= T_RANGE[1] + T_SLACK,
                f"{n} leaves {T_RANGE}: [{s['min']}, {s['max']}]")
    for k, v in counts.items():
        require(v > 0, f"kernel {k} was not launched on the main path")
    require(explicit_diff == 0.0, "explicit kernel and @parallel step disagree")
    require(r.solve.host_syncs == r.solve.iters // 10, "host_syncs != iters // check_every")
    del r, final

    cfg64 = Diffusion3DConfig(nx=64, ny=64, nz=64, nt=100)
    rc = quickstart.run(cfg64, device="cuda", backend="cuda", tol=1e-7, max_iters=1000)
    rt = quickstart.run(cfg64, device="cuda", backend="torch", tol=1e-7, max_iters=1000)
    small = {"T_max_abs_diff": max_abs_diff(rc.T, rt.T),
             "solve_max_abs_diff": max_abs_diff(rc.solve.output(rc.step),
                                                rt.solve.output(rt.step)),
             "iters": [rc.solve.iters, rt.solve.iters], "err": [rc.solve.err, rt.solve.err]}
    emit({"phase": "main_path_64_vs_torch_backend", **small})
    require(small["T_max_abs_diff"] == 0.0 and small["solve_max_abs_diff"] == 0.0,
            "cuda and torch backends disagree at 64^3")
    require(rc.solve.iters == rt.solve.iters and rc.solve.err == rt.solve.err,
            "solve_until differs between the backends at 64^3")
    del rc, rt

    # ---- 4b. the LM main path: Zamba2-1.2B serving ----------------------------
    lm = lm_main_path(torch, dev)
    lm_counts = lm["launches"]
    torch.cuda.empty_cache()

    # ---- 4c. the coupled solvers' main paths ----------------------------------
    coupled_runs = coupled_main_path(torch, coupled)

    # ---- 4d. the main paths in k steps per launch ------------------------------
    k_runs = k_steps_main_path(torch, ksteps)
    torch.cuda.empty_cache()

    # ---- 4e. the main path with bf16 and f16 storage -----------------------------
    spec = teff.device_spec(0)
    mixed_runs = mixed_main_path(torch, spec, coupled_runs)
    fig1_args = fig1_hand_args()
    for tag, (dt, _, ksteps_t) in mixed_v.items():
        mixed_runs["launches"].update(k_steps_main_path(
            torch, {n: ksteps_t[n] for n in MIXED_K_VARIANTS}, dt,
            hand=hand_fits(torch, dt, fig1_args))["launches"])
        torch.cuda.empty_cache()

    # ---- 4f. the main path marched -------------------------------------------------
    march_runs = march_main_path(torch, spec, march_v)
    torch.cuda.empty_cache()

    # ---- 4g. checkpoints, a planned kill and a resume; telemetry -------------------
    checkpoint_main_path(torch)
    telemetry_main_path(torch, step, spec)
    torch.cuda.empty_cache()

    # ---- 4h. the distributed runtime: rank gangs, the recovery drill, NCCL -----------
    dist_runs = distributed_main_path(torch, spec)
    torch.cuda.empty_cache()
    drill = multihost_main_path(torch, spec)
    nccl_main_path(torch, spec)
    torch.cuda.empty_cache()

    # ---- 5. times at FIG1 ---------------------------------------------------
    grid, f, sc = quickstart.initial_state(FIG1, "cuda")
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
    T2_own = f["T2"].clone()     # the hand step in place writes into it
    timed = {
        "stencil": lambda: step(**f, **sc),
        "stencil_plain": lambda: step_plain(**f, **sc),
        "stencil+err": lambda: step.with_reductions(ERR)(**f, **sc),
        "stencil+err_plain": lambda: step_plain.with_reductions(ERR)(**f, **sc),
        "diffusion3d": lambda: diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args,
                                                            alias=False),
        "diffusion3d_plain": lambda: ref.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args),
        "diffusion3d_in_place": lambda: diffusion3d.diffusion3d_step(T2_own, f["T"], f["Ci"],
                                                                     *args, alias=True),
    }
    ms = {k: teff.measure(fn, iters=20, warmup=3).median_s * 1e3 for k, fn in timed.items()}
    a_eff = teff.a_eff_from_ir(step.stencil_ir(**f, **sc), 4)
    # f32 operations per interior cell: the step's tap program; the check
    # adds a subtract, an abs and a max; the explicit kernel does the step's
    # arithmetic
    interior = math.prod(n - 2 for n in FIG1.shape)
    n_ops = len(calls[0].program.outputs[0].ops)
    ops = {"stencil": n_ops * interior, "stencil+err": (n_ops + 3) * interior,
           "diffusion3d": n_ops * interior}
    bound_ms = {k: max(a_eff / PEAK_BYTES_PER_S, v / PEAK_F32_PER_S) * 1e3
                for k, v in ops.items()}
    copy_bound_ms = a_eff / spec.peak_bw * 1e3
    emit({"phase": "times", "card": spec.name, "power_limit": spec.power_limit,
          "shape": list(FIG1.shape), "a_eff_bytes": a_eff,
          "copy_bandwidth_GBps": spec.peak_bw / 1e9, "ms": ms,
          "t_eff_GBps": {k: a_eff / (v / 1e3) / 1e9 for k, v in ms.items()},
          "t_eff_over_copy": {k: a_eff / (v / 1e3) / spec.peak_bw for k, v in ms.items()},
          "bound_ms": bound_ms, "copy_bound_ms": copy_bound_ms,
          "over_diffusion3d": {k: ms[k] / ms["diffusion3d"] for k in ("stencil", "stencil+err")},
          "ptxas": {k: ptxas[k] for k in ("stencil", "stencil+err")}})

    del grid, f
    # ---- 5b. times of the LM kernels at the Zamba2 prefill shapes --------------
    torch.backends.cudnn.allow_tf32 = False      # the library conv in f32, as the kernel
    lm_times = {}
    for label, case in lm_cases.items():
        if not label.endswith("zamba2"):
            continue
        kernel = case["name"]
        t = {"ms": teff.measure(case["kernel"], iters=20, warmup=3).median_s * 1e3,
             "plain_ms": teff.measure(case["plain"], iters=20, warmup=3).median_s * 1e3,
             "library_ms": (teff.measure(case["library"], iters=20, warmup=3).median_s * 1e3
                            if case["library"] else None),
             "bytes": case["bytes"], "flops": case["flops"]}
        # bound_ms at the rate of the units the kernel runs its products on
        # (attention, SSD: 3xTF32 tensor cores; conv1d: f32 CUDA cores);
        # the f32 CUDA-core bound beside it
        rate = PEAK_3XTF32_PER_S if case["tensor_cores"] else PEAK_F32_PER_S
        by_bytes, by_ops = case["bytes"] / PEAK_BYTES_PER_S, case["flops"] / rate
        t["bound_ms"] = max(by_bytes, by_ops) * 1e3
        t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        t["bound_rate"] = "3xTF32 tensor cores" if case["tensor_cores"] else "f32 CUDA cores"
        t["bound_f32_cuda_cores_ms"] = max(by_bytes, case["flops"] / PEAK_F32_PER_S) * 1e3
        t["library"] = case["library_name"]
        lm_times[kernel] = t
    emit({"phase": "times_lm", "card": spec.name, "power_limit": spec.power_limit,
          "shapes": {c["name"]: c["shape"] for k, c in lm_cases.items() if k.endswith("zamba2")},
          "launches_per_request": lm_counts, "kernels": lm_times,
          "prefill_ms": lm["prefill_ms"], "decode_tok_per_s": lm["decode_tok_per_s"]})
    del lm_cases

    # ---- 5c. times of the coupled kernels at full size --------------------------
    coupled_times = {}
    for name, v in coupled.items():
        t = coupled_times[name] = time_coupled(torch, v, COUPLED_FULL[v["solver"]], cgen)
        t["over_diffusion3d"] = t["ms"] / ms["diffusion3d"]
        t["ptxas"] = ptxas[name]
        torch.cuda.empty_cache()
    gp_state = time_gp_on_state(torch, coupled["gp_fused[none]"], cgen)
    emit({"phase": "times_coupled", "card": spec.name, "power_limit": spec.power_limit,
          "shapes": COUPLED_FULL, "diffusion3d_ms": ms["diffusion3d"], "kernels": coupled_times,
          "gp_fused_on_solver_state": gp_state})
    emit({"phase": "targets", "card": spec.name, "power_limit": spec.power_limit,
          **targets(ms, coupled_times)})

    # ---- 5d. times of the k-step kernels at full size ----------------------------
    single_ms = {"stencil": ms["stencil"], "staggered": None,
                 **{n: coupled_times[n]["ms"] for n in ksteps if n in coupled_times}}
    k_times = {}
    for name, v in ksteps.items():
        for k in STEPS_KS[v["solver"]]:
            t = time_k_steps(torch, name, v, k, STEPS_FULL[v["solver"]], cgen, spec)
            err_at[f"{name}/k{k}"] = max(err_at[f"{name}/k{k}"], t["max_abs_err"])
            k_times[f"{name}/k{k}"] = k_step_row(t, ptxas[f"{name}/k{k}"], single_ms[name])
            torch.cuda.empty_cache()
    for k in HAND_KS:
        t = time_hand_steps(torch, k, cgen, spec)
        err_at[f"diffusion3d/k{k}"] = max(err_at[f"diffusion3d/k{k}"], t["max_abs_err"])
        t["single_step_ms"] = ms["diffusion3d"]
        t["ptxas"] = ptxas[f"diffusion3d/k{k}"]
        k_times[f"diffusion3d/k{k}"] = t
    emit({"phase": "times_k_steps", "card": spec.name, "power_limit": spec.power_limit,
          "copy_bandwidth_GBps": spec.peak_bw / 1e9, "shapes": STEPS_FULL, "kernels": k_times})

    # ---- 5e. times of the bf16 and f16 kernels at full size ---------------------
    mixed_times = {}
    for tag, (dt, coupled_t, ksteps_t) in mixed_v.items():
        mixed_times.update(time_mixed(torch, tag, dt, step, step_plain, coupled_t, ksteps_t,
                                      cgen, spec, ptxas, cell_ptx))
    f32_ms = {"stencil": ms["stencil"], "stencil+err": ms["stencil+err"],
              "diffusion3d": ms["diffusion3d"], **{n: t["ms"] for n, t in coupled_times.items()},
              **{n: t["ms"] for n, t in k_times.items()}}
    pair_targets = {f"{n}:{tag}": {"ms": mixed_times[f"{n}:{tag}"]["ms_in_turns"],
                                   "cell_ms": mixed_times[f"{n}:{tag}"]["cell_ms"],
                                   "target_ms": target,
                                   "met": mixed_times[f"{n}:{tag}"]["ms_in_turns"] <= target}
                    for n, target in PAIR_TARGETS_MS.items() for tag in MIXED_TAGS}
    emit({"phase": "times_mixed", "card": spec.name, "power_limit": spec.power_limit,
          "copy_bandwidth_GBps": spec.peak_bw / 1e9, "kernels": mixed_times,
          "pair_targets": pair_targets, "hand_targets": hand_targets(k_times, mixed_times),
          "off_main_path": sorted(set(mixed_times) - set(mixed_runs["launches"])),
          "f32_ms": f32_ms,
          "over_f32": {k: t["ms"] / f32_ms[k.split(":")[0]] for k, t in mixed_times.items()}})
    for k, n in mixed_runs["launches"].items():
        require(n > 0, f"kernel {k} was not launched on the mixed main path")

    # ---- 5f. times of the marched kernels at full size ---------------------------
    march_times = march_timings(torch, march_v, cgen, spec, march_ptx)
    for k, n in march_runs["launches"].items():
        require(n > 0, f"kernel {k} was not launched on the marched main path")

    # ---- 6. the kernels line -------------------------------------------------
    fig1 = SHAPES[-1]
    gen_src = "src/repro_torch/kernels/codegen.py"
    rows = [
        ("stencil", "step", gen_src, "src/repro/kernels/stencil.py:1052"),
        ("stencil+err", "step[err]", gen_src, "src/repro/kernels/stencil.py:1052"),
        ("diffusion3d", "diffusion3d", "src/repro_torch/kernels/csrc/diffusion3d.cu",
         "src/repro/kernels/diffusion3d.py:75"),
    ]
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[c],
                "max_abs_err": err_at[fig1][k],
                "ms": ms[k], "plain_ms": ms[k + "_plain"], "bound_ms": bound_ms[k],
                "bound_by": "bytes" if a_eff / PEAK_BYTES_PER_S >= ops[k] / PEAK_F32_PER_S
                else "operations",
                "copy_bound_ms": copy_bound_ms, "library_ms": None}
               for k, c, src, rep in rows]
    lm_rows = [("conv1d", "src/repro/kernels/conv1d.py:44"),
               ("ssd", "src/repro/kernels/ssd.py:78"),
               ("attention", "src/repro/kernels/attention.py:74")]
    kernels += [{"name": k, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{k}.cu",
                 "replaces": rep, "launches": lm_counts[k], "max_abs_err": err_at[k],
                 **{x: lm_times[k][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "bound_f32_cuda_cores_ms", "library_ms")}}
                for k, rep in lm_rows]
    kernels += [{"name": k, "route": "cuda", "source": gen_src,
                 "replaces": "src/repro/kernels/stencil.py:1052",
                 "launches": coupled_runs["launches"][k], "max_abs_err": err_at[k],
                 **{x: coupled_times[k][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
                 "library_ms": None}
                for k in coupled]
    kernels += [{"name": k, "route": "cuda",
                 "source": ("src/repro_torch/kernels/csrc/diffusion3d.cu"
                            if k.startswith("diffusion3d") else
                            "src/repro_torch/kernels/codegen_steps.py"),
                 "replaces": ("src/repro/kernels/diffusion3d.py:75"
                              if k.startswith("diffusion3d") else
                              "src/repro/kernels/stencil.py:1052"),
                 "launches": k_runs["launches"][k], "max_abs_err": err_at[k],
                 **{x: t[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by", "ms_per_step",
                                      "bound_ms_per_step", "layout")},
                 "library_ms": None}
                for k, t in k_times.items()]
    kernels += [{"name": k, "route": "cuda",
                 "source": ("src/repro_torch/kernels/csrc/diffusion3d.cu"
                            if k.startswith("diffusion3d") else
                            "src/repro_torch/kernels/codegen_steps.py" if "/k" in k else
                            PAIR_SOURCE if "ms_in_turns" in t else gen_src),
                 "replaces": ("src/repro/kernels/diffusion3d.py:75"
                              if k.startswith("diffusion3d") else
                              "src/repro/kernels/stencil.py:1052"),
                 "launches": mixed_runs["launches"][k],
                 "max_abs_err": max(err_at[k], t.get("max_abs_err", 0.0)),
                 **{x: t[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
                 "library_ms": None, **pair_keys(t)}
                # the f16 hand kernel is timed but off the main path
                for k, t in mixed_times.items() if k in mixed_runs["launches"]]
    kernels += march_rows(march_runs, march_times, err_at)
    kernels += dist_times(torch, spec, {**dist_runs["launches"], **drill["launches"]})
    print(f"{card_name}, {card_power}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def max_abs_diff(a, b) -> float:
    return float((a - b).abs().max())


def close_report(torch, got, want, rtol, atol) -> dict:
    """Max absolute error, max relative error (over elements larger than
    atol) and whether ``got`` is within rtol/atol of ``want`` everywhere."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    big = want.abs() > atol
    rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    return {"max_abs_err": float(diff.max()), "max_rel_err": rel,
            "ok": bool(torch.allclose(got, want, rtol=rtol, atol=atol))}


def flat_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from flat_tensors(v)
        else:
            yield v


def lm_main_path(torch, dev, smoke: bool = False, serve_kw=LM_SERVE) -> dict:
    """Serve the LM through ``repro_torch.launch.serve`` on the kernels (the
    launch counts set to 0 just before, read just after), then on the plain
    versions with the same weights and prompt; check the outputs."""
    from repro_torch import configs
    from repro_torch.kernels import attention, conv1d, ssd
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import RunConfig, build as build_model, synth_batch

    lm_kernels = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    scfg = lm_serve.ServeConfig(**serve_kw)
    cfg = configs.get_smoke(LM_ARCH) if smoke else configs.get_arch(LM_ARCH)
    model = build_model(cfg, RunConfig(param_dtype="float32"), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(scfg.seed))
    prompt = synth_batch(model, torch.Generator(device=dev).manual_seed(scfg.seed + 1),
                         scfg.prompt_len, scfg.batch)["tokens"]
    for m in lm_kernels.values():
        m.launches = 0
    t0 = time.perf_counter()
    toks, info = lm_serve.serve(LM_ARCH, scfg, smoke=smoke, device=dev, params=params,
                                tokens=prompt, log_fn=lambda *a: None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: m.launches for n, m in lm_kernels.items()}
    plain_rc = RunConfig(param_dtype="float32", attn_impl="ref", ssd_impl="ref",
                         conv_impl="ref")
    toks_ref, info_ref = lm_serve.serve(LM_ARCH, scfg, rc=plain_rc, smoke=smoke, device=dev,
                                        params=params, tokens=prompt, log_fn=lambda *a: None)
    logits, logits_ref = info["prefill_logits"], info_ref["prefill_logits"]
    lm = {"phase": "main_path_lm", "arch": cfg.name, "smoke": smoke, "serve": serve_kw,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": sum(t.numel() for t in flat_tensors(params)),
          "wall_s": wall, "launches": counts,
          "prefill_ms": info["t_prefill_s"] * 1e3, "decode_s": info["t_decode_s"],
          "decode_tok_per_s": info["tok_per_s"],
          "plain_prefill_ms": info_ref["t_prefill_s"] * 1e3,
          "plain_decode_tok_per_s": info_ref["tok_per_s"],
          "logits": {"shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
                     "min": float(logits.min()), "max": float(logits.max()),
                     "vs_plain": close_report(torch, logits, logits_ref, *LOGITS_TOL),
                     "rtol": LOGITS_TOL[0], "atol": LOGITS_TOL[1]},
          "tokens": {"shape": list(toks.shape), "min": int(toks.min()), "max": int(toks.max()),
                     "agree_with_plain": int((toks == toks_ref).sum()),
                     "of": int(toks.size), "first_row": toks[0].tolist()}}
    emit(lm)
    require(lm["logits"]["finite"] and list(logits.shape) == [scfg.batch, cfg.vocab],
            "prefill logits are not finite or of the wrong shape")
    require(toks.shape == (scfg.batch, scfg.gen_len) and 0 <= toks.min()
            and toks.max() < cfg.vocab, "generated tokens out of range")
    require(lm["logits"]["vs_plain"]["ok"],
            f"prefill logits of the kernels and the plain versions differ: {lm['logits']}")
    n_groups = cfg.n_layers // cfg.attn_every
    if dev.type == "cuda":
        require(counts == {"conv1d": cfg.n_layers, "ssd": cfg.n_layers,
                           "attention": n_groups}, f"launches on the serving path {counts}")
    return lm


def lm_kernel_cases(torch, dev, gen):
    """Inputs, kernel, plain version, library call, bytes and operations of
    each LM kernel, at small shapes on the kernels' tile edges and at the
    Zamba2 prefill shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention, conv1d, ref, ssd

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = {}
    for label, (B, L, C, K) in {"odd": (2, 70, 300, 3),
                                "zamba2": (4, 1024, 4224, 4)}.items():
        x, w, b = randn(B, L, C), randn(K, C, scale=K ** -0.5), randn(C, scale=0.1)
        cases[f"conv1d_{label}"] = {
            "name": "conv1d", "shape": {"x": [B, L, C], "K": K}, "parts": ["out"],
            "kernel": lambda x=x, w=w, b=b: (conv1d.conv1d_causal(x, w, b, silu=True),),
            "plain": lambda x=x, w=w, b=b: (conv1d.plain(x, w, b, silu=True),),
            "library_name": "F.conv1d(groups=C, padding=K-1) + SiLU (cuDNN, TF32 off)",
            "library": lambda x=x, w=w, b=b, L=L, C=C, K=K: F.silu(F.conv1d(
                x.transpose(1, 2), w.flip(0).t()[:, None, :], b, padding=K - 1,
                groups=C)[..., :L]).transpose(1, 2),
            "bytes": 4 * (2 * B * L * C + K * C + C), "flops": B * L * C * (2 * K + 5),
            "tensor_cores": False}
    for label, (B, L, H, P, G, N, chunk, with_h0) in {
            "odd": (2, 100, 8, 16, 4, 16, 64, True),
            # pick_chunk halves to 8; chunks 16 and 32 with G = 2; P and N
            # that take 4-byte copies; a chunk above 64 (short last chunk)
            "L1000_G2_h0": (1, 1000, 8, 64, 2, 64, 64, True),
            "chunk16_G2": (2, 256, 8, 64, 2, 64, 16, False),
            "chunk32_G2_h0": (1, 256, 8, 32, 2, 32, 32, True),
            "P6_N10": (1, 40, 2, 6, 1, 10, 16, True),
            "chunk96": (1, 96, 2, 64, 1, 64, 96, True),
            # an odd L at Zamba2's H, P, N: pick_chunk gives 1, the kernels 64
            "L1023_h0": (1, 1023, 64, 64, 1, 64, 64, True),
            "zamba2": (4, 1024, 64, 64, 1, 64, 64, False)}.items():
        x = randn(B, L, H, P, scale=0.5)
        u = torch.rand((B, L, H), generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).to(dev)
        A = -(torch.rand((H,), generator=gen) * 15 + 1).to(dev)
        Bm, Cm = randn(B, L, G, N, scale=0.3), randn(B, L, G, N, scale=0.3)
        D = torch.ones(H).to(dev)
        h0 = randn(B, H, P, N, scale=0.2) if with_h0 else None
        cs = ssd.pick_chunk(L, chunk)      # the plain version's chunk
        kcs, nc = ssd.plan(L, chunk)         # the kernels'
        rows = [min(kcs, L - c * kcs) for c in range(nc)]
        cases[f"ssd_{label}"] = {
            "name": "ssd", "parts": ["y", "h_final"],
            "shape": {"x": [B, L, H, P], "G": G, "N": N, "chunk": cs, "kernel_chunk": kcs,
                      "h0": with_h0},
            "kernel": lambda a=(x, dt, A, Bm, Cm), D=D, h0=h0, c=chunk:
                ssd.ssd_chunk_scan(*a, D=D, h0=h0, chunk=c),
            "plain": lambda a=(x, dt, A, Bm, Cm), D=D, h0=h0, cs=cs:
                ref.ssd(*a, D=D, h0=h0, chunk=cs),
            "library_name": None, "library": None,
            # x, dt, A, B, C, D (and h0) read once; y and the final state written once
            "bytes": 4 * (2 * B * L * H * P + B * L * H + 2 * H + 2 * B * L * G * N
                          + (2 if with_h0 else 1) * B * H * P * N),
            # per (b, h) and kernel chunk of r steps: C·Bᵀ and W·x over the
            # causal triangle, C·h and the state update over (r, P, N)
            "flops": B * H * sum(r * (r + 1) * (N + P) + 4 * r * P * N for r in rows),
            "tensor_cores": True}
    for label, (B, Hq, Hkv, L, D, causal, window) in {
            "odd": (2, 4, 2, 200, 64, True, 37),
            # the tile edges (64 query rows, 32 keys), GQA rep 2 and 4,
            # window 0, non-causal
            "L1_rep2": (1, 4, 2, 1, 64, True, None),
            "L63_rep4_D128_w37": (1, 8, 2, 63, 128, True, 37),
            "L65_D16_noncausal": (2, 4, 4, 65, 16, False, None),
            "L1000_rep4_w0": (1, 8, 2, 1000, 64, True, 0),
            "L1024_D16": (1, 4, 4, 1024, 16, True, None),
            "L1024_D128_rep2": (1, 4, 2, 1024, 128, True, None),
            # 4096 keys: the output sums over 128 key tiles
            "L4096": (1, 4, 4, 4096, 64, True, None),
            "zamba2": (4, 32, 32, 1024, 64, True, None)}.items():
        q, k, v = randn(B, Hq, L, D), randn(B, Hkv, L, D), randn(B, Hkv, L, D)
        i = torch.arange(L)
        allowed = torch.ones(L, L, dtype=torch.bool)
        if causal:
            allowed &= i[None, :] <= i[:, None]
        if window is not None:
            allowed &= i[None, :] > i[:, None] - window
        pairs = int(allowed.sum())
        cases[f"attention_{label}"] = {
            "name": "attention", "parts": ["out"],
            "shape": {"q": [B, Hq, L, D], "Hkv": Hkv, "causal": causal, "window": window},
            "kernel": lambda q=q, k=k, v=v, c=causal, wd=window:
                (attention.flash_attention(q, k, v, causal=c, window=wd),),
            "plain": lambda q=q, k=k, v=v, c=causal, wd=window:
                (ref.attention(q, k, v, causal=c, window=wd),),
            "library_name": "F.scaled_dot_product_attention(is_causal=True)",
            "library": (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)) if causal and window is None and Hq == Hkv
            else None,
            "bytes": 4 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D),
            "flops": 4 * B * Hq * D * pairs, "tensor_cores": True}
    return cases


def coupled_variants(torch, dev) -> dict:
    """Each generated kernel of the two coupled solvers, by name, beside its
    ``torch``-backend twin: the solver, the kernel, its plain twin, the
    field shapes for a base shape, and scalars for the checks. The porosity
    kernels are made for the 8192^2 grid (its spacings are literals in their
    source), so the main path loads the libraries built here."""
    import inspect

    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw

    def pair(solver, pick, **kw):
        mod, cfg_cls = (pw, pw.PorosityConfig) if solver == "porosity" else (gp, gp.GPConfig)
        n = COUPLED_FULL[solver][0]
        kern = []
        for backend in ("cuda", "torch"):
            cfg = cfg_cls(n=n, device="cuda", backend=backend, **kw)
            kern.append(mod.make_step(mod.make_grid(cfg), cfg).kernels[pick])
        return kern

    def entry(solver, pair_, reductions=None):
        k, p = pair_
        if reductions:
            k, p = k.with_reductions(reductions), p.with_reductions(reductions)
        names = [a for a in inspect.signature(k.fn).parameters]
        fields = [a for a in names if a in ("phi2", "Pe2", "phi", "Pe", "qx", "qy",
                                             "re2", "im2", "re", "im", "V")]

        def shapes(base):
            out = {}
            for f in fields:
                off = {"qx": (1, 0), "qy": (0, 1)}.get(f, (0,) * len(base))
                out[f] = tuple(b - o for b, o in zip(base, off))
            return out

        scalars = {a: v for a, v in dict(dtau=1e-3, g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0,
                                          _dz2=5.0).items() if a in names}
        return {"solver": solver, "kernel": k, "plain": p, "shapes": shapes,
                "scalars": scalars}

    v = {}
    for bc in ("none", "neumann", "dirichlet", "periodic"):
        kind = {"neumann": "neumann0"}.get(bc, bc)
        v[f"porosity_fused[{kind}]"] = entry("porosity", pair("porosity", 0, bc=bc))
    v["porosity_fused[neumann0]+err"] = entry("porosity", pair("porosity", 0, bc="neumann"),
                                              {"err": "max_abs_diff(Pe2, Pe)"})
    v["porosity_fluxes"] = entry("porosity", pair("porosity", 0, flux_split=True))
    v["porosity_update[neumann0]"] = entry("porosity", pair("porosity", 1, flux_split=True))
    for bc in ("none", "neumann", "dirichlet", "periodic"):
        kind = {"neumann": "neumann0"}.get(bc, bc)
        v[f"gp_fused[{kind}]"] = entry("gp", pair("gp", 0, bc=bc))
    v["gp_fused[none]+mass"] = entry("gp", pair("gp", 0), {"m_re": "sum_sq(re2)",
                                                           "m_im": "sum_sq(im2)"})
    v["gp_step_re"] = entry("gp", pair("gp", 0, fused=False))
    v["gp_step_im"] = entry("gp", pair("gp", 1, fused=False))
    return v


def coupled_fields(torch, v, base, gen, cast=True):
    """Random fields at physical magnitudes for a variant (generated on the
    card from a seeded generator): porosity 0.005-0.015, pressures and
    fluxes +-0.005; GP values in [0, 1). The outputs' previous values differ
    from the inputs, so the kept rings and the bc sources show. Made in f32
    and rounded once to the kernel's storage dtype (unless ``cast`` is
    false)."""
    out = {}
    for f, shp in v["shapes"](base).items():
        u = torch.rand(shp, generator=gen, device=gen.device)
        if f in ("phi", "phi2"):
            u = 0.005 + 0.01 * u
        elif v["solver"] == "porosity":
            u = (u - 0.5) * 0.01
        out[f] = u
    return stored(v, out) if cast else out


def stored(v, fields):
    """``fields`` rounded to the storage dtype of the variant's kernel."""
    dt = v["kernel"].ps.dtype
    return {n: t.to(dt) for n, t in fields.items()}


def launch_label(kern, k: int = 1) -> str:
    """The label a kernel's launches count under: its name, the storage tag
    of a bf16 or f16 kernel, ``@m{axis}`` of a marched one and ``/k{k}`` of
    a k-step launch."""
    from repro_torch.kernels import stencil

    dt = kern.ps.dtype
    tag = "" if dt == stencil.STORAGE_DTYPES[0] else f":{stencil.dtype_tag(dt)}"
    march = "" if kern.march_axis is None else f"@m{kern.march_axis}"
    return f"{kern.label}{tag}{march}" + (f"/k{k}" if k > 1 else "")


def same(torch, a, b) -> bool:
    """Bitwise equal values, NaN matching NaN (an f16 run may overflow)."""
    return bool(torch.equal(a, b)) or bool(((a == b) | (a.isnan() & b.isnan())).all())


def finite_diff(torch, a, b) -> float:
    """max |a - b| over the cells where both are finite (0 if none)."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a.float() - b.float()).abs()[ok].max()) if bool(ok.any()) else 0.0


def nonfinite(torch, outs) -> int:
    return sum(int((~torch.isfinite(t)).sum()) for t in outs.values())


def check_coupled(torch, name, v, base, gen) -> float:
    """One call of a variant's generated kernel against its ``torch``-backend
    twin on the same inputs: outputs bitwise, max reductions bitwise, sums
    within SUM_RTOL. Returns the largest error of what the kernel returns."""
    k, p = v["kernel"], v["plain"]
    f = coupled_fields(torch, v, base, gen)
    got, want = k(**f, **v["scalars"]), p(**f, **v["scalars"])
    (o_k, r_k), (o_p, r_p) = (got, want) if k.reductions else ((got, {}), (want, {}))
    if len(k.outputs) == 1:
        o_k, o_p = {k.outputs[0]: o_k}, {k.outputs[0]: o_p}
    diffs = {o: max_abs_diff(o_k[o], o_p[o]) for o in k.outputs}
    bitwise = all(same(torch, o_k[o], o_p[o]) for o in k.outputs)
    reds = {n: {"kernel": float(r_k[n]), "plain": float(r_p[n])} for n in r_k}
    emit({"phase": "check_coupled", "variant": name, "shape": list(base),
          "dtype": str(k.ps.dtype), "bc": {o: c.kind for o, c in k.bc.items()},
          "max_abs_diff": diffs, "bitwise": bitwise, "nonfinite": nonfinite(torch, o_k),
          "reductions": reds})
    require(bitwise, f"{name} differs from the torch backend at {base}: {diffs}")
    errs = list(diffs.values())
    for n, r in k.reductions.items():
        a, b = reds[n]["kernel"], reds[n]["plain"]
        if r.combine == "max":
            require(a == b, f"{name}: {n} differs at {base}")
            errs.append(abs(a - b))
        else:
            require(math.isclose(a, b, rel_tol=SUM_RTOL), f"{name}: {n} outside rtol at {base}")
    return max(errs)


def tap_cost(call) -> tuple[float, float]:
    """(bytes, f32 operations) of one launch: each field the update reads
    once, each output written once (A_eff); the shared tap program and its
    stages at every base cell (``TapProgram.ops_per_cell``: x ** 3 counts two
    products), and two or three per base cell for each reduction. Bytes at
    the storage width (2 for bf16 and f16 fields)."""
    ir, prog = call.ir, call.program
    cells = math.prod(ir.base_shape)
    ops = prog.ops_per_cell() * cells
    for _, r in prog.reductions:
        ops += (3 if r.kind == "max_abs_diff" else 2) * cells
    return float(ir.io_bytes(call.dtype.itemsize)), float(ops)


def ptxas_summary(log: str) -> dict:
    """Registers, spill bytes and static shared memory from ptxas's -v lines."""
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines() if "Used " in ln]
    smem = [int(ln.split("bytes smem")[0].split()[-1]) for ln in log.splitlines()
            if "bytes smem" in ln]
    spills = [ln.strip() for ln in log.splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
    return {"registers": max(regs, default=None), "smem_bytes": max(smem, default=0),
            "spills": spills}


def bound_of(a_eff, ops) -> tuple[float, str]:
    by_bytes, by_ops = a_eff / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def time_coupled(torch, v, base, gen) -> dict:
    """CUDA-event medians of one launch of the variant's kernel and of its
    torch-backend twin at ``base``, beside the bound."""
    from repro_torch.core import teff

    f = coupled_fields(torch, v, base, gen)
    k, p, sc = v["kernel"], v["plain"], v["scalars"]
    a_eff, ops = tap_cost(k.compiled(**f, **sc))
    bound_ms, bound_by = bound_of(a_eff, ops)
    ms = teff.measure(lambda: k(**f, **sc), iters=20, warmup=3).median_s * 1e3
    plain_ms = teff.measure(lambda: p(**f, **sc), iters=10, warmup=2).median_s * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "a_eff_bytes": a_eff, "ops": ops,
            "ops_per_cell": k.compiled(**f, **sc).program.ops_per_cell(),
            "t_eff_GBps": a_eff / (ms / 1e3) / 1e9,
            "layout": k.launch_info[tuple(base)]["layout"]}


def time_gp_on_state(torch, v, gen) -> dict:
    """GP's fused kernel at 512^3 under CUDA events on the solver's own
    state (``init_state``: a Gaussian in re, im zero, the trap V; outputs
    passed as the inputs, as ``solve`` passes them) and, in turns, on the
    uniform random fields of ``time_coupled``."""
    from repro_torch.core import teff
    from repro_torch.examples import gross_pitaevskii as gp

    cfg = gp.GPConfig(n=COUPLED_FULL["gp"][0], device="cuda")
    grid, re, im, V = gp.init_state(cfg)
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
    state = dict(re2=re, im2=im, re=re, im=im, V=V)
    sc = dict(g=cfg.g, dt=gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
    rand = coupled_fields(torch, v, COUPLED_FULL["gp"], gen)
    k = v["kernel"]
    out = {}
    for label, f in (("state", state), ("random", rand), ("state_again", state),
                     ("random_again", rand)):
        out[label] = teff.measure(lambda: k(**f, **sc), iters=20, warmup=3).median_s * 1e3
    return {"ms": out, "scalars": sc}


def targets(ms, coupled) -> dict:
    """This slice's speed targets for the generated kernel, each with its
    number from this run and whether it was met (a missed target is
    reported, not failed)."""
    pw, gp_ = coupled["porosity_fused[neumann0]"], coupled["gp_fused[none]"]
    two = coupled["gp_step_re"]["ms"] + coupled["gp_step_im"]["ms"]
    rows = {
        "porosity_fused[neumann0] <= 0.641 ms": (pw["ms"], pw["ms"] <= 0.641),
        "gp_fused[none] <= 1.603 ms": (gp_["ms"], gp_["ms"] <= 1.603),
        "gp_fused[none] < step_re + step_im": ([gp_["ms"], two], gp_["ms"] < two),
        "+err <= 1.15 x its base": (
            coupled["porosity_fused[neumann0]+err"]["ms"] / pw["ms"],
            coupled["porosity_fused[neumann0]+err"]["ms"] <= 1.15 * pw["ms"]),
        "+mass <= 1.15 x its base": (
            coupled["gp_fused[none]+mass"]["ms"] / gp_["ms"],
            coupled["gp_fused[none]+mass"]["ms"] <= 1.15 * gp_["ms"]),
        "FIG1 step within 5% of 0.6847 ms": (ms["stencil"], ms["stencil"] <= 1.05 * 0.6847),
        "FIG1 err within 5% of 0.9185 ms": (ms["stencil+err"], ms["stencil+err"] <= 1.05 * 0.9185),
    }
    return {"targets": {k: {"value": v, "met": met} for k, (v, met) in rows.items()}}


def coupled_main_path(torch, coupled) -> dict:
    """Both solvers at full size through the twins' ``solve``: porosity at
    8192^2 (a fixed run, a ``--tol`` run, then the other bcs and the
    flux-split scheme), GP at 512^3 (a fixed run, the drift-guarded run, the
    other bcs and the two-launch scheme). The launch counts are set to 0
    just before each run and read just after; every run must launch
    exactly the kernels it names, as often as its steps say. Each run's time
    per step is its wall time less that of the same call cut to one step
    (one check block with a tol, and made twice, so that loading the kernel
    falls in the first), over the steps between them."""
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw
    from repro_torch.kernels import stencil

    launches = dict.fromkeys(coupled, 0)
    rows = []
    n_pw, n_gp = COUPLED_FULL["porosity"][0], COUPLED_FULL["gp"][0]

    def drive(solver, label, kw, names):
        mod, cfg = (pw, pw.PorosityConfig(n=n_pw, device="cuda", **kw)) if solver == \
            "porosity" else (gp, gp.GPConfig(n=n_gp, device="cuda", **kw))
        stencil.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mod.solve(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(stencil.launches)
        require(set(counts) == set(names) and all(counts[c] > 0 for c in names),
                f"{label}: launches {counts}, expected kernels {sorted(names)}")
        for c, variant in names.items():
            launches[variant] += counts[c]
        return r, wall, counts

    def wall_of(solver, kw):
        """Host time of one solve call (no counting)."""
        mod, cfg = (pw, pw.PorosityConfig(n=n_pw, device="cuda", **kw)) if solver == \
            "porosity" else (gp, gp.GPConfig(n=n_gp, device="cuda", **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mod.solve(cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, r["iters"]

    def record(solver, label, kw, names, r, wall, counts, steps, short):
        cost = {}
        for c, v in names.items():
            a, o = tap_cost(coupled[v]["kernel"].compiled(
                **coupled[v]["shapes"](COUPLED_FULL[solver]), **coupled[v]["scalars"]))
            cost[v] = (a, o, counts[c] / steps)
        a_eff = sum(a * share for a, _, share in cost.values())
        ops = sum(o * share for _, o, share in cost.values())
        # the same call cut to one step (one check block with a tol), made
        # after a first such call has loaded the kernel, pays the set-up, the
        # trace and the diagnostics once: the difference is the time of the
        # steps that follow
        short_wall, short_steps = short
        ms = ((wall - short_wall) / (steps - short_steps) if steps > short_steps
              else wall / steps) * 1e3
        bound_ms, bound_by = bound_of(a_eff, ops)
        row = {"phase": "main_path_coupled", "solver": solver, "run": label,
               "shape": list(COUPLED_FULL[solver]), "config": kw, "steps": steps,
               "launches": counts, "wall_s": wall, "short_run": {"wall_s": short_wall,
                                                                  "steps": short_steps},
               "ms_per_step": ms, "a_eff_bytes_per_step": a_eff,
               "t_eff_GBps": a_eff / (ms / 1e3) / 1e9, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "host_syncs": r["host_syncs"], "iters": r["iters"]}
        if solver == "porosity":
            phi = r["phi"]
            row.update(phi_range=[r["phi_min"], r["phi_max"]], pe_absmax=r["pe_absmax"],
                       residual=r["residual"], peak0_y=r["peak0_y"], peak_y=r["peak_y"],
                       finite=bool(torch.isfinite(phi).all() and torch.isfinite(r["Pe"]).all()))
            require(row["finite"], f"porosity {label}: non-finite fields")
            require(abs(r["peak_y"] - r["peak0_y"]) <= 1.5 * r["grid"].spacing[1]
                    or r["peak_y"] > r["peak0_y"],
                    f"porosity {label}: the anomaly left its place downward "
                    f"({r['peak0_y']} -> {r['peak_y']})")
        else:
            row.update(mass0=r["mass0"], mass=r["mass"], drift=r["drift"],
                       finite=bool(torch.isfinite(r["re"]).all()
                                   and torch.isfinite(r["im"]).all()))
            require(row["finite"], f"GP {label}: non-finite fields")
            require(r["drift"] < 0.05, f"GP {label}: mass drift {r['drift']}")
        emit(row)
        rows.append(row)

    runs = [
        ("porosity", "fixed", dict(nt=PW_STEPS), {"update": "porosity_fused[neumann0]"}),
        ("porosity", "tol", dict(nt=PW_TOL_CAP, tol=PW_TOL, check_every=10),
         {"update": "porosity_fused[neumann0]", "update[err]": "porosity_fused[neumann0]+err"}),
        ("porosity", "bc=none", dict(nt=SHORT_STEPS["porosity"], bc="none"),
         {"update": "porosity_fused[none]"}),
        ("porosity", "bc=dirichlet", dict(nt=SHORT_STEPS["porosity"], bc="dirichlet"),
         {"update": "porosity_fused[dirichlet]"}),
        ("porosity", "bc=periodic", dict(nt=SHORT_STEPS["porosity"], bc="periodic"),
         {"update": "porosity_fused[periodic]"}),
        ("porosity", "flux_split", dict(nt=SHORT_STEPS["porosity"], flux_split=True),
         {"fluxes": "porosity_fluxes", "update": "porosity_update[neumann0]"}),
        ("gp", "fixed", dict(nt=GP_STEPS), {"update": "gp_fused[none]"}),
        ("gp", "guarded", dict(nt=GP_TOL_CAP, tol=GP_TOL, check_every=10),
         {"update": "gp_fused[none]", "update[m_re,m_im]": "gp_fused[none]+mass"}),
        ("gp", "bc=neumann", dict(nt=SHORT_STEPS["gp"], bc="neumann"),
         {"update": "gp_fused[neumann0]"}),
        ("gp", "bc=dirichlet", dict(nt=SHORT_STEPS["gp"], bc="dirichlet"),
         {"update": "gp_fused[dirichlet]"}),
        ("gp", "bc=periodic", dict(nt=SHORT_STEPS["gp"], bc="periodic"),
         {"update": "gp_fused[periodic]"}),
        ("gp", "two_launch", dict(nt=SHORT_STEPS["gp"], fused=False),
         {"step_re": "gp_step_re", "step_im": "gp_step_im"}),
    ]
    for solver, label, kw, names in runs:
        short_kw = dict(kw, nt=kw.get("check_every", 1))
        wall_of(solver, short_kw)      # loads the library and its module on the card
        short = wall_of(solver, short_kw)
        r, wall, counts = drive(solver, label, kw, names)
        steps = r["iters"]
        checks = steps // kw["check_every"] if "tol" in kw else 0
        for c in names:       # the checked kernel's label ends with its reductions
            want = checks if c.endswith("]") else steps - checks
            require(counts[c] == want, f"{solver} {label}: {c} launched {counts[c]}, "
                                       f"expected {want}")
        if "tol" in kw:
            require(r["host_syncs"] == steps // kw["check_every"],
                    f"{solver} {label}: host syncs {r['host_syncs']}")
        record(solver, label, kw, names, r, wall, counts, steps, short)
        del r
        torch.cuda.empty_cache()

    # a few steps at full size: the generated kernels against the torch backend
    agree = {}
    for solver, mod, cfg_cls, n, keys in (("porosity", pw, pw.PorosityConfig, n_pw, ("phi", "Pe")),
                                          ("gp", gp, gp.GPConfig, n_gp, ("re", "im"))):
        rs = [mod.solve(cfg_cls(n=n, nt=AGREE_STEPS[solver], device="cuda", backend=b))
              for b in ("cuda", "torch")]
        agree[solver] = {k: max_abs_diff(rs[0][k], rs[1][k]) for k in keys}
        require(all(d == 0.0 for d in agree[solver].values()),
                f"{solver}: cuda and torch backends disagree after "
                f"{AGREE_STEPS[solver]} steps at full size: {agree[solver]}")
        del rs
        torch.cuda.empty_cache()
    emit({"phase": "main_path_coupled_vs_torch_backend", "steps": AGREE_STEPS,
          "max_abs_diff": agree})
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the coupled main path")
    return {"launches": launches, "runs": rows}


def k_step_variants(coupled, step, step_plain) -> dict:
    """The k-step cases: FIG1's generated step, porosity's and GP's fused
    kernels for each bc that runs inside a launch (with the residual and mass
    epilogues), and a staggered rotation, each beside its torch twin."""
    from repro_torch.core import fd2d, init_parallel_stencil
    from repro_torch.examples import porosity_waves as pw

    def staggered(ps):
        @ps.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})
        def stag(T2, q2, T, q, dt):
            return {"T2": fd2d.inn(T) + dt * fd2d.d_xi(q),
                    "q2": 0.7 * q + 0.3 * fd2d.av_xa(T)}
        return stag

    v = {"stencil": {"solver": "fig1", "kernel": step, "plain": step_plain,
                     "shapes": lambda b: {n: b for n in ("T2", "T", "Ci")},
                     "scalars": dict(lam=1.0, dt=1e-7, _dx=511.0, _dy=511.0, _dz=511.0)}}
    # porosity's kernels take the solver's own pseudo-time step at 8192^2 (its
    # spacings are literals in their source): the single-step checks' 1e-3
    # overflows to inf within four steps
    cfg = pw.PorosityConfig(n=COUPLED_FULL["porosity"][0], device="cuda")
    dtau = {"dtau": pw.timestep(cfg, pw.make_grid(cfg))}
    for name in ("porosity_fused[none]", "porosity_fused[dirichlet]", "porosity_fused[neumann0]",
                 "porosity_fused[neumann0]+err", "gp_fused[none]", "gp_fused[dirichlet]",
                 "gp_fused[neumann0]", "gp_fused[none]+mass"):
        v[name] = dict(coupled[name], scalars=dtau) if name.startswith("porosity") \
            else coupled[name]
    v["staggered"] = {
        "solver": "staggered", "scalars": {"dt": 1e-3},
        "kernel": staggered(init_parallel_stencil(ndims=2)),
        "plain": staggered(init_parallel_stencil(backend="torch", device="cuda", ndims=2)),
        "shapes": lambda b: {"T2": b, "T": b, "q2": (b[0] - 1, b[1]), "q": (b[0] - 1, b[1])}}
    return v


def k_fields(torch, v, base, gen):
    """Random fields for a k-step case (``coupled_fields``; FIG1's Ci in
    [0.5, 1.5)), each output a copy of its rotation target, as the solvers
    pass them, at the kernel's storage dtype."""
    f = coupled_fields(torch, v, base, gen, cast=False)
    if "Ci" in f:
        f["Ci"] = f["Ci"] + 0.5
    f = stored(v, f)
    for o, t in v["kernel"].rotations.items():
        f[o] = f[t].clone()
    return f


def rotate_run(kern, fields, sc, k, n_steps):
    """``n_steps`` steps as ``run_steps(k)`` launches with the double-buffer
    rotation between them; returns the fields after the last and its
    reductions."""
    cur, reds = dict(fields), None
    for _ in range(n_steps // k):
        res = kern.run_steps(k, **cur, **sc)
        res, reds = res if kern.reductions else (res, None)
        outs = {kern.outputs[0]: res} if len(kern.outputs) == 1 else res
        for o, t in kern.rotations.items():
            cur[o], cur[t] = cur[t], outs[o]
    return cur, reds


def split_result(kern, res):
    """``(outputs by name, reductions by name)`` of what a kernel returns."""
    res, reds = res if kern.reductions else (res, {})
    return ({kern.outputs[0]: res} if len(kern.outputs) == 1 else res), reds


def hold_to(torch, kern, got, reds, want, want_reds, what) -> float:
    """Outputs bitwise, max reductions bitwise, sums within SUM_RTOL;
    returns the largest difference of the outputs and max reductions."""
    errs = [max_abs_diff(got[o], want[o]) for o in kern.outputs]
    require(all(same(torch, got[o], want[o]) for o in kern.outputs),
            f"{what}: outputs differ by {errs}")
    for n, r in kern.reductions.items():
        a, b = float(reds[n]), float(want_reds[n])
        if r.combine == "max":
            require(a == b, f"{what}: {n} differs ({a} against {b})")
            errs.append(abs(a - b))
        else:
            require(math.isclose(a, b, rel_tol=SUM_RTOL), f"{what}: {n} outside rtol {SUM_RTOL}")
    return max(errs)


def check_k_steps(torch, name, v, k, base, gen) -> float:
    """One launch of the k-step kernel against k single-step launches of the
    same program: outputs bitwise; the last step's max reductions bitwise,
    sums within SUM_RTOL. Returns the largest error of what it returns."""
    from repro_torch.kernels import stencil

    kern, sc = v["kernel"], v["scalars"]
    f = k_fields(torch, v, base, gen)
    want, want_reds = rotate_run(kern, f, sc, 1, k)
    require(kern.ps.dtype == torch.float16
            or all(bool(torch.isfinite(want[t]).all()) for t in kern.rotations.values()),
            f"{name}: {k} single steps at {base} leave non-finite values")
    want = {o: want[t] for o, t in kern.rotations.items()}
    label = launch_label(kern, k)
    before = stencil.launches[label]
    got, reds = split_result(kern, kern.run_steps(k, **f, **sc))
    torch.cuda.synchronize()
    emit({"phase": "check_k_steps", "variant": name, "k": k, "shape": list(base),
          "dtype": str(kern.ps.dtype), "nonfinite": nonfinite(torch, got),
          "launches": stencil.launches[label] - before,
          "max_abs_diff": {o: max_abs_diff(got[o], want[o]) for o in kern.outputs},
          "reductions": {n: {"kernel": float(reds[n]), "k_launches": float(want_reds[n])}
                         for n in reds}})
    require(stencil.launches[label] == before + 1, f"{name}: run_steps({k}) made "
            f"{stencil.launches[label] - before} launches of {label}")
    return hold_to(torch, kern, got, reds, want, want_reds,
                   f"{name}: run_steps({k}) against {k} launches at {base}")


def check_hand_steps(torch, base, gen, dtype=None, ks=HAND_KS) -> dict:
    """The hand kernel's k steps in one launch, in place and not, against k
    single-step launches (T2 a copy of T), and its k-step ring rule against
    the plain version (T2 apart from T on the ring); fields stored as
    ``dtype`` (f32 by default), where each operation rounds to it. At f16
    the steep random fields leave its range within two steps: inf and NaN
    must then stand where the plain version has them (``same``), and the
    row counts them; differences are taken over the finite cells."""
    from repro_torch.kernels import diffusion3d, ref, stencil

    dtype = dtype or torch.float32
    tag = "" if dtype == torch.float32 else f":{stencil.dtype_tag(dtype)}"
    errs = {}
    for k in ks:
        T = torch.rand(base, generator=gen, device=gen.device).to(dtype)
        Ci = (torch.rand(base, generator=gen, device=gen.device) + 0.5).to(dtype)
        args = (1.0, 1e-4, float(base[0] - 1), float(base[1] - 1), float(base[2] - 1)) \
            if dtype == torch.float32 else HAND_MIXED_ARGS
        a, b = T.clone(), T.clone()
        for _ in range(k):
            a = diffusion3d.diffusion3d_step(a, b, Ci, *args, alias=False)
            a, b = b, a
        row = {"phase": "check_hand_steps", "k": k, "shape": list(base), "dtype": str(dtype)}
        diffs = []
        for alias in (False, True):
            T2 = T.clone()
            got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=alias)
            torch.cuda.synchronize()
            row["layout"] = diffusion3d.last_layout
            diffs.append(finite_diff(torch, got, b))
            row[f"alias={alias}"] = {"max_abs_diff": diffs[-1],
                                     "in_place": got.data_ptr() == T2.data_ptr()}
            require(same(torch, got, b), f"diffusion3d{tag} nsteps={k} alias={alias} "
                    f"differs from {k} launches at {base}")
            require(row[f"alias={alias}"]["in_place"] == alias, "alias= did not hold")
        T2 = torch.rand(base, generator=gen, device=gen.device).to(dtype)
        ring = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=False)
        ring_plain = ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k)
        d = finite_diff(torch, ring, ring_plain)
        row["ring_rule_max_abs_diff"] = d
        # the plain version at storage dtype, in place (T2 a copy of T)
        plain = ref.diffusion3d_steps(T.clone(), T, Ci, *args, nsteps=k)
        row["plain_max_abs_diff"] = finite_diff(torch, b, plain)
        row["nonfinite"] = nonfinite(torch, {"T": b})
        emit(row)
        require(same(torch, ring, ring_plain),
                f"diffusion3d{tag} nsteps={k} ring rule differs at {base}")
        require(same(torch, b, plain),
                f"diffusion3d{tag} nsteps={k} differs from its plain version at {base}")
        errs[f"diffusion3d{'/k' + str(k) if k > 1 else ''}{tag}"] = max(d, *diffs)
    return errs


def off_word(torch, t):
    """A copy of a 2-byte tensor two bytes off a 4-byte word: the hand
    kernel's pair layout refuses it (``diffusion3d.pairs_fit``)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def check_hand_off_word(torch, gen, dtype) -> dict:
    """The hand single step at 2 bytes on fields two bytes off a word (the
    one-cell layout where nz is even: ``diffusion3d_kernel<*, S>``), in place
    and not, bitwise against its plain version and against the pair layout
    on the same values, at a small shape and at FIG1's."""
    from repro_torch.kernels import diffusion3d, ref, stencil

    tag = stencil.dtype_tag(dtype)
    err = 0.0
    for base in ((33, 20, 130), STEPS_FULL["fig1"]):
        T = torch.rand(base, generator=gen, device=gen.device).to(dtype)
        Ci = (torch.rand(base, generator=gen, device=gen.device) + 0.5).to(dtype)
        T2 = torch.rand(base, generator=gen, device=gen.device).to(dtype)
        want = ref.diffusion3d_step(T2, T, Ci, *HAND_MIXED_ARGS)
        pairs = diffusion3d.diffusion3d_step(T2, T, Ci, *HAND_MIXED_ARGS, alias=False)
        pairs_layout = diffusion3d.last_layout
        row = {"phase": "check_hand_off_word", "dtype": str(dtype), "shape": list(base),
               "pairs_layout": pairs_layout}
        for alias in (False, True):
            f = [off_word(torch, t) for t in (T2, T, Ci)]
            got = diffusion3d.diffusion3d_step(*f, *HAND_MIXED_ARGS, alias=alias)
            torch.cuda.synchronize()
            row[f"alias={alias}"] = {"layout": diffusion3d.last_layout,
                                     "max_abs_diff": finite_diff(torch, got, want),
                                     "in_place": got.data_ptr() == f[0].data_ptr()}
            err = max(err, row[f"alias={alias}"]["max_abs_diff"])
            require(same(torch, got, want) and same(torch, got, pairs)
                    and diffusion3d.last_layout == "cells" and pairs_layout == "pairs",
                    f"diffusion3d:{tag} off a word at {base} alias={alias}: {row}")
        emit(row)
    return {f"diffusion3d/cells:{tag}": err}


def check_ring_rule(torch, ksteps, gen) -> None:
    """With outputs apart from their targets on the ring, the k-step kernel
    equals its plain version (``codegen.evaluate_steps_torch``) on the card."""
    from repro_torch.kernels import codegen

    rows = {}
    for name in ("stencil", "porosity_fused[neumann0]", "gp_fused[neumann0]", "staggered"):
        v = ksteps[name]
        kern, sc = v["kernel"], v["scalars"]
        base = STEPS_SMALL[v["solver"]]
        f = k_fields(torch, v, base, gen)
        for o in kern.outputs:
            f[o] = f[o] + 0.25
        call = kern.compiled(nsteps=3 if name != "gp_fused[neumann0]" else 2, **f, **sc)
        got, _ = call.run(f, sc)
        want, _ = codegen.evaluate_steps_torch(call.program, call.rotations, call.nsteps, f, sc)
        rows[name] = {o: max_abs_diff(got[o], want[o]) for o in kern.outputs}
    emit({"phase": "check_k_steps_ring_rule", "max_abs_diff": rows})
    require(all(d == 0.0 for r in rows.values() for d in r.values()),
            f"a k-step kernel breaks the ring rule: {rows}")


def k_steps_main_path(torch, ksteps, dtype=None, hand=True) -> dict:
    """Each k-step kernel on its solver's own state at full size
    (``quickstart.initial_state``, ``porosity_waves.init_state``,
    ``gross_pitaevskii.init_state``; the staggered rotation on random
    fields): STEPS_RUN steps as ``run_steps(k)`` launches for every k, with
    the launch counts set to 0 just before each run and read just after,
    and the same steps as single-step launches, which every k must equal
    bitwise. The hand kernel runs the FIG1 steps in place (``alias=True``).
    Host-clock ms per step of each run beside the single-step run's. With
    ``dtype`` the states are rounded to it once and every kernel stores it
    (``ksteps`` retyped to it); counts and rows carry its tag. ``hand``
    false leaves the hand kernel out (FIG1's scalars overflow f16)."""
    from repro_torch.configs import FIG1
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw, quickstart
    from repro_torch.kernels import diffusion3d, stencil

    dtype = dtype or torch.float32
    tag = "" if dtype == torch.float32 else f":{stencil.dtype_tag(dtype)}"

    def state(name, v):
        f, sc = state32(name, v)
        return {n: t.to(dtype) for n, t in f.items()}, sc

    def state32(name, v):
        if v["solver"] == "fig1":
            _, f, sc = quickstart.initial_state(FIG1, "cuda")
            return f, sc
        if v["solver"] == "porosity":
            cfg = pw.PorosityConfig(n=STEPS_FULL["porosity"][0], device="cuda")
            grid, phi, Pe = pw.init_state(cfg)
            return (dict(phi2=phi.clone(), Pe2=Pe.clone(), phi=phi, Pe=Pe),
                    {"dtau": pw.timestep(cfg, grid)})
        if v["solver"] == "gp":
            cfg = gp.GPConfig(n=STEPS_FULL["gp"][0], device="cuda")
            grid, re, im, V = gp.init_state(cfg)
            inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
            return (dict(re2=re.clone(), im2=im.clone(), re=re, im=im, V=V),
                    dict(g=cfg.g, dt=gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1],
                         _dz2=inv2[2]))
        gen = torch.Generator(device="cuda").manual_seed(20260716)
        return k_fields(torch, v, STEPS_FULL["staggered"], gen), v["scalars"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches, rows = {}, []
    for name, v in ksteps.items():
        kern = v["kernel"]
        f, sc = state(name, v)
        rotate_run(kern, f, sc, 1, 1)      # the single-step library loaded
        (want, _), wall1 = timed(lambda: rotate_run(kern, f, sc, 1, STEPS_RUN))
        row = {"phase": "main_path_k_steps", "variant": name + tag,
               "shape": list(STEPS_FULL[v["solver"]]), "steps": STEPS_RUN,
               "ms_per_step": {"1": wall1 / STEPS_RUN * 1e3}}
        for k in STEPS_KS[v["solver"]]:
            label = launch_label(kern, k)
            rotate_run(kern, f, sc, k, k)      # loads the k-step library
            stencil.launches.clear()
            (got, reds), wall = timed(lambda: rotate_run(kern, f, sc, k, STEPS_RUN))
            counts = dict(stencil.launches)
            require(counts == {label: STEPS_RUN // k},
                    f"{name}: run_steps({k}) x {STEPS_RUN // k} launched {counts}")
            launches[f"{name}/k{k}{tag}"] = counts[label]
            same = all(bool(torch.equal(got[t], want[t])) for t in kern.rotations.values())
            require(same, f"{name}: {STEPS_RUN} steps as run_steps({k}) differ from single steps")
            finite = all(bool(torch.isfinite(got[t]).all()) for t in kern.rotations.values())
            require(finite, f"{name}: non-finite fields after run_steps({k})")
            if reds:
                require(all(math.isfinite(float(r)) for r in reds.values()),
                        f"{name}: non-finite reductions")
            row["ms_per_step"][str(k)] = wall / STEPS_RUN * 1e3
            row.setdefault("launches", {})[label] = counts[label]
        emit(row)
        rows.append(row)
        del f, want
        torch.cuda.empty_cache()
    if not hand:
        return {"launches": launches, "runs": rows}
    # the hand kernel, in place, on FIG1's state
    _, f, sc = quickstart.initial_state(FIG1, "cuda")
    f = {n: t.to(dtype) for n, t in f.items()}
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])

    def hand_run(k):
        a, b = f["T2"].clone(), f["T"].clone()
        for _ in range(STEPS_RUN // k):
            a = diffusion3d.diffusion3d_step(a, b, f["Ci"], *args, nsteps=k, alias=True)
            a, b = b, a
        return b

    hand_run(1)
    want, wall1 = timed(lambda: hand_run(1))
    row = {"phase": "main_path_k_steps", "variant": "diffusion3d" + tag, "shape": list(FIG1.shape),
           "steps": STEPS_RUN, "ms_per_step": {"1": wall1 / STEPS_RUN * 1e3}, "launches": {}}
    for k in HAND_KS:
        hand_run(k)
        diffusion3d.launches = 0
        got, wall = timed(lambda: hand_run(k))
        require(diffusion3d.launches == STEPS_RUN // k,
                f"diffusion3d{tag} nsteps={k}: {diffusion3d.launches} launches")
        require(bool(torch.equal(got, want)),
                f"diffusion3d{tag} nsteps={k} differs from single steps")
        launches[f"diffusion3d/k{k}{tag}"] = diffusion3d.launches
        row["launches"][f"diffusion3d/k{k}{tag}"] = diffusion3d.launches
        row.setdefault("layouts", {})[str(k)] = diffusion3d.last_layout
        row["ms_per_step"][str(k)] = wall / STEPS_RUN * 1e3
    emit(row)
    rows.append(row)
    return {"launches": launches, "runs": rows}


def time_k_steps(torch, name, v, k, base, gen, spec) -> dict:
    """CUDA-event medians of one ``run_steps(k)`` launch and of the torch
    twin's k steps at ``base``, the launch's result held to the twin's on
    the same fields (``hold_to``: its difference is ``max_abs_err``), beside
    the bound: the larger of the launch's
    bytes (each field read once, each output written once: one step's A_eff)
    over 3.35 TB/s and its operations over 67 TFLOP/s, the operations being
    each phase's program over its cells, k sweeps and the halo cone
    included (``halo_compute_overhead``: their excess over k cone-free
    sweeps), plus the last sweep's reductions."""
    from repro_torch.core import teff
    from repro_torch.kernels import codegen, codegen_steps

    kern, p, sc = v["kernel"], v["plain"], v["scalars"]
    f = k_fields(torch, v, base, gen)
    call = kern.compiled(nsteps=k, **f, **sc)
    prog, plan, shape = call.program, call.plan, call.shape
    cells = math.prod(call.ir.base_shape)
    tile = shape.tile[0] * shape.tile[1]
    per_tile = sum(math.prod(plan.region(ph, shape)) * codegen.op_count(
        prog.core.ops if ph.stage is None else prog.stages[ph.stage].ops) for ph in plan.phases)
    ops = per_tile / tile * cells
    overhead = ops / (k * cells * prog.ops_per_cell()) - 1.0
    for _, r in prog.reductions:
        ops += (3 if r.kind == "max_abs_diff" else 2) * cells
    a_eff = float(call.ir.io_bytes(call.dtype.itemsize))
    bound_ms, bound_by = bound_of(a_eff, ops)
    err = hold_to(torch, kern, *split_result(kern, kern.run_steps(k, **f, **sc)),
                  *split_result(p, p.run_steps(k, **f, **sc)),
                  f"{name}: run_steps({k}) against its plain version at {base}")
    ms = teff.measure(lambda: kern.run_steps(k, **f, **sc), iters=20, warmup=3).median_s * 1e3
    plain_ms = teff.measure(lambda: p.run_steps(k, **f, **sc), iters=5, warmup=1).median_s * 1e3
    return {"k": k, "max_abs_err": err, "ms": ms, "ms_per_step": ms / k, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_ms_per_step": bound_ms / k, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "a_eff_bytes": a_eff, "ops": ops,
            "halo_compute_overhead": overhead,
            "t_eff_per_step_GBps": a_eff * k / (ms / 1e3) / 1e9,
            "t_eff_per_step_over_copy": a_eff * k / (ms / 1e3) / spec.peak_bw,
            "smem_bytes": codegen_steps.shared_bytes(prog, plan, shape, call.dtype),
            "tile": list(shape.tile), "planes": shape.planes, "threads": shape.threads,
            "blocks_by_shared": codegen_steps.resident_blocks(prog, call.rotations, k, shape),
            "layout": codegen.layout_name(shape), "lead": plan.lead,
            "lead_share": plan.lead / (call.derive(torch.cuda.get_device_properties(
                0).multi_processor_count).xc + plan.lead)}


def k_step_row(t, log: dict, single_ms) -> dict:
    """A ``time_k_steps`` row with ptxas's registers and spills (``log``:
    ``ptxas_summary``), the blocks resident an SM, and, beside the single
    step's ms (``single_ms``,
    None where the single step is not timed), whether a step of the launch
    takes no longer (``at_most_single_step``)."""
    t["ptxas"] = log
    t["registers"] = log.get("registers")
    # resident blocks an SM: shared memory, threads and registers
    regs = -(-(t["registers"] or 8) // 8) * 8
    t["blocks"] = min(t["blocks_by_shared"], 65536 // (t["threads"] * regs))
    t["spilled"] = bool(log.get("spills"))
    t["single_step_ms"] = single_ms
    t["at_most_single_step"] = None if single_ms is None else t["ms_per_step"] <= single_ms
    return t


def time_hand_steps(torch, k, gen, spec, dtype=None) -> dict:
    """The hand kernel's k steps at FIG1 in place, beside k plain steps and
    the bound (T, Ci and the output once: 12 bytes per cell in f32, 6 in
    bf16 or f16; 16 operations per cell-sweep over the cone,
    ``teff.halo_compute_overhead`` of its tile), with its layout
    (``diffusion3d.layout``: tile, threads, resident blocks, where Ci
    comes from)."""
    from repro_torch.core import teff
    from repro_torch.kernels import diffusion3d, ref

    dtype = dtype or torch.float32
    base = STEPS_FULL["fig1"]
    T = torch.rand(base, generator=gen, device=gen.device).to(dtype)
    T2, Ci = T.clone(), (torch.rand(base, generator=gen, device=gen.device) + 0.5).to(dtype)
    args = (1.0, 1e-4, 511.0, 511.0, 511.0) if dtype == torch.float32 else HAND_MIXED_ARGS
    cells = math.prod(base)
    interior = math.prod(n - 2 for n in base)
    by, bz = diffusion3d.tile_rows(k, dtype.itemsize), diffusion3d._TILE_Z
    overhead = teff.halo_compute_overhead((by, bz), 1, k) if k > 1 else 0.0
    a_eff, ops = 3.0 * dtype.itemsize * cells, 16.0 * interior * k * (1 + overhead)
    bound_ms, bound_by = bound_of(a_eff, ops)
    want = ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k)
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=True)
    err = max_abs_diff(got, want)
    require(bool(torch.equal(got, want)), f"diffusion3d nsteps={k} differs from its plain "
            f"version at {base} by {err}")
    ms = teff.measure(lambda: diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k,
                                                           alias=True),
                      iters=20, warmup=3).median_s * 1e3
    plain_ms = teff.measure(lambda: ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k),
                            iters=5, warmup=1).median_s * 1e3
    return {"k": k, "max_abs_err": err, "ms": ms, "ms_per_step": ms / k, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_ms_per_step": bound_ms / k, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "a_eff_bytes": a_eff, "ops": ops,
            "halo_compute_overhead": overhead,
            "t_eff_per_step_GBps": a_eff * k / (ms / 1e3) / 1e9,
            "t_eff_per_step_over_copy": a_eff * k / (ms / 1e3) / spec.peak_bw,
            "smem_bytes": diffusion3d.shared_bytes(k, dtype.itemsize), "alias": True,
            "layout": diffusion3d.last_layout}


# the storage types as the compiler mangles them, and their tags
MANGLED = {"f": "", "13__nv_bfloat16": ":bf16", "6__half": ":f16"}


def hand_ptxas(log: str) -> dict:
    """ptxas's summary of each instance of the hand kernel: the k-step ones
    (``diffusion3d_steps_kernel<K, S>``) as ``diffusion3d/k{K}``, the
    single step's two (``diffusion3d_kernel<kCopyRing, S>``, merged) as
    ``diffusion3d`` and, at 2 bytes, the pair layout's two
    (``diffusion3d_pairs_kernel<kCopyRing, S>``) as ``diffusion3d/pairs``,
    each with the storage tag of S (``:bf16``, ``:f16``)."""
    out = {}
    types = "|".join(MANGLED)
    for part in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        head = part.split("\n", 1)[0]
        m = re.search(rf"diffusion3d_steps_kernelILi(\d+)E({types})E", head)
        if m:
            out[f"diffusion3d/k{m.group(1)}{MANGLED[m.group(2)]}"] = ptxas_summary(part)
        m = re.search(rf"diffusion3d_(pairs_)?kernelILb[01]E({types})E", head)
        if m:
            key = f"diffusion3d{'/pairs' if m.group(1) else ''}{MANGLED[m.group(2)]}"
            one = ptxas_summary(part)
            if key in out:
                one = {"registers": max(out[key]["registers"] or 0, one["registers"] or 0),
                       "smem_bytes": max(out[key]["smem_bytes"], one["smem_bytes"]),
                       "spills": out[key]["spills"] + one["spills"]}
            out[key] = one
    return out


# ---- sub-f32 storage ---------------------------------------------------------
def fig1_hand_args() -> tuple:
    """FIG1's scalars as the hand kernel takes them (``quickstart.initial_state``'s)."""
    from repro_torch.configs import FIG1
    from repro_torch.core import Grid

    grid = Grid(FIG1.shape, (FIG1.lx, FIG1.ly, FIG1.lz))
    return (FIG1.lam, grid.stable_diffusion_dt(FIG1.lam / FIG1.c0), *grid.inv_spacing)


def hand_fits(torch, dtype, args) -> bool:
    """Whether the hand kernel's scalars, rounded to ``dtype``, are finite."""
    from repro_torch.kernels import ref

    return all(math.isfinite(v) for v in ref.stored_scalars(dtype, *args))


def retyped(variants, dtype) -> dict:
    """Each variant with its kernel and its torch twin storing their fields
    as ``dtype`` (computed in f32)."""
    return {name: dict(v, kernel=v["kernel"].with_dtype(dtype),
                       plain=v["plain"].with_dtype(dtype)) for name, v in variants.items()}


def check_fig1_mixed(torch, variants, generic_pair, dtype, tag, gen, dev) -> dict:
    """FIG1's three generated variants at ``dtype`` against the torch
    backend at the same dtype, at every shape of SHAPES (outputs bitwise,
    max reductions bitwise, sums within SUM_RTOL), and the generic
    two-output kernel at the small ones. Returns each variant's error at
    full size, by ``{label}:{tag}``."""
    errs = {}
    for shape in SHAPES:
        T = torch.rand(shape, generator=gen).to(dev).to(dtype)
        T2 = torch.rand(shape, generator=gen).to(dev).to(dtype)
        Ci = (torch.rand(shape, generator=gen) + 0.5).to(dev).to(dtype)
        sc = {"lam": 1.0, "dt": 1e-4, "_dx": float(shape[0] - 1),
              "_dy": float(shape[1] - 1), "_dz": float(shape[2] - 1)}
        row = {"phase": "check_mixed", "dtype": str(dtype), "shape": list(shape)}
        for label, (kern, plain) in variants.items():
            k, pl = kern.with_dtype(dtype), plain.with_dtype(dtype)
            got, want = split_result(k, k(T2=T2, T=T, Ci=Ci, **sc)), \
                split_result(pl, pl(T2=T2, T=T, Ci=Ci, **sc))
            require(got[0]["T2"].dtype == dtype, f"{label}:{tag} returns {got[0]['T2'].dtype}")
            d = hold_to(torch, k, *got, *want, f"{label}:{tag} against the torch backend "
                                               f"at {shape}")
            row[label] = {"max_abs_diff": d, "reductions": {
                n: [float(got[1][n]), float(want[1][n])] for n in got[1]}}
            errs[f"{label}:{tag}"] = d
        if shape != SHAPES[-1]:
            gk, gp_ = (g.with_dtype(dtype) for g in generic_pair)
            fa = {n: torch.rand(shape, generator=gen).to(dev).to(dtype)
                  for n in ("A2", "B2", "A", "B")}
            row["generic_max_abs_diff"] = hold_to(
                torch, gk, *split_result(gk, gk(**fa, c=0.3, h=0.7)),
                *split_result(gp_, gp_(**fa, c=0.3, h=0.7)), f"generic:{tag} at {shape}")
        emit(row)
        del T, T2, Ci
    return errs


def mixed_main_path(torch, spec, coupled_runs) -> dict:
    """The main path with fields stored bf16 and f16 (computed in f32), each
    run with the launch counts set to 0 just before it and read just after:

    * FIG1 at 512^3 through ``init_parallel_stencil(dtype=...)``: MIXED_STEPS
      steps of the generated step, the same steps with the hand kernel
      (which computes at the storage dtype), then ``solve_until``
      (``check_every = 10``), beside the same run in f32 (as
      ``benchmarks/bench_teff.py::bench_mixed`` pairs them). ms per step
      (host clock), T_eff at storage bytes over the copy bandwidth, and one
      step against the f32 step from the same state within 4 eps max|T|;
    * porosity 8192^2 ``--dtype`` through the twin's ``solve`` (a fixed run
      and a ``--tol`` run), its anomaly's y beside the f32 runs';
    * GP's fused kernel at 512^3 on its own state, GP_STEPS steps.
    """
    from repro_torch.configs import FIG1
    from repro_torch.core import init_parallel_stencil, iterate, teff
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw, quickstart
    from repro_torch.kernels import diffusion3d, stencil

    _, f32f, sc = quickstart.initial_state(FIG1, "cuda")
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
    launches, rows, one, ran = {}, [], {}, {}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for tag, name in (("f32", "float32"), *MIXED_TAGS.items()):
        dt = getattr(torch, name)
        step = quickstart.make_step(init_parallel_stencil(dtype=dt))
        conv = step.with_reductions(ERR)
        f = {n: t.to(dt) for n, t in f32f.items()}
        hand = hand_fits(torch, dt, args)
        # the libraries loaded, and one step from the initial state
        one[tag] = step(**f, **sc)
        conv(**f, **sc)
        if hand:
            diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args, alias=False)

        def fig1_steps():
            T, T2 = f["T"], f["T2"]
            for _ in range(MIXED_STEPS):
                T2 = step(T2=T2, T=T, Ci=f["Ci"], **sc)
                T, T2 = T2, T
            return T, T2

        def hand_steps():
            T, T2 = f["T"], f["T2"]
            for _ in range(MIXED_STEPS):
                T2 = diffusion3d.diffusion3d_step(T2, T, f["Ci"], *args, alias=False)
                T, T2 = T2, T
            return T

        stencil.launches.clear()
        diffusion3d.launches = 0
        (T, T2), t_steps = wall(fig1_steps)
        T_hand, t_hand = wall(hand_steps) if hand else (None, None)
        res, t_solve = wall(lambda: iterate.solve_until(
            conv, dict(T2=T2, T=T, Ci=f["Ci"]), sc, tol=1e-7, max_iters=1000, check_every=10))
        counts = {**stencil.launches, "diffusion3d": diffusion3d.launches}
        lab, lab_err = launch_label(step), launch_label(conv)
        require(counts[lab] == MIXED_STEPS + res.iters - res.host_syncs
                and counts[lab_err] == res.host_syncs
                and counts["diffusion3d"] == (MIXED_STEPS if hand else 0),
                f"FIG1 {tag}: launches {counts}")
        require(res.host_syncs == res.iters // 10, f"FIG1 {tag}: host syncs {res.host_syncs}")
        out = res.output(conv)
        ran[tag] = T
        isz = dt.itemsize
        ir = step.stencil_ir(**f, **sc)
        a_eff = teff.a_eff_from_ir(ir, isz, field_itemsizes={n: isz for n in ir.field_shapes})
        # a few ulps of storage rounding at T ~ 2
        eps = torch.finfo(dt).eps if tag != "f32" else 0.0
        slack = T_SLACK + MIXED_ONE_STEP_EPS * eps * T_RANGE[1]
        lo, hi = T_RANGE[0] - slack, T_RANGE[1] + slack
        stats = {n: {"finite": bool(torch.isfinite(t).all()), "min": float(t.min()),
                     "max": float(t.max())} for n, t in (("T", T), ("T_hand", T_hand),
                                                          ("solve_T", out)) if t is not None}
        ms = t_steps / MIXED_STEPS * 1e3
        row = {"phase": "main_path_mixed", "config": "FIG1", "dtype": name,
               "shape": list(FIG1.shape), "steps": MIXED_STEPS, "launches": counts,
               "ms_per_step": ms,
               "hand_ms_per_step": t_hand / MIXED_STEPS * 1e3 if hand else
               "not run: FIG1's scalars rounded to this dtype overflow it",
               "hand_layout": diffusion3d.last_layout if hand else None,
               "solve": {"iters": res.iters, "err": res.err, "host_syncs": res.host_syncs,
                         "ms_per_step": t_solve / max(res.iters, 1) * 1e3, "tol": 1e-7},
               "a_eff_bytes": a_eff, "t_eff_GBps": a_eff / (ms / 1e3) / 1e9,
               "t_eff_over_copy": a_eff / (ms / 1e3) / spec.peak_bw, "fields": stats,
               "generated_vs_hand_max_abs_diff": max_abs_diff(T.float(), T_hand.float())
               if hand else None}
        if tag != "f32":
            bound = MIXED_ONE_STEP_EPS * eps * float(f32f["T"].abs().max())
            d1 = max_abs_diff(one[tag].float(), one["f32"])
            row["one_step_vs_f32"] = {"max_abs_diff": d1, "bound": bound}
            row["after_steps_vs_f32_max_abs_diff"] = max_abs_diff(T.float(), ran["f32"])
            require(d1 <= bound, f"FIG1 {tag}: one step differs from f32 by {d1} > {bound}")
            launches[f"stencil:{tag}"] = counts[lab]
            launches[f"stencil+err:{tag}"] = counts[lab_err]
            if hand:
                launches[f"diffusion3d:{tag}"] = counts["diffusion3d"]
        emit(row)
        rows.append(row)
        for n, st in stats.items():
            require(st["finite"], f"FIG1 {tag}: {n} holds non-finite values")
            require(lo <= st["min"] and st["max"] <= hi,
                    f"FIG1 {tag}: {n} leaves [{lo}, {hi}]: [{st['min']}, {st['max']}]")
        del f, T, T2, T_hand, res, out
    del one, ran
    torch.cuda.empty_cache()

    # porosity 8192^2 --dtype, a fixed run and a --tol run, beside f32's
    f32_rows = {r["run"]: r for r in coupled_runs["runs"] if r["solver"] == "porosity"}
    n_pw = COUPLED_FULL["porosity"][0]
    for tag, name in MIXED_TAGS.items():
        for run, kw, names in (
                ("fixed", dict(nt=PW_STEPS), {"update": "porosity_fused[neumann0]"}),
                ("tol", dict(nt=PW_TOL_CAP, tol=PW_TOL, check_every=10),
                 {"update": "porosity_fused[neumann0]",
                  "update[err]": "porosity_fused[neumann0]+err"})):
            def solve(nt):
                return pw.solve(pw.PorosityConfig(n=n_pw, device="cuda", dtype=name,
                                                  **dict(kw, nt=nt)))
            short_nt = kw.get("check_every", 1)
            solve(short_nt)                      # loads the libraries
            _, short = wall(lambda: solve(short_nt))
            stencil.launches.clear()
            r, t = wall(lambda: solve(kw["nt"]))
            counts = dict(stencil.launches)
            steps = r["iters"]
            checks = steps // 10 if "tol" in kw else 0
            want = {f"{c}:{tag}": (checks if c.endswith("]") else steps - checks) for c in names}
            require(counts == want, f"porosity {tag} {run}: launches {counts}, expected {want}")
            for c, v in names.items():
                launches[f"{v}:{tag}"] = launches.get(f"{v}:{tag}", 0) + counts[f"{c}:{tag}"]
            ms = ((t - short) / (steps - short_nt) if steps > short_nt else t / steps) * 1e3
            isz = getattr(torch, name).itemsize
            a_eff = 4 * n_pw * n_pw * isz      # phi, Pe read; phi2, Pe2 written
            finite = bool(torch.isfinite(r["phi"]).all() and torch.isfinite(r["Pe"]).all())
            row = {"phase": "main_path_mixed", "config": "porosity", "dtype": name, "run": run,
                   "shape": [n_pw, n_pw], "steps": steps, "launches": counts,
                   "layout": porosity_layout(name, n_pw),
                   "ms_per_step": ms, "a_eff_bytes_per_step": a_eff,
                   "t_eff_GBps": a_eff / (ms / 1e3) / 1e9,
                   "t_eff_over_copy": a_eff / (ms / 1e3) / spec.peak_bw,
                   "phi_range": [r["phi_min"], r["phi_max"]], "residual": r["residual"],
                   "host_syncs": r["host_syncs"], "finite": finite,
                   "peak_y": [r["peak0_y"], r["peak_y"]],
                   "f32": {"ms_per_step": f32_rows[run]["ms_per_step"],
                           "peak_y": [f32_rows[run]["peak0_y"], f32_rows[run]["peak_y"]]}}
            emit(row)
            rows.append(row)
            require(finite, f"porosity {tag} {run}: non-finite fields")
            require(abs(r["peak_y"] - r["peak0_y"]) <= 1.5 * r["grid"].spacing[1]
                    or r["peak_y"] > r["peak0_y"],
                    f"porosity {tag} {run}: the anomaly left its place downward "
                    f"({r['peak0_y']} -> {r['peak_y']})")
            del r
    torch.cuda.empty_cache()

    # GP's fused kernel on its own state, stored bf16 and f16
    cfg = gp.GPConfig(n=COUPLED_FULL["gp"][0], device="cuda")
    grid, re, im, V = gp.init_state(cfg)
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
    gsc = dict(g=cfg.g, dt=gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
    kern32 = gp.make_step(grid, cfg).kernels[0]
    dv = math.prod(grid.spacing)
    mass0 = float((re.double() ** 2 + im.double() ** 2).sum()) * dv
    for tag, name in MIXED_TAGS.items():
        dt = getattr(torch, name)
        kern = kern32.with_dtype(dt)
        cur = dict(re2=re.to(dt), im2=im.to(dt), re=re.to(dt), im=im.to(dt), V=V.to(dt))
        kern(**cur, **gsc)                   # loads the library
        stencil.launches.clear()

        def gp_steps():
            c = dict(cur)
            for _ in range(GP_STEPS):
                o = kern(**c, **gsc)
                c["re2"], c["re"] = c["re"], o["re2"]
                c["im2"], c["im"] = c["im"], o["im2"]
            return c

        c, t = wall(gp_steps)
        counts = dict(stencil.launches)
        require(counts == {f"update:{tag}": GP_STEPS}, f"GP {tag}: launches {counts}")
        launches[f"gp_fused[none]:{tag}"] = GP_STEPS
        mass = float((c["re"].double() ** 2 + c["im"].double() ** 2).sum()) * dv
        finite = bool(torch.isfinite(c["re"]).all() and torch.isfinite(c["im"]).all())
        row = {"phase": "main_path_mixed", "config": "gp", "dtype": name,
               "shape": list(COUPLED_FULL["gp"]), "steps": GP_STEPS, "launches": counts,
               "layout": kern.launch_info[tuple(COUPLED_FULL["gp"])]["layout"],
               "ms_per_step": t / GP_STEPS * 1e3, "mass0": mass0, "mass": mass,
               "drift": abs(mass - mass0) / mass0, "finite": finite}
        emit(row)
        rows.append(row)
        require(finite, f"GP {tag}: non-finite fields")
        del cur, c
    del re, im, V
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": rows}


def porosity_layout(dtype_name: str, n: int) -> str:
    """The layout porosity's fused kernel takes at ``n``^2, fields stored as
    ``dtype_name`` (what ``porosity_waves.solve`` launches)."""
    from repro_torch.examples import porosity_waves as pw
    from repro_torch.kernels import codegen

    cfg = pw.PorosityConfig(n=n, device="cuda", dtype=dtype_name)
    kern = pw.make_step(pw.make_grid(cfg), cfg).kernels[0]
    call = kern.compiled(**{f: (n, n) for f in ("phi2", "Pe2", "phi", "Pe")}, dtau=1e-3)
    return codegen.layout_name(call.shape)


def time_mixed(torch, tag, dtype, step, step_plain, coupled_t, ksteps_t, gen, spec,
               ptxas, cell_ptx) -> dict:
    """CUDA-event medians (20) of each kernel of the mixed main path at
    ``dtype`` beside its plain version at the same dtype and its bound at
    storage bytes (2 per cell of each field): FIG1's step and its ``err``
    variant, the hand step (a new buffer; in place beside it), every coupled
    variant (those off the mixed main path too; each of PAIR_VARIANTS beside
    its one-cell layout in turns, ``beside_cells``), and the k-step kernels
    of MIXED_K_VARIANTS and the hand kernel (k = 2-4). Registers and spills
    from ptxas."""
    from repro_torch.configs import FIG1
    from repro_torch.core import teff
    from repro_torch.examples import quickstart
    from repro_torch.kernels import diffusion3d, ref

    out = {}
    _, f, sc = quickstart.initial_state(FIG1, "cuda")
    f = {n: t.to(dtype) for n, t in f.items()}
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
    for name, kern, plain in (("stencil", step, step_plain),
                              ("stencil+err", step.with_reductions(ERR),
                               step_plain.with_reductions(ERR))):
        k, p = kern.with_dtype(dtype), plain.with_dtype(dtype)
        a_eff, ops = tap_cost(k.compiled(**f, **sc))
        bound_ms, bound_by = bound_of(a_eff, ops)
        ms = teff.measure(lambda: k(**f, **sc), iters=20, warmup=3).median_s * 1e3
        plain_ms = teff.measure(lambda: p(**f, **sc), iters=10, warmup=2).median_s * 1e3
        out[f"{name}:{tag}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                                "a_eff_bytes": a_eff, "ops": ops,
                                "t_eff_over_copy": a_eff / (ms / 1e3) / spec.peak_bw,
                                "ptxas": ptxas[f"{name}:{tag}"]}
        if k.compiled(**f, **sc).shape.vec > 1:
            t = out[f"{name}:{tag}"]
            t.update(beside_cells(torch, k, f, sc, cell_ptx))
            # no more than 2% slower than the one-cell layout
            require(t["ms_in_turns"] <= 1.02 * t["cell_ms"],
                    f"{name}:{tag}: the pair layout ({t['ms_in_turns']} ms) is slower than its "
                    f"one-cell layout ({t['cell_ms']} ms)")
    hand = time_hand_steps(torch, 1, gen, spec, dtype)       # in place
    new_ms = teff.measure(lambda: diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args,
                                                               alias=False),
                          iters=20, warmup=3).median_s * 1e3
    plain_ms = teff.measure(lambda: ref.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args),
                            iters=10, warmup=2).median_s * 1e3
    out[f"diffusion3d:{tag}"] = {**hand, "ms": new_ms, "in_place_ms": hand["ms"],
                                 "plain_ms": plain_ms, "share_of_bound": hand["bound_ms"] / new_ms,
                                 **hand_beside_cells(torch, f, args, ptxas, tag)}
    del f
    for name, v in coupled_t.items():
        t = time_coupled(torch, v, COUPLED_FULL[v["solver"]], gen)
        t["ptxas"] = ptxas[f"{name}:{tag}"]
        if name in PAIR_VARIANTS or "/v" in t["layout"]:
            t.update(beside_cells(torch, v["kernel"], coupled_fields(
                torch, v, COUPLED_FULL[v["solver"]], gen), v["scalars"], cell_ptx))
            t["faster_than_cells"] = t["ms_in_turns"] < t["cell_ms"]
            require(t["faster_than_cells"] or name not in PAIR_TARGETS_MS,
                    f"{name}:{tag}: the pair layout ({t['ms_in_turns']} ms) is not faster than "
                    f"its one-cell layout ({t['cell_ms']} ms)")
        out[f"{name}:{tag}"] = t
        torch.cuda.empty_cache()
    for name in MIXED_K_VARIANTS:
        v = ksteps_t[name]
        for k in STEPS_KS[v["solver"]]:
            t = time_k_steps(torch, name, v, k, STEPS_FULL[v["solver"]], gen, spec)
            # beside the single step at the same dtype (the pair layout where it applies)
            out[f"{name}/k{k}:{tag}"] = k_step_row(t, ptxas[f"{name}/k{k}:{tag}"],
                                                   out[f"{name}:{tag}"]["ms"])
            torch.cuda.empty_cache()
    for k in HAND_KS:
        t = time_hand_steps(torch, k, gen, spec, dtype)
        t["ptxas"] = ptxas[f"diffusion3d/k{k}:{tag}"]
        out[f"diffusion3d/k{k}:{tag}"] = t
    return out


def hand_beside_cells(torch, f, args, ptxas, tag) -> dict:
    """The hand single step at 2 bytes into a new buffer in its pair layout
    (``f``, FIG1's fields) and in its one-cell layout (the same values two
    bytes off a word), bitwise to each other, timed in turns (pairs, cells,
    cells, pairs; CUDA-event medians of 20), each the mean of its two; the
    pair layout must be the faster."""
    from repro_torch.core import teff
    from repro_torch.kernels import diffusion3d

    cells = [off_word(torch, f[n]) for n in ("T2", "T", "Ci")]
    runs = {"pairs": lambda: diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args,
                                                          alias=False),
            "cells": lambda: diffusion3d.diffusion3d_step(*cells, *args, alias=False)}
    got = {}
    for which, fn in runs.items():
        got[which] = fn()
        got[which + "_layout"] = diffusion3d.last_layout
    require(got["pairs_layout"] == "pairs" and got["cells_layout"] == "cells"
            and same(torch, got["pairs"], got["cells"]),
            f"diffusion3d:{tag}: the pair layout differs from the one-cell layout")
    ms = {"pairs": [], "cells": []}
    for which in ("pairs", "cells", "cells", "pairs"):
        ms[which].append(teff.measure(runs[which], iters=20, warmup=3).median_s * 1e3)
    t = {"layout": "pairs", "ms_in_turns": sum(ms["pairs"]) / 2, "cell_layout": "cells",
         "cell_ms": sum(ms["cells"]) / 2, "ptxas": ptxas[f"diffusion3d/pairs:{tag}"],
         "cell_ptxas": ptxas[f"diffusion3d:{tag}"]}
    require(t["ms_in_turns"] < t["cell_ms"],
            f"diffusion3d:{tag}: the pair layout ({t['ms_in_turns']} ms) is not faster than "
            f"the one-cell layout ({t['cell_ms']} ms)")
    return t


# the hand kernel's targets on the H100 (ms): the 2-byte single step into a
# new buffer in its pair layout, the k-step form per step beside the
# in-place single step it replaces
HAND_TARGETS_MS = {"diffusion3d:bf16": (0.40, 0.4808)}
HAND_STEP_TARGETS_MS = {"": 0.5838, ":bf16": 0.5549}


def hand_targets(k_times, mixed_times) -> dict:
    """Which of the hand kernel's targets the run met: each single step
    (aim, firm) and each k-step form's ms per step below its single step."""
    out = {}
    for name, (aim, firm) in HAND_TARGETS_MS.items():
        ms = mixed_times[name]["ms_in_turns"]
        out[name] = {"ms": ms, "aim_ms": aim, "firm_ms": firm, "aim_met": ms <= aim,
                     "firm_met": ms <= firm}
    times = {**k_times, **mixed_times}
    for tag, limit in HAND_STEP_TARGETS_MS.items():
        for k in HAND_KS:
            t = times[f"diffusion3d/k{k}{tag}"]
            out[f"diffusion3d/k{k}{tag}"] = {"ms_per_step": t["ms_per_step"],
                                             "below_ms": limit, "met": t["ms_per_step"] < limit}
    return out


# ---- the pair layout of the all-parallel kernel for 2-byte fields -----------------
# The kernels redesigned for bf16 and f16 fields (several adjacent cells of the
# contiguous axis a thread, kernels/codegen_pairs.py), each held and timed
# beside the one-cell layout of the same program; small shapes whose
# contiguous extent is odd, which the pairs do not fit (the one-cell layout).
PAIR_VARIANTS = ("porosity_fused[none]", "porosity_fused[neumann0]", "porosity_fused[dirichlet]",
                 "porosity_fused[periodic]", "porosity_fused[neumann0]+err", "gp_fused[none]",
                 "gp_fused[neumann0]", "gp_fused[dirichlet]", "gp_fused[periodic]",
                 "gp_fused[none]+mass")
COUPLED_ODD = {"porosity": (33, 21), "gp": (13, 17, 129)}
# the pair layout's targets at bf16 (ms on the H100)
PAIR_TARGETS_MS = {"porosity_fused[neumann0]": 0.36, "gp_fused[none]": 1.00}
PAIR_SOURCE = "src/repro_torch/kernels/codegen_pairs.py"
# f32 words the packed conversions are held on: every bf16 and f16 value, the
# midpoints between bf16 neighbours and the words beside them, edges, random
CONVERT_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
namespace {
// each pair of adjacent elements converted one at a time and packed
__global__ void convert_kernel(const float* x, const uint16_t* h, uint16_t* one, uint16_t* two,
                               float* wone, float* wtwo, int64_t n, int half) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i + 1 >= n) return;
  if (half) {
    one[i] = __half_as_ushort(__float2half_rn(x[i]));
    one[i + 1] = __half_as_ushort(__float2half_rn(x[i + 1]));
    *reinterpret_cast<__half2*>(two + i) = __floats2half2_rn(x[i], x[i + 1]);
    wone[i] = __half2float(__ushort_as_half(h[i]));
    wone[i + 1] = __half2float(__ushort_as_half(h[i + 1]));
    const float2 w = __half22float2(*reinterpret_cast<const __half2*>(h + i));
    wtwo[i] = w.x, wtwo[i + 1] = w.y;
  } else {
    one[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i]));
    one[i + 1] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i + 1]));
    *reinterpret_cast<__nv_bfloat162*>(two + i) = __floats2bfloat162_rn(x[i], x[i + 1]);
    wone[i] = __bfloat162float(__ushort_as_bfloat16(h[i]));
    wone[i + 1] = __bfloat162float(__ushort_as_bfloat16(h[i + 1]));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + i));
    wtwo[i] = w.x, wtwo[i + 1] = w.y;
  }
}
}  // namespace
extern "C" int launch(const void* x, const void* h, void* one, void* two, void* wone,
                      void* wtwo, int64_t n, int64_t half, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n / 2 + 255) / 256);
  convert_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(h), static_cast<uint16_t*>(one),
      static_cast<uint16_t*>(two), static_cast<float*>(wone), static_cast<float*>(wtwo), n,
      static_cast<int>(half));
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


# The packed 2-byte arithmetic the hand kernel computes with
# (csrc/diffusion3d.cu, Packed<S>) held to f32-then-round, the plain
# version's arithmetic, over every pair of 16-bit operands: block a of the
# grid takes operand a, each thread every 512th pair (b, b + 1) of the other
# operand; a - b is a + (-b) as the kernel computes it. A result equals its
# reference bit for bit, or both are NaN.
PACKED_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
namespace {
__device__ __forceinline__ float wide(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float wide(__half v) { return __half2float(v); }
template <typename V> struct Ops;
template <> struct Ops<__nv_bfloat162> {
  using S = __nv_bfloat16;
  static __device__ S of(uint16_t u) { return __ushort_as_bfloat16(u); }
  static __device__ uint16_t bits(S v) { return __bfloat16_as_ushort(v); }
  static __device__ S narrow(float f) { return __float2bfloat16_rn(f); }
  static __device__ bool nan(uint16_t u) { return (u & 0x7fffu) > 0x7f80u; }
  static __device__ __nv_bfloat162 pack(S a, S b) { return __halves2bfloat162(a, b); }
  static __device__ S lo(__nv_bfloat162 v) { return __low2bfloat16(v); }
  static __device__ S hi(__nv_bfloat162 v) { return __high2bfloat16(v); }
};
template <> struct Ops<__half2> {
  using S = __half;
  static __device__ S of(uint16_t u) { return __ushort_as_half(u); }
  static __device__ uint16_t bits(S v) { return __half_as_ushort(v); }
  static __device__ S narrow(float f) { return __float2half_rn(f); }
  static __device__ bool nan(uint16_t u) { return (u & 0x7fffu) > 0x7c00u; }
  static __device__ __half2 pack(S a, S b) { return __halves2half2(a, b); }
  static __device__ S lo(__half2 v) { return __low2half(v); }
  static __device__ S hi(__half2 v) { return __high2half(v); }
};
template <typename O>
__device__ __forceinline__ unsigned long long differs(typename O::S got, float want) {
  const uint16_t g = O::bits(got), w = O::bits(O::narrow(want));
  return g != w && !(O::nan(g) && O::nan(w));
}
// counts[0..2]: mismatches of a + b, a - b, a * b; first[0..2]: the first
// (a << 16 | b) of each found
template <typename V>
__global__ void packed_kernel(unsigned long long* counts, unsigned* first) {
  using O = Ops<V>;
  const uint16_t ua = static_cast<uint16_t>(blockIdx.x);
  const typename O::S sa = O::of(ua);
  const V a = O::pack(sa, sa);
  const float fa = wide(sa);
  unsigned long long n[3] = {0, 0, 0};
  for (unsigned b = 2 * threadIdx.x; b < 65536u; b += 2 * blockDim.x) {
    const typename O::S s0 = O::of(static_cast<uint16_t>(b)), s1 = O::of(static_cast<uint16_t>(b + 1));
    const V v = O::pack(s0, s1);
    const float f0 = wide(s0), f1 = wide(s1);
    const V r[3] = {__hadd2_rn(a, v), __hadd2_rn(a, __hneg2(v)), __hmul2_rn(a, v)};
    const float w0[3] = {fa + f0, fa - f0, fa * f0}, w1[3] = {fa + f1, fa - f1, fa * f1};
    #pragma unroll
    for (int op = 0; op < 3; ++op) {
      const unsigned long long d0 = differs<O>(O::lo(r[op]), w0[op]);
      const unsigned long long d1 = differs<O>(O::hi(r[op]), w1[op]);
      if (d0 | d1) atomicCAS(first + op, 0xffffffffu, (unsigned(ua) << 16) | (d0 ? b : b + 1));
      n[op] += d0 + d1;
    }
  }
  for (int op = 0; op < 3; ++op) {
    if (n[op]) atomicAdd(counts + op, n[op]);
  }
}
}  // namespace
extern "C" int launch(void* counts, void* first, int64_t half, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (half) {
    packed_kernel<__half2><<<65536, 256, 0, st>>>(
        static_cast<unsigned long long*>(counts), static_cast<unsigned*>(first));
  } else {
    packed_kernel<__nv_bfloat162><<<65536, 256, 0, st>>>(
        static_cast<unsigned long long*>(counts), static_cast<unsigned*>(first));
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def check_packed_ops(torch, dev) -> dict:
    """The hand kernel's packed bf16 and f16 arithmetic (``__hadd2_rn``,
    ``__hadd2_rn`` of ``__hneg2``, ``__hmul2_rn``) against f32-then-round
    on the card over all 2^32 operand pairs of each type and operation
    (``PACKED_SOURCE``); any mismatch fails the run."""
    import ctypes

    from repro_torch.kernels import build, stencil

    lib = build.Library("packed_ops", PACKED_SOURCE,
                        [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p])
    row = {"phase": "check_packed_ops", "pairs": 1 << 32}
    for tag, name in MIXED_TAGS.items():
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        first = torch.full((3,), -1, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        lib.launch(counts.data_ptr(), first.data_ptr(), int(name == "float16"),
                   stencil.stream_of(dev))
        torch.cuda.synchronize()
        row[tag] = {op: {"mismatches": int(n), "first": f"{int(f) & 0xffffffff:#010x}"}
                    for op, n, f in zip(("add", "sub", "mul"), counts.tolist(), first.tolist())}
        row[tag]["seconds"] = time.perf_counter() - t0
    emit(row)
    require(all(v["mismatches"] == 0 for tag in MIXED_TAGS for k, v in row[tag].items()
                if k != "seconds"),
            f"the packed 2-byte arithmetic differs from f32-then-round: {row}")
    return row


def convert_words(torch):
    """The f32 words of the conversion check (an even count)."""
    u16 = torch.arange(1 << 16, dtype=torch.int64)
    words = [u16 << 16, (u16 << 16) | 0x8000, ((u16 << 16) | 0x8000) + 1,
             ((u16 << 16) | 0x8000) - 1,
             torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.float16)
             .float().view(torch.int32).to(torch.int64) & 0xffffffff,
             torch.tensor([0, 0x80000000, 0x7f800000, 0xff800000, 0x7fc00000, 0xffc00001,
                           0x7f800001, 0x477fefff, 0x477ff000, 0x477ff001, 0x47800000,
                           0x33000000, 0x33000001, 0x1, 0x807fffff, 0x7f7fffff]),
             torch.randint(0, 1 << 32, (1 << 20,), generator=torch.Generator().manual_seed(7))]
    w = torch.cat(words) & 0xffffffff
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return torch.cat([w, w.flip(0)]).view(torch.float32)


def pair_keys(t) -> dict:
    """The kernels-line keys of a pair-layout kernel's times (none for the
    others): its layout, its ms and its one-cell layout's in turns, the share
    of its bound, ptxas's registers and spills."""
    if "ms_in_turns" not in t:
        return {}
    return {"layout": t["layout"], "ms_in_turns": t["ms_in_turns"],
            "cell_layout": t["cell_layout"], "cell_ms": t["cell_ms"],
            "share_of_bound": t["bound_ms"] / t["ms_in_turns"],
            "registers": t["ptxas"]["registers"], "spills": len(t["ptxas"]["spills"]),
            "cell_registers": (t["cell_ptxas"] or {}).get("registers")}


def check_pair_conversions(torch, dev) -> dict:
    """The packed conversions of the pair layout against the one-cell ones
    on the card, bit for bit, NaN payloads, +-inf and the f16 overflow edge
    included (each word in both halves of a pair), and the one-cell ones
    against PyTorch's conversions (NaN as NaN)."""
    import ctypes

    from repro_torch.kernels import build, stencil

    lib = build.Library("pair_conversions", CONVERT_SOURCE,
                        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_void_p])
    x = convert_words(torch).to(dev)
    row = {"phase": "check_pair_conversions", "words": x.numel()}
    for tag, name in MIXED_TAGS.items():
        dt = getattr(torch, name)
        h = torch.arange(1 << 16, dtype=torch.int32, device=dev).to(torch.int16)
        h = torch.cat([h, h.flip(0)])
        n = max(x.numel(), h.numel())
        xs = torch.zeros(n, device=dev)
        xs[:x.numel()] = x
        hs = torch.zeros(n, dtype=torch.int16, device=dev)
        hs[:h.numel()] = h
        outs = [torch.empty(n, dtype=torch.int16, device=dev) for _ in range(2)]
        wides = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(2)]
        lib.launch(xs.data_ptr(), hs.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                   wides[0].data_ptr(), wides[1].data_ptr(), n, int(dt == torch.float16),
                   stencil.stream_of(dev))
        torch.cuda.synchronize()
        one, two = outs[0][:x.numel()], outs[1][:x.numel()]
        wone, wtwo = wides[0][:h.numel()], wides[1][:h.numel()]
        ref = x.to(dt)
        nan = torch.isnan(x)
        r = {"narrow_packed_bitwise": bool(torch.equal(one, two)),
             "widen_packed_bitwise": bool(torch.equal(wone.view(torch.int32),
                                                      wtwo.view(torch.int32))),
             "narrow_vs_torch": bool(torch.equal(one[~nan], ref.view(torch.int16)[~nan]))
             and bool(torch.isnan(one.view(dt)[nan]).all()),
             "nan_words": int(nan.sum())}
        row[tag] = r
        require(all(v for k, v in r.items() if k != "nan_words"),
                f"the packed {tag} conversions differ from the one-cell ones: {r}")
    emit(row)
    return row


def cell_twin(kern, call):
    """A pair-layout ``call`` laid out in the one-cell layout of the same
    program (``codegen.kernel_shape``), under a library name of its own."""
    from repro_torch.kernels import codegen, stencil

    old = stencil.StencilCall(call.ir, kern.label, kern.bc, codegen.kernel_shape(call.program),
                              dtype=call.dtype)
    old.lib_name += "_cells"
    return old


def launch_at(torch, call, ins, sc, xc=None):
    """``(outs, reds)`` of one launch of ``call`` on ``ins`` with chunks of
    ``xc`` planes (None: its own launch's), not counted in the launches."""
    from repro_torch.kernels import stencil

    dev = next(iter(ins.values())).device
    c, outs, parts, args = call.prepare(ins, sc, spec_sm(torch), xc)
    with torch.cuda.device(dev):
        c._library().launch(*args, stencil.stream_of(dev))
    return call.finish(outs, parts)


def seeded(torch, fields):
    """``fields`` with NaN, inf and -inf at a few cells of each."""
    out = {}
    for n, t in fields.items():
        t = t.clone()
        flat = t.view(-1)
        for j, val in enumerate((float("nan"), float("inf"), float("-inf"))):
            flat[(flat.numel() // 7) * (j + 1) + j] = val
        out[n] = t
    return out


def bits(torch, t):
    """A tensor's bit patterns (2- or 4-byte elements)."""
    return t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


def beside_cells_bits(torch, k, call, f, sc) -> dict:
    """The pair layout and its one-cell layout launched with the same chunks
    on ``f``: outputs and reductions bit for bit, NaN payloads included."""
    old = cell_twin(k, call)
    xc = call.derive(spec_sm(torch)).xc
    (go, gr), (wo, wr) = launch_at(torch, call, f, sc, xc), launch_at(torch, old, f, sc, xc)
    same_cells = call.shape.cells == old.shape.cells
    out = {"outputs": all(bool(torch.equal(bits(torch, go[o]), bits(torch, wo[o])))
                          for o in k.outputs),
           "reductions": {n: bool(torch.equal(bits(torch, gr[n].float()),
                                              bits(torch, wr[n].float())))
                          for n in (gr or {}) if same_cells or k.reductions[n].combine == "max"}}
    out["bitwise"] = out["outputs"] and all(out["reductions"].values())
    return out


def check_pairs(torch, coupled_t, tag, gen) -> dict:
    """Each redesigned kernel at ``tag``: at an odd contiguous extent and on
    fields at an odd offset (views) the one-cell layout, bitwise to the
    torch backend; on fields seeded with NaN, +-inf, at the small and the
    full shape, the pair layout bitwise to its one-cell layout (NaN bit
    patterns too) and to the torch backend (NaN where it has NaN). Returns
    the largest error of each against the torch backend."""
    errs = {}
    for name in PAIR_VARIANTS:
        v = coupled_t[name]
        k, p, sc, solver = v["kernel"], v["plain"], v["scalars"], v["solver"]
        odd = COUPLED_ODD[solver]
        errs[name] = check_coupled(torch, f"{name}:{tag}@odd", v, odd, gen)
        base = COUPLED_SMALL[solver]
        f = coupled_fields(torch, v, base, gen)
        views = {}
        for n, t in f.items():
            views[n] = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(
                t.shape)
            views[n].copy_(t)
        got, want = split_result(k, k(**views, **sc)), split_result(p, p(**f, **sc))
        row = {"phase": "check_pairs", "variant": f"{name}:{tag}",
               "odd_extent": {"shape": list(odd), "layout": k.launch_info[odd]["layout"]},
               "odd_offset": {"shape": list(base), "layout": k.launch_info[base]["layout"],
                              "max_abs_diff": hold_to(torch, k, *got, *want,
                                                      f"{name}:{tag} on views at an odd offset")}}
        require("/v" not in row["odd_extent"]["layout"] + row["odd_offset"]["layout"],
                f"{name}:{tag}: an odd extent or offset took the pair layout: {row}")
        for b in (base, COUPLED_FULL[solver]):
            f = seeded(torch, coupled_fields(torch, v, b, gen))
            call = k.compiled(**f, **sc)
            require(call.shape.vec > 1, f"{name}:{tag} at {b}: not the pair layout")
            cmp = beside_cells_bits(torch, k, call, f, sc)
            got, want = split_result(k, k(**f, **sc)), split_result(p, p(**f, **sc))
            nan_same = all(same(torch, got[0][o], want[0][o]) for o in k.outputs)
            row[f"seeded_{'x'.join(map(str, b))}"] = {
                "layout": k.launch_info[tuple(b)]["layout"], "vs_cells": cmp,
                "vs_torch_backend": nan_same, "nonfinite": nonfinite(torch, got[0])}
            require(cmp["bitwise"] and nan_same,
                    f"{name}:{tag} at {b} with NaN and inf: {row}")
            del f, got, want
        emit(row)
        torch.cuda.empty_cache()
    return errs


def beside_cells(torch, k, f, sc, ptx) -> dict:
    """A pair-layout kernel ``k`` and its one-cell layout on the fields
    ``f``: bitwise to each other with the same chunks, then each launched as
    it launches, timed in turns (pairs, cells, cells, pairs; CUDA-event
    medians of 20), each the mean of its two."""
    from repro_torch.core import teff
    from repro_torch.kernels import build, codegen

    call = k.compiled(**f, **sc)
    old = cell_twin(k, call)
    cmp = beside_cells_bits(torch, k, call, f, sc)
    require(cmp["bitwise"], f"{call.label}: the pair layout differs from its one-cell layout")
    ms = {"pairs": [], "cells": []}
    for which in ("pairs", "cells", "cells", "pairs"):
        c = call if which == "pairs" else old
        ms[which].append(teff.measure(lambda: c.run(f, sc), iters=20, warmup=3).median_s * 1e3)
    return {"layout": codegen.layout_name(call.shape), "ms_in_turns": sum(ms["pairs"]) / 2,
            "cell_layout": codegen.layout_name(old.shape), "cell_ms": sum(ms["cells"]) / 2,
            "cell_ptxas": ptx.get(str(build.library_path(old.lib_name, old.source))),
            "vs_cells": cmp}


# ---- march_axis streaming and the finite/nan_count reductions ------------------
# Small shapes hold every marched variant at extents that no tile or chunk
# divides and that fill each variant's plane queue along every axis.
MARCH_SMALL = {"fig1": (33, 20, 130), "porosity": (33, 40), "gp": (21, 19, 130),
               "staggered": (33, 40)}
MARCH_FULL = {"fig1": (512, 512, 512), "porosity": (8192, 8192), "gp": (512, 512, 512)}
MARCH_FALLBACK = (3, 20, 130)     # FIG1 marched along an axis of 3 planes: a queue of 4
MARCH_COUPLED = ("porosity_fused[none]", "porosity_fused[neumann0]", "porosity_fused[dirichlet]",
                 "porosity_fused[periodic]", "porosity_fused[neumann0]+err", "gp_fused[none]",
                 "gp_fused[neumann0]", "gp_fused[dirichlet]", "gp_fused[periodic]",
                 "gp_fused[none]+mass", "gp_step_re", "gp_step_im")
MARCH_STAGGERED = ("porosity_fluxes", "porosity_update[neumann0]")
MARCH_KS = {"stencil": (2, 3), "staggered": (2,),
            **{n: (2,) for n in ("porosity_fused[none]", "porosity_fused[neumann0]",
                                 "porosity_fused[dirichlet]", "porosity_fused[neumann0]+err",
                                 "gp_fused[none]", "gp_fused[neumann0]", "gp_fused[dirichlet]",
                                 "gp_fused[none]+mass")}}
MARCH_MIXED = ("stencil", "porosity_fused[neumann0]", "gp_fused[none]")
# the variants driven on the main path at full size, and their k
MARCH_MAIN = {"stencil": (2, 3), "porosity_fused[neumann0]": (2,), "gp_fused[none]": (2,)}
MARCH_MAIN_STEPS = {"porosity": 20, "gp": 10}
HEALTH_AT = {"nan": ((5, 5, 5), (10, 3, 100)), "inf": ((20, 10, 7),), "-inf": ((1, 1, 1),),
             "overflow": ((7, 7, 7),)}


def make_health(ps):
    """The serving layer's health guard on a plain update: T2 = 2 T inside,
    ``finite`` and ``nan_count`` of the output and ``nan_count`` of the
    input."""
    from repro_torch.core import fd3d

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                 reductions={"bad": "finite(T2)", "nbad": "nan_count(T2)", "nin": "nan_count(T)"})
    def health(T2, T):
        return {"T2": fd3d.inn(T) * 2.0}

    return health


def march_variants(torch, step, step_plain, generic_pair, coupled, ksteps) -> dict:
    """The variants held marched: every generated variant the checks above
    hold (FIG1's step bare, with ``err`` and with the four classic
    reductions, the generic two-output kernel, the coupled kernels of
    ``MARCH_COUPLED``, the staggered rotation), and the main path's guarded
    check (``err`` and the health guard). Each beside its torch twin."""
    from repro_torch.examples import quickstart

    guard = {"err": "max_abs_diff(T2, T)", **quickstart.GUARD}
    fig1 = ksteps["stencil"]
    v = {"stencil": fig1}
    for name, reds in (("stencil+err", ERR), ("stencil+guard", guard), ("stencil+4red", ALL_REDS)):
        v[name] = dict(fig1, kernel=step.with_reductions(reds),
                       plain=step_plain.with_reductions(reds))
    v["generic"] = {"solver": "fig1", "kernel": generic_pair[0], "plain": generic_pair[1],
                    "shapes": lambda b: {n: b for n in ("A2", "B2", "A", "B")},
                    "scalars": dict(c=0.3, h=0.7)}
    v.update({n: ksteps[n] if n in ksteps else coupled[n] for n in MARCH_COUPLED})
    v["staggered"] = ksteps["staggered"]
    return v


def march_axes(v, base) -> list:
    """The axes along which no field of the variant is staggered."""
    shapes = v["shapes"](base).values()
    return [a for a in range(len(base)) if all(s[a] == base[a] for s in shapes)]


def march_fields(torch, v, base, gen):
    f = k_fields(torch, v, base, gen) if v["kernel"].rotations \
        else coupled_fields(torch, v, base, gen)
    return f


def check_march(torch, name, v, base, gen, ks=()) -> dict:
    """The variant marched along each axis it can march: one launch bitwise
    to the torch backend (the all-parallel twin: marching changes the
    launch, not the values), its ``launch_info`` naming the axis, and each
    ``run_steps(k)`` one launch bitwise to k marched single-step launches.
    Returns the largest error per axis and k."""
    from repro_torch.kernels import stencil

    kern, plain, sc = v["kernel"], v["plain"], v["scalars"]
    f = march_fields(torch, v, base, gen)
    want, want_reds = split_result(plain, plain(**f, **sc))
    rows, errs = {}, {}
    for a in march_axes(v, base):
        km = kern.marched(a)
        got, reds = split_result(km, km(**f, **sc))
        info = dict(km.launch_info[tuple(base)])
        errs[(a, 1)] = hold_to(torch, km, got, reds, want, want_reds,
                               f"{name} marched along {a} at {base}")
        require(info["march_axis"] == a and not info["march_fallback"],
                f"{name} marched along {a} at {base} launched {info}")
        row = {"max_abs_err": errs[(a, 1)], "nonfinite": nonfinite(torch, got),
               **{x: info[x] for x in ("grid", "xc", "queue_planes", "layout")}}
        for k in ks:
            w, w_reds = rotate_run(km, f, sc, 1, k)
            w = {o: w[t] for o, t in km.rotations.items()}
            label = launch_label(km, k)
            before = stencil.launches[label]
            g, g_reds = split_result(km, km.run_steps(k, **f, **sc))
            require(stencil.launches[label] == before + 1,
                    f"{name}@m{a}: run_steps({k}) made {stencil.launches[label] - before} "
                    f"launches of {label}")
            errs[(a, k)] = row[f"k{k}_max_abs_err"] = hold_to(
                torch, km, g, g_reds, w, w_reds,
                f"{name}@m{a}: run_steps({k}) against {k} marched launches at {base}")
        rows[a] = row
    emit({"phase": "check_march", "variant": name, "shape": list(base),
          "dtype": str(kern.ps.dtype), "axes": rows})
    return errs


def check_march_refusals(torch, coupled, step, step_plain, gen) -> None:
    """A field staggered along the march axis raises (porosity's flux-split
    kernels stagger both axes); a march extent shorter than the queue
    launches the all-parallel kernel and says so, bitwise all the same."""
    for name in MARCH_STAGGERED:
        v = coupled[name]
        f = coupled_fields(torch, v, MARCH_SMALL["porosity"], gen)
        for a in (0, 1):
            try:
                v["kernel"].marched(a)(**f, **v["scalars"])
            except ValueError as e:
                require("staggered" in str(e), f"{name}@m{a}: {e}")
            else:
                raise SmokeFailure(f"{name} marched along staggered axis {a} did not raise")
    f = {n: torch.rand(MARCH_FALLBACK, generator=gen, device=gen.device)
         for n in ("T2", "T", "Ci")}
    sc = dict(lam=1.0, dt=1e-4, _dx=2.0, _dy=19.0, _dz=129.0)
    km = step.marched(0)
    got = km(**f, **sc)
    info = km.launch_info[MARCH_FALLBACK]
    emit({"phase": "check_march", "variant": "stencil", "shape": list(MARCH_FALLBACK),
          "fallback": info, "staggered_refused": list(MARCH_STAGGERED)})
    require(info["march_fallback"] and info["march_axis"] is None,
            f"a march of 3 planes did not fall back: {info}")
    require(same(torch, got, step_plain(**f, **sc)), "the fallback launch differs")


def check_finite(torch, dtype, gen) -> dict:
    """``finite`` and ``nan_count`` against the torch backend at ``dtype``:
    NaN, inf and -inf at known cells of T, a random 1% of NaN, and 40000 at
    one cell, which 2 T carries past f16's range on store (inf there, so it
    counts at f16 only); all-parallel and marched, one step and k = 2.
    Counts must be exact and equal; the fold never NaN."""
    from repro_torch.core import init_parallel_stencil

    kern = make_health(init_parallel_stencil(dtype=dtype))
    plain = make_health(init_parallel_stencil(backend="torch", device="cuda", dtype=dtype))
    base = MARCH_SMALL["fig1"]
    T = torch.rand(base, generator=gen, device=gen.device)
    T[torch.rand(base, generator=gen, device=gen.device) < 0.01] = float("nan")
    for what, cells in HEALTH_AT.items():
        for c in cells:
            T[c] = {"nan": float("nan"), "inf": float("inf"), "-inf": -float("inf"),
                    "overflow": 40000.0}[what]
    f = {"T2": T.to(dtype), "T": T.to(dtype)}
    rows, errs = {}, {}
    for march, k in ((None, 1), (None, 2), (0, 2), (2, 1)):
        km = kern.marched(march)
        got, reds = split_result(km, km.run_steps(k, **f))
        want, want_reds = split_result(plain, plain.run_steps(k, **f))
        errs[(march, k)] = hold_to(torch, km, got, reds, want, want_reds,
                                   f"health march {march}, k = {k}, {dtype}")
        counts = {n: float(r) for n, r in reds.items()}
        require(counts == {n: float(r) for n, r in want_reds.items()}
                and all(math.isfinite(c) for c in counts.values()),
                f"health march {march}, k = {k}, {dtype}: {counts} against {want_reds}")
        # nin counts the last sweep's input: the given T after one step
        require((k > 1 or counts["nin"] == float((~torch.isfinite(f["T"])).sum()))
                and counts["nbad"] == float((~torch.isfinite(want["T2"])).sum()),
                f"health march {march}, k = {k}, {dtype}: counts are not the cells' own")
        rows[f"m{march}/k{k}"] = {"counts": counts, "nonfinite_T2": nonfinite(torch, got)}
    overflow = bool(torch.isinf(plain(**f)[0][HEALTH_AT["overflow"][0]]))
    require(overflow == (dtype == torch.float16), f"2 x 40000 stored as {dtype}: inf is {overflow}")
    emit({"phase": "check_finite", "dtype": str(dtype), "shape": list(base),
          "cells": {k: [list(c) for c in v] for k, v in HEALTH_AT.items()},
          "f16_overflow_on_store": overflow, "runs": rows})
    return errs


def march_state(torch, solver):
    """A solver's own state at full size and its scalars (FIG1's
    ``initial_state``, ``porosity_waves.init_state``,
    ``gross_pitaevskii.init_state``), outputs as copies of their targets."""
    from repro_torch.configs import FIG1
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw, quickstart

    if solver == "fig1":
        _, f, sc = quickstart.initial_state(FIG1, "cuda")
        return f, sc
    if solver == "porosity":
        cfg = pw.PorosityConfig(n=MARCH_FULL["porosity"][0], device="cuda")
        grid, phi, Pe = pw.init_state(cfg)
        return dict(phi2=phi.clone(), Pe2=Pe.clone(), phi=phi, Pe=Pe), \
            {"dtau": pw.timestep(cfg, grid)}
    cfg = gp.GPConfig(n=MARCH_FULL["gp"][0], device="cuda")
    grid, re, im, V = gp.init_state(cfg)
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
    return dict(re2=re.clone(), im2=im.clone(), re=re, im=im, V=V), \
        dict(g=cfg.g, dt=gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])


def march_main_path(torch, spec, variants) -> dict:
    """The main path marched. FIG1 512^3 through ``quickstart.run`` (100
    steps of ``step.marched(a)``, the hand kernel's 100 steps, then
    ``solve_until`` with ``check_every = 10`` and the health guard folded
    beside the error) for the all-parallel layout and each axis; every
    marched run must equal the all-parallel one bitwise, iterations and
    error included, and launch only its own marched kernels. Each solve is
    timed again by host clock from the same state: ms per step, T_eff over
    the copy bandwidth. Then FIG1's ``run_steps(k)`` and porosity's and
    GP's fused kernels (their twins' ``make_step`` kernels) marched along
    each axis on the solvers' own states: a few single steps and 12 steps
    as ``run_steps(k)``, bitwise to the all-parallel kernel's steps. The
    launch counts are set to 0 just before each run and read just after."""
    from repro_torch.configs import FIG1
    from repro_torch.core import iterate, teff
    from repro_torch.examples import quickstart
    from repro_torch.kernels import stencil

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches, fig1 = {}, {}
    a_eff = teff.a_eff(math.prod(FIG1.shape), 2, 1, 4)
    base = None
    for a in (None, 0, 1, 2):
        tag = "" if a is None else f"@m{a}"
        stencil.launches.clear()
        r, wall = timed(lambda: quickstart.run(FIG1, device="cuda", tol=1e-7, max_iters=1000,
                                               check_every=10, march_axis=a, guard=True))
        counts = dict(stencil.launches)
        checked = r.step.with_reductions({"err": "max_abs_diff(T2, T)", **quickstart.GUARD})
        want = {f"step{tag}", f"{checked.label}{tag}"}
        require(set(counts) == want and all(counts.values()),
                f"FIG1 marched along {a} launched {counts}, not {sorted(want)}")
        launches[f"stencil{tag}"] = counts[f"step{tag}"]
        launches[f"stencil+guard{tag}"] = counts[f"{checked.label}{tag}"]
        _, f, sc = quickstart.initial_state(FIG1, "cuda")
        again, solve_wall = timed(lambda: iterate.solve_until(
            checked, f, sc, tol=1e-7, max_iters=1000, check_every=10, error="err"))
        ms = solve_wall / again.iters * 1e3
        out = {"T": r.T, "solve": r.solve.output(checked)}
        row = {"phase": "main_path_march", "config": "FIG1", "march_axis": a,
               "shape": list(FIG1.shape), "wall_s": wall, "launches": counts,
               "solve": {"iters": r.solve.iters, "host_syncs": r.solve.host_syncs,
                         "err": r.solve.err, "finite": float(r.solve.reds["bad"]),
                         "nan_count": float(r.solve.reds["nbad"]), "check_every": 10},
               "solve_ms_per_step": ms, "t_eff_GBps": a_eff / (ms / 1e3) / 1e9,
               "t_eff_over_copy": a_eff / (ms / 1e3) / spec.peak_bw,
               "copy_bandwidth_GBps": spec.peak_bw / 1e9,
               "launch_info": {str(s): i for s, i in r.step.launch_info.items()}}
        require(r.solve.host_syncs == r.solve.iters // 10, "host_syncs != iters // check_every")
        require(float(r.solve.reds["bad"]) == 0.0 and float(r.solve.reds["nbad"]) == 0.0,
                f"FIG1 marched along {a}: the health guard fired")
        if base is None:
            base = (out, r.solve.iters, r.solve.err)
        else:
            row["bitwise_to_all_parallel"] = all(bool(torch.equal(out[n], base[0][n]))
                                                 for n in out)
            require(row["bitwise_to_all_parallel"] and r.solve.iters == base[1]
                    and r.solve.err == base[2],
                    f"FIG1 marched along {a} differs from the all-parallel run")
        emit(row)
        fig1[str(a)] = row
        del r, out, again, f
    del base
    torch.cuda.empty_cache()
    for name, ks in MARCH_MAIN.items():
        v = variants[name]
        kern = v["kernel"]
        solver = v["solver"]
        f, sc = march_state(torch, solver)
        steps = MARCH_MAIN_STEPS.get(solver, 12)
        rotate_run(kern, f, sc, 1, 1)
        (want, _), wall = timed(lambda: rotate_run(kern, f, sc, 1, steps))
        row = {"phase": "main_path_march", "variant": name, "shape": list(MARCH_FULL[solver]),
               "steps": steps, "ms_per_step": {"all_parallel": wall / steps * 1e3}}
        for a in range(len(MARCH_FULL[solver])):
            km = kern.marched(a)
            runs = [(1, steps)] + [(k, 12) for k in ks] if solver != "fig1" else \
                [(k, 12) for k in ks]
            for k, n in runs:
                label = launch_label(km, k)
                rotate_run(km, f, sc, k, k)       # the library loaded
                stencil.launches.clear()
                (got, _), wall = timed(lambda: rotate_run(km, f, sc, k, n))
                counts = dict(stencil.launches)
                require(counts == {label: n // k}, f"{name}@m{a}: {n} steps as run_steps({k}) "
                        f"launched {counts}")
                ref, _ = rotate_run(kern, f, sc, 1, n) if n != steps else (want, None)
                require(all(bool(torch.equal(got[t], ref[t])) for t in kern.rotations.values()),
                        f"{name}@m{a}: {n} steps as run_steps({k}) differ from all-parallel steps")
                key = f"{name}@m{a}" + (f"/k{k}" if k > 1 else "")
                launches[key] = counts[label]
                row["ms_per_step"][key] = wall / n * 1e3
        emit(row)
        del f, want
        torch.cuda.empty_cache()
    return {"launches": launches, "fig1": fig1}


def time_march(torch, name, v, base, gen, spec, ks, ptx) -> dict:
    """Each marched variant at full size beside its all-parallel twin in the
    same run (CUDA-event medians of 20): its ms, the twin's, the bound
    (the twin's: marching moves no byte the bound counts), its plain
    version's ms (the torch backend), its difference from it, registers and
    spills, its launch and plane queue, and the cost model's bytes per step
    at the port's own launch tiles: streamed (``a_eff_streamed`` along the
    march axis) against the twin's refetched (``fetched_bytes_per_step``).
    The k-step rows as ``time_k_steps`` gives them, beside the all-parallel
    k-step twin."""
    from repro_torch.core import teff
    from repro_torch.kernels import codegen

    kern, plain, sc = v["kernel"], v["plain"], v["scalars"]
    f = march_fields(torch, v, base, gen)
    twin = kern.compiled(**f, **sc)
    a_eff, ops = tap_cost(twin)
    bound_ms, bound_by = bound_of(a_eff, ops)
    twin_ms = teff.measure(lambda: kern(**f, **sc), iters=20, warmup=3).median_s * 1e3
    plain_ms = teff.measure(lambda: plain(**f, **sc), iters=10, warmup=2).median_s * 1e3
    want, want_reds = split_result(plain, plain(**f, **sc))
    twin_err = hold_to(torch, kern, *split_result(kern, kern(**f, **sc)), want, want_reds,
                       f"{name} against its plain version at {base}")
    cost = kern.cost_model(**f, **sc)
    twin_tile = twin.cost_tile()
    out = {name: {"ms": twin_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "share_of_bound": bound_ms / twin_ms, "max_abs_err": twin_err,
                  "ptxas": ptx.get(twin.lib_name)}}
    for a in march_axes(v, base):
        km = kern.marched(a)
        call = km.compiled(**f, **sc)
        err = hold_to(torch, km, *split_result(km, km(**f, **sc)), want, want_reds,
                      f"{name}@m{a} against its plain version at {base}")
        ms = teff.measure(lambda: km(**f, **sc), iters=20, warmup=3).median_s * 1e3
        tile = call.cost_tile()
        launch = call.derive(spec_sm(torch))
        out[f"{name}@m{a}"] = {
            "ms": ms, "twin_ms": twin_ms, "over_twin": ms / twin_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms, "plain_ms": plain_ms,
            "max_abs_err": err, "queue_planes": call.queue_planes, "xc": launch.xc,
            "grid": list(launch.grid), "tile": list(call.shape.tile), "planes": call.shape.planes,
            "z_strided": call.program.z_strided, "ptxas": ptx.get(call.lib_name),
            "layout": codegen.layout_name(call.shape),
            "cost_tile": list(tile), "streamed_bytes": cost.a_eff_streamed(tile, 1, a),
            "refetched_bytes": cost.fetched_bytes_per_step(twin_tile, 1),
            "a_eff_bytes": cost.a_eff_bytes(1),
            "t_eff_over_copy": a_eff / (ms / 1e3) / spec.peak_bw}
        if call.program.z_strided:
            out[f"{name}@m{a}"].update(beside_sync(torch, km, call, f, sc, ptx))
        for k in ks:
            twin_k = teff.measure(lambda: kern.run_steps(k, **f, **sc), iters=20,
                                  warmup=3).median_s * 1e3
            t = time_k_steps(torch, f"{name}@m{a}", dict(v, kernel=km), k, base, gen, spec)
            kc = km.compiled(nsteps=k, **f, **sc)
            t.update({"twin_ms": twin_k, "over_twin": t["ms"] / twin_k,
                      "queue_planes": kc.queue_planes, "ptxas": ptx.get(kc.lib_name),
                      "streamed_bytes": cost.a_eff_streamed(kc.cost_tile(), k, a),
                      "refetched_bytes": cost.fetched_bytes_per_step(
                          kern.compiled(nsteps=k, **f, **sc).cost_tile(), k),
                      "layout": codegen.layout_name(kc.shape)})
            if kc.program.z_strided:
                t.update(beside_sync(torch, km, kc, f, sc, ptx))
            out[f"{name}@m{a}/k{k}"] = t
        torch.cuda.empty_cache()
    return out


def sync_call(km, call):
    """``call`` (a march along the contiguous axis) in its synchronous
    layout, for timing beside it: the slab staged through registers (one
    step) or strided loads and stores (k steps), under a library name of
    its own."""
    from repro_torch.kernels import codegen, codegen_steps, stencil

    p = call.program
    shape = codegen.slab_layout(p, False) if call.rotations is None else \
        codegen_steps.steps_shape(p, call.rotations, call.nsteps, False)
    old = stencil.StencilCall(call.ir, km.label, km.bc, shape, call.nsteps, call.rotations,
                              call.dtype, march_axis=call.march_axis)
    old.lib_name += "_sync"
    return old


def beside_sync(torch, km, call, f, sc, ptx) -> dict:
    """The async slab and its synchronous layout on the same fields:
    bitwise to each other, then timed in turns (async, sync, sync, async;
    CUDA-event medians of 20), each the mean of its two."""
    from repro_torch.core import teff
    from repro_torch.kernels import codegen

    old = sync_call(km, call)
    got, want = call.run(f, sc)[0], old.run(f, sc)[0]
    require(all(same(torch, got[o], want[o]) for o in got),
            f"{call.label}: the async slab differs from its synchronous layout")
    ms = {"new": [], "sync": []}
    for which in ("new", "sync", "sync", "new"):
        c = call if which == "new" else old
        ms[which].append(teff.measure(lambda: c.run(f, sc), iters=20, warmup=3).median_s * 1e3)
    return {"layout": codegen.layout_name(call.shape), "ms_in_turns": sum(ms["new"]) / 2,
            "sync_layout": codegen.layout_name(old.shape), "sync_ms": sum(ms["sync"]) / 2,
            "sync_ptxas": ptx.get(old.lib_name)}


def spec_sm(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def march_calls(torch, march_v) -> list:
    """The calls of every marched variant (f32 at each axis and its k, bf16
    and f16 for ``MARCH_MIXED`` at the first k), the main path's guarded
    all-parallel check, and the health kernels at each dtype; built with
    the rest of the sources."""
    from repro_torch.core import init_parallel_stencil

    calls = []
    for name, v in march_v.items():
        base = MARCH_SMALL[v["solver"]]
        for dt in [None] + ([getattr(torch, n) for n in MIXED_TAGS.values()]
                            if name in MARCH_MIXED else []):
            kern = v["kernel"] if dt is None else v["kernel"].with_dtype(dt)
            ks = MARCH_KS.get(name, ()) if dt is None else MARCH_KS.get(name, ())[:1]
            for a in march_axes(v, base):
                calls += [kern.marched(a).compiled(nsteps=k, **v["shapes"](base), **v["scalars"])
                          for k in (1, *ks)]
    g = march_v["stencil+guard"]
    calls.append(g["kernel"].compiled(**g["shapes"](MARCH_SMALL["fig1"]), **g["scalars"]))
    # the synchronous layouts of the timed kernels along the contiguous axis
    for name in (*MARCH_MAIN, "stencil+guard"):
        v = march_v[name]
        base = MARCH_SMALL[v["solver"]]
        km = v["kernel"].marched(len(base) - 1)
        for k in (1, *MARCH_MAIN.get(name, ())):
            calls.append(sync_call(km, km.compiled(nsteps=k, **v["shapes"](base),
                                                   **v["scalars"])))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        h = make_health(init_parallel_stencil(dtype=dt))
        calls += [h.marched(a).compiled(nsteps=k, T2=MARCH_SMALL["fig1"], T=MARCH_SMALL["fig1"])
                  for a, k in ((None, 1), (None, 2), (0, 2), (2, 1))]
    return calls


def march_checks(torch, march_v, coupled, step, step_plain, gen) -> dict:
    """Every marched variant at the small shapes (bf16 and f16 for
    ``MARCH_MIXED``), the main path's variants at full size too; then the
    refusals and the fallback, and ``finite``/``nan_count`` at each dtype.
    Returns the largest error of each main-path variant, by kernels-line
    name."""
    err_at = {}
    for name, v in march_v.items():
        errs = check_march(torch, name, v, MARCH_SMALL[v["solver"]], gen, MARCH_KS.get(name, ()))
        if name in MARCH_MIXED:
            for tag, dt_name in MIXED_TAGS.items():
                dt = getattr(torch, dt_name)
                vt = dict(v, kernel=v["kernel"].with_dtype(dt), plain=v["plain"].with_dtype(dt))
                check_march(torch, f"{name}:{tag}", vt, MARCH_SMALL[v["solver"]], gen,
                            MARCH_KS.get(name, ())[:1])
        if name in MARCH_MAIN or name == "stencil+guard":
            full = check_march(torch, name, v, MARCH_FULL[v["solver"]], gen,
                               MARCH_MAIN.get(name, ()))
            for (a, k), e in full.items():
                err_at[f"{name}@m{a}" + (f"/k{k}" if k > 1 else "")] = max(e, errs.get((a, k), 0.0))
        torch.cuda.empty_cache()
    check_march_refusals(torch, coupled, step, step_plain, gen)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        check_finite(torch, dt, gen)
    return err_at


def march_timings(torch, march_v, gen, spec, ptx) -> dict:
    """``time_march`` of the main path's variants and the guarded check;
    prints the ``times_march`` line."""
    from repro_torch.kernels import stencil

    times = {}
    for name, ks in (*MARCH_MAIN.items(), ("stencil+guard", ())):
        v = march_v[name]
        times.update(time_march(torch, name, v, MARCH_FULL[v["solver"]], gen, spec, ks, ptx))
    emit({"phase": "times_march", "card": spec.name, "power_limit": spec.power_limit,
          "copy_bandwidth_GBps": spec.peak_bw / 1e9, "shapes": MARCH_FULL,
          "waves": stencil.WAVES, "steps_waves": stencil.STEPS_WAVES, "kernels": times})
    return times


def march_rows(march_runs, march_times, err_at) -> list:
    """The kernels-line rows of the marched main path's kernels (the
    all-parallel step has its own row)."""
    return [{"name": k, "route": "cuda",
             "source": ("src/repro_torch/kernels/codegen_steps.py" if "/k" in k
                        else "src/repro_torch/kernels/codegen.py"),
             "replaces": "src/repro/kernels/stencil.py:1052",
             "launches": n, "max_abs_err": max(err_at.get(k, 0.0), march_times[k]["max_abs_err"]),
             **{x: march_times[k][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
             "library_ms": None}
            for k, n in march_runs["launches"].items() if k != "stencil"]


# Checkpoints, fault injection and telemetry. Porosity's --tol run (PW_TOL,
# which never converges at 8192^2) with its cap raised to CKPT_CAP so that a
# planned kill at CKPT_KILL lands mid-run, a check every 10 steps and a save
# every 10 checks (100 steps, 1.07 GB of f32 carry a save); the same at bf16
# through solve_until to its cap (until="above", tol=inf: a 2-byte --tol run
# may stop at its first check, below one storage ulp); GP's drift-guarded
# run at 512^3 with one save of its 2.68 GB carry; FIG1's solve_until at
# 512^3 into a telemetry log. The files go to a temporary directory that is
# removed afterwards.
CKPT_CAP, CKPT_KILL, CKPT_CHECK, CKPT_KEEP = 400, 200, 10, 2
CKPT_SAVE_EVERY = {"porosity": 10, "gp": 5}
KILL_EXIT_CODE = 113      # repro_torch.distributed.fault.KILL_EXIT_CODE


def sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def timed(torch, device, fn):
    """``fn()`` and its wall seconds, the device drained at both ends."""
    sync(torch, device)
    t0 = time.perf_counter()
    r = fn()
    sync(torch, device)
    return r, time.perf_counter() - t0


def child(args, plan: dict | None = None) -> subprocess.CompletedProcess:
    """Run ``python args`` from the repository root with the port
    importable, under the fault plan ``plan``; waits for it (it is killed
    at the time limit)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    for k in ("REPRO_FAULT_PLAN", "REPRO_TELEMETRY"):
        env.pop(k, None)
    if plan is not None:
        env["REPRO_FAULT_PLAN"] = json.dumps(plan)
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def porosity_solve(ck_dir, dtype="float32", n=COUPLED_FULL["porosity"][0], device="cuda",
                   blocking=False):
    """Porosity's fused kernel with its residual epilogue through
    ``iterate.solve_until`` to ``CKPT_CAP`` steps, checkpointed under
    ``ck_dir`` unless it is None: at f32 the twin's --tol solve (PW_TOL),
    at bf16 ``until="above"`` with tol=inf. The parent and the killed
    bf16 child both run this."""
    from repro_torch.core import iterate
    from repro_torch.examples import porosity_waves as pw

    cfg = pw.PorosityConfig(n=n, dtype=dtype, device=device)
    grid, phi, Pe = pw.init_state(cfg)
    kern = pw.make_step(grid, cfg).kernels[0].with_reductions({"err": "max_abs_diff(Pe2, Pe)"})
    ck = None if ck_dir is None else iterate.Checkpointing(
        ck_dir, save_every=CKPT_SAVE_EVERY["porosity"], keep=CKPT_KEEP, blocking=blocking)
    stop = dict(tol=PW_TOL) if dtype == "float32" else dict(tol=float("inf"), until="above")
    return iterate.solve_until(kern, dict(phi2=phi, Pe2=Pe, phi=phi, Pe=Pe),
                               dict(dtau=pw.timestep(cfg, grid)), max_iters=CKPT_CAP,
                               check_every=CKPT_CHECK, checkpoint=ck, **stop)


def save_stats(records) -> dict:
    """What the in-memory telemetry of a checkpointed solve says about its
    saves: bytes, the device-to-host snapshot, the write on the writer
    thread, and the loop's stall per save (the gap between one chunk's end
    and the next one's start: waiting for the previous write, the snapshot,
    the records)."""
    def spans(name):
        return [r for r in records if r["kind"] == "span" and r["name"] == name]

    chunks = spans("solve.chunk")
    stall_ms = [(b["ts"] - a["ts"] - a["dur_s"]) * 1e3 for a, b in zip(chunks, chunks[1:])]
    snap_ms = [r["dur_s"] * 1e3 for r in spans("checkpoint.snapshot")]
    warm = chunks[1:] or chunks
    return {"saves": len(spans("checkpoint.write")),
            "bytes_per_save": sorted({r["value"] for r in records if r["kind"] == "counter"
                                      and r["name"] == "checkpoint.bytes_written"}),
            "snapshot_ms": snap_ms, "median_snapshot_ms": float(sorted(snap_ms)[len(snap_ms) // 2]),
            "stall_ms": stall_ms,
            "median_stall_ms": (float(sorted(stall_ms)[len(stall_ms) // 2]) if stall_ms
                                else None),
            "write_s": [r["dur_s"] for r in spans("checkpoint.write")],
            "chunk_ms_per_step": (sum(c["dur_s"] for c in warm)
                                  / sum(c["attrs"]["steps"] for c in warm) * 1e3)}


def checkpoint_main_path(torch, n_pw=COUPLED_FULL["porosity"][0], n_gp=COUPLED_FULL["gp"][0],
                         device="cuda") -> dict:
    """The checkpointed main path (``main_path_checkpoint`` lines):
    porosity's --tol run (a) uninterrupted without checkpoints, (d) the
    same with them (in-memory telemetry for the save figures), (e) the
    same with blocking saves (chunks beside no write), (b) in a
    child process under ``REPRO_FAULT_PLAN={"kill_at_step": 200}``, which
    must exit 113 with LATEST at 200, and (c) resumed here: (a), (c), (d)
    and (e) bitwise equal. Then the same kill and resume at bf16, and GP's
    guarded run checkpointed against its plain run. The launch counts are
    set to 0 just before (a) and (d) and read just after."""
    from repro_torch import telemetry
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw
    from repro_torch.kernels import stencil

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        # ---- porosity f32 through the twin ---------------------------------
        kw = dict(n=n_pw, nt=CKPT_CAP, tol=PW_TOL, check_every=CKPT_CHECK, device=device)
        ck_kw = dict(save_every=CKPT_SAVE_EVERY["porosity"])
        stencil.launches.clear()
        plain, wall_plain = timed(torch, device, lambda: pw.solve(pw.PorosityConfig(**kw)))
        launches_plain = dict(stencil.launches)
        require(plain["iters"] > CKPT_KILL,
                f"porosity --tol stopped at {plain['iters']}, before the kill at {CKPT_KILL}")
        col = telemetry.configure(None)
        try:
            stencil.launches.clear()
            full, wall_ck = timed(torch, device, lambda: pw.solve(pw.PorosityConfig(
                **kw, checkpoint_dir=os.path.join(root, "pw_full"), **ck_kw)))
            launches_ck = dict(stencil.launches)
        finally:
            telemetry.reset()
        stats = save_stats(col.records)
        shutil.rmtree(os.path.join(root, "pw_full"))
        # (e) the same with blocking saves: no chunk runs beside a write
        col = telemetry.configure(None)
        try:
            blocking = porosity_solve(os.path.join(root, "pw_blocking"), n=n_pw, device=device,
                                      blocking=True)
        finally:
            telemetry.reset()
        shutil.rmtree(os.path.join(root, "pw_blocking"))
        blocking_stats = {k: v for k, v in save_stats(col.records).items()
                          if k in ("stall_ms", "write_s", "chunk_ms_per_step")}
        ck = os.path.join(root, "pw_kill")
        p, child_s = timed(torch, device, lambda: child(
            ["-m", "repro_torch.examples.porosity_waves", "--device", device, "--n", str(n_pw),
             "--nt", str(CKPT_CAP), "--tol", repr(PW_TOL), "--check-every", str(CKPT_CHECK),
             "--checkpoint-dir", ck, "--save-every", str(ck_kw["save_every"])],
            {"kill_at_step": CKPT_KILL}))
        latest = CheckpointManager(ck).latest_step()
        require(p.returncode == KILL_EXIT_CODE,
                f"porosity child exited {p.returncode}, not {KILL_EXIT_CODE}: {p.stderr[-3000:]}")
        require(latest == CKPT_KILL, f"LATEST is {latest} after the kill at {CKPT_KILL}")
        resumed, wall_resume = timed(torch, device, lambda: pw.solve(pw.PorosityConfig(
            **kw, checkpoint_dir=ck, **ck_kw)))
        shutil.rmtree(ck)
        same_full = {k: bool(torch.equal(plain[k], full[k]) and torch.equal(
            plain[k], blocking.fields[k])) for k in ("phi", "Pe")}
        same_resumed = {k: bool(torch.equal(plain[k], resumed[k])) for k in ("phi", "Pe")}
        out["porosity"] = row = {
            "phase": "main_path_checkpoint", "solver": "porosity", "dtype": "float32",
            "shape": [n_pw, n_pw], "config": dict(kw, **ck_kw), "kill_at_step": CKPT_KILL,
            "iters": {"plain": plain["iters"], "checkpointed": full["iters"],
                      "resumed": resumed["iters"]},
            "residual": {"plain": plain["residual"], "checkpointed": full["residual"],
                         "resumed": resumed["residual"]},
            "resumed_from": resumed["resumed_from"], "child": {"rc": p.returncode,
                                                               "latest": latest,
                                                               "wall_s": child_s},
            "bitwise": {"checkpointed": same_full, "resumed": same_resumed},
            "launches": {"plain": launches_plain, "checkpointed": launches_ck},
            "wall_s": {"plain": wall_plain, "checkpointed": wall_ck, "resume": wall_resume},
            "ms_per_step": {"plain": wall_plain / plain["iters"] * 1e3,
                            "checkpointed": wall_ck / full["iters"] * 1e3},
            **stats, "blocking_saves": blocking_stats}
        emit(row)
        require(all(same_full.values()) and all(same_resumed.values()),
                f"porosity: checkpointed or resumed fields differ from the plain run: {row['bitwise']}")
        require(plain["iters"] == full["iters"] == resumed["iters"]
                and plain["residual"] == full["residual"] == resumed["residual"],
                f"porosity: iters or residual differ: {row['iters']} {row['residual']}")
        require(resumed["resumed_from"] == CKPT_KILL, "porosity did not resume from the kill")
        require(launches_ck == launches_plain,
                f"porosity: checkpoints changed the launches: {launches_ck} vs {launches_plain}")
        require(stats["saves"] == plain["iters"] // (CKPT_CHECK * ck_kw["save_every"]),
                f"porosity: {stats['saves']} saves")
        require(not str(device).startswith("cuda")
                or set(launches_plain) == {"update", "update[err]"},
                f"porosity: launches {launches_plain}")
        del plain, full, resumed, blocking
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()

        # ---- porosity bf16: the same kill and resume -----------------------
        stencil.launches.clear()
        plain, wall_plain = timed(torch, device, lambda: porosity_solve(None, "bfloat16", n_pw,
                                                                        device))
        launches_plain = dict(stencil.launches)
        ck = os.path.join(root, "pw_bf16")
        p, child_s = timed(torch, device, lambda: child(
            ["-c", "import sys, chip_smoke; chip_smoke.porosity_solve("
                   "sys.argv[1], 'bfloat16', int(sys.argv[2]), sys.argv[3])", ck, str(n_pw),
             device],
            {"kill_at_step": CKPT_KILL}))
        latest = CheckpointManager(ck).latest_step()
        require(p.returncode == KILL_EXIT_CODE,
                f"bf16 child exited {p.returncode}, not {KILL_EXIT_CODE}: {p.stderr[-3000:]}")
        require(latest == CKPT_KILL, f"bf16: LATEST is {latest} after the kill at {CKPT_KILL}")
        with open(os.path.join(ck, f"step_{CKPT_KILL:09d}", "manifest.json")) as fh:
            dtypes = {t["path"]: t["dtype"] for t in json.load(fh)["tensors"]}
        col = telemetry.configure(None)
        try:
            resumed, wall_resume = timed(torch, device, lambda: porosity_solve(
                ck, "bfloat16", n_pw, device))
        finally:
            telemetry.reset()
        shutil.rmtree(ck)
        same = {k: bool(torch.equal(plain.fields[k], resumed.fields[k])) for k in plain.fields}
        out["porosity_bf16"] = row = {
            "phase": "main_path_checkpoint", "solver": "porosity", "dtype": "bfloat16",
            "shape": [n_pw, n_pw], "kill_at_step": CKPT_KILL, "until": "above", "tol": "inf",
            "iters": {"plain": plain.iters, "resumed": resumed.iters},
            "err": {"plain": plain.err, "resumed": resumed.err},
            "resumed_from": resumed.resumed_from, "saved_steps": list(resumed.saved_steps),
            "child": {"rc": p.returncode, "latest": latest, "wall_s": child_s},
            "manifest_dtypes": dtypes, "bitwise": same, "launches": launches_plain,
            "wall_s": {"plain": wall_plain, "resume": wall_resume},
            **save_stats(col.records)}
        emit(row)
        require(all(same.values()), f"bf16 porosity: resumed fields differ: {same}")
        require(plain.iters == resumed.iters == CKPT_CAP and plain.err == resumed.err
                and resumed.resumed_from == CKPT_KILL, f"bf16 porosity: {row['iters']}")
        require(dtypes["fields/phi"] == dtypes["fields/Pe"] == "bfloat16",
                f"bf16 porosity: manifest dtypes {dtypes}")
        del plain, resumed
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()

        # ---- GP drift-guarded, checkpointed against plain ------------------
        kw = dict(n=n_gp, nt=GP_TOL_CAP, tol=GP_TOL, check_every=CKPT_CHECK, device=device)
        plain, wall_plain = timed(torch, device, lambda: gp.solve(gp.GPConfig(**kw)))
        ck = os.path.join(root, "gp")
        col = telemetry.configure(None)
        try:
            ckd, wall_ck = timed(torch, device, lambda: gp.solve(gp.GPConfig(
                **kw, checkpoint_dir=ck, save_every=CKPT_SAVE_EVERY["gp"])))
        finally:
            telemetry.reset()
        latest = CheckpointManager(ck).latest_step()
        shutil.rmtree(ck)
        same = {k: bool(torch.equal(plain[k], ckd[k])) for k in ("re", "im")}
        out["gp"] = row = {
            "phase": "main_path_checkpoint", "solver": "gp", "dtype": "float32",
            "shape": [n_gp] * 3, "config": dict(kw, save_every=CKPT_SAVE_EVERY["gp"]),
            "iters": [plain["iters"], ckd["iters"]], "drift": [plain["drift"], ckd["drift"]],
            "latest": latest, "bitwise": same,
            "wall_s": {"plain": wall_plain, "checkpointed": wall_ck},
            **save_stats(col.records)}
        emit(row)
        require(all(same.values()) and plain["iters"] == ckd["iters"] == latest
                and plain["drift"] == ckd["drift"], f"GP: checkpointed run differs: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def telemetry_main_path(torch, step, spec, cfg=None, device="cuda") -> dict:
    """FIG1 through ``solve_until`` with telemetry off, then twice into a
    JSONL log (the first call may trace, the second is warm): the same
    iterations, host syncs, launches and fields each time; the log must
    validate under the port's schema and hold the warm solve's roofline
    record, against ``spec`` (``device_spec()``) on the card."""
    from repro_torch.configs import FIG1
    from repro_torch.core import iterate
    from repro_torch.examples import quickstart
    from repro_torch.kernels import stencil
    from repro_torch.telemetry import Collector, schema

    cfg = cfg or FIG1
    _, f, sc = quickstart.initial_state(cfg, device)
    kern = step.with_reductions(ERR)
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        path = os.path.join(root, "fig1.jsonl")
        col = Collector(path, meta={"config": "FIG1", "shape": list(cfg.shape)})
        runs, launches = [], []
        for sel in (False, col, col):
            stencil.launches.clear()
            runs.append(timed(torch, device, lambda: iterate.solve_until(
                kern, f, sc, tol=1e-7, max_iters=1000, check_every=10, telemetry=sel)))
            launches.append(dict(stencil.launches))
        col.close()
        counts = schema.validate_file(path)
        recs = schema.load_records(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    roof = [r["attrs"] for r in recs if r["kind"] == "event" and r["name"] == "roofline"]
    spans = [r["attrs"] for r in recs if r["kind"] == "span" and r["name"] == "solve_until"]
    (r0, w0) = runs[0]
    row = {"phase": "main_path_telemetry", "config": "FIG1", "shape": list(cfg.shape),
           "records": counts, "cold": [s["cold"] for s in spans],
           "iters": [r.iters for r, _ in runs], "host_syncs": [r.host_syncs for r, _ in runs],
           "launches": launches, "wall_s": [w for _, w in runs],
           "roofline": roof[-1] if roof else None,
           "card": getattr(spec, "name", None), "power_limit": getattr(spec, "power_limit", None),
           "copy_bandwidth_GBps": spec.peak_bw / 1e9 if spec else None}
    if roof:
        r = roof[-1]
        row.update(roofline_fraction=r["roofline_fraction"], bounded=r["bounded"],
                   t_eff_measured_GBs=r["t_eff_measured"] / 1e9,
                   t_eff_model_GBs=r["t_eff_model"] / 1e9,
                   t_eff_over_copy=(r["t_eff_measured"] / spec.peak_bw if spec else None))
    emit(row)
    require(roof and not spans[-1]["cold"], "the warm FIG1 solve left no roofline record")
    require(roof[-1]["bounded"] and 0 < roof[-1]["roofline_fraction"] <= 1,
            f"FIG1's roofline fraction is no share of the roofline: {roof[-1]}")
    for r, _ in runs[1:]:
        require((r.iters, r.err, r.host_syncs) == (r0.iters, r0.err, r0.host_syncs)
                and torch.equal(r.fields["T"], r0.fields["T"]),
                "FIG1 solve_until differs with telemetry on")
    require(r0.host_syncs == r0.iters // 10, "host_syncs != iters // check_every")
    require(launches[1] == launches[2] == launches[0],
            f"telemetry changed the launches: {launches}")
    return row


# ---------------------------------------------------------------------------
# the distributed runtime: gangs of rank processes on the one card
# ---------------------------------------------------------------------------
DIST_SEED = 20261018
DIST_MESH = (2, 2)        # FIG1's 510 interior cells split 2 x 2 (510 is not 4 x 127.5)
DIST_CHECK, DIST_STOP, DIST_CAP = 10, 50, 100
DIST_TIMED = 20           # steps each rank times of sequential_step and overlapped_step
GP_MESH, GP_STEPS = (2,), 10
GP_SUMS = {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}
DIST_SUM_RTOL = 1e-5      # a sum of 512^3 f32 squares folded in another order
BF16_REL = 2.0 ** -8      # one bf16 rounding to nearest: 8 significant bits
DRILL_N, DRILL_WORLD, DRILL_KILL_AT, DRILL_ITERS = 130, 4, 20, 40
DRILL_ATOL = 1e-5         # the reference's cross-mesh tolerance for the drill
NCCL_N, NCCL_STEPS = 66, 20
GANG_CMD = "import sys, chip_smoke; sys.exit(chip_smoke.gang_worker())"


def dist_fig1(torch, n=None, device="cuda"):
    """FIG1's global state, seeded: the Fig. 1 initial T plus 0.01 U[0, 1)
    drawn on ``device`` from a generator seeded with DIST_SEED (the parent
    and every rank make the same bits), T2 a copy, Ci; and the scalars.
    ``n`` cuts the grid to n^3 (CPU rehearsals)."""
    from repro_torch.configs import FIG1
    from repro_torch.examples import quickstart

    cfg = FIG1 if n is None else dataclasses.replace(FIG1, nx=n, ny=n, nz=n)
    _, f, sc = quickstart.initial_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(DIST_SEED)
    T = f["T"] + 0.01 * torch.rand(f["T"].shape, generator=gen, device=device)
    return {"T2": T.clone(), "T": T, "Ci": f["Ci"]}, sc


def fig1_kernels(device, backend=None):
    """FIG1's @parallel step and its checked twin (``ERR``)."""
    from repro_torch.core import init_parallel_stencil
    from repro_torch.core.device import default_backend
    from repro_torch.examples import quickstart

    step = quickstart.make_step(init_parallel_stencil(
        backend=backend or default_backend(device), device=device))
    return step, step.with_reductions(ERR)


def gp_kernel(n=None, device="cuda", backend=None):
    """GP's fused update (bc none; radius 2) with its two ``sum_sq``
    epilogues at 512^3 (``n^3`` when given): ``(kernel, config, scalars)``;
    the solver's own state is ``gross_pitaevskii.init_state(config)``."""
    from repro_torch.examples import gross_pitaevskii as gp

    cfg = gp.GPConfig(n=n or COUPLED_FULL["gp"][0], device=device, backend=backend)
    grid = gp.make_grid(cfg)
    kern = gp.make_step(grid, cfg).kernels[0].with_reductions(GP_SUMS)
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
    sc = dict(g=cfg.g, dt=gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
    return kern, cfg, sc


def shape_counts(counter) -> dict:
    """``stencil.shape_launches`` as ``{"label@AxBxC": n}``."""
    return {f"{label}@{'x'.join(map(str, shape))}": n for (label, shape), n in counter.items()}


def sent_bytes(mesh, shape, depths, itemsize) -> int:
    """Bytes this rank sends in one exchange of one field: its slab toward
    each neighbour it has (an edge rank of a non-periodic axis has one)."""
    total = 0
    for i in range(len(mesh.shape)):
        for side, direction in ((0, 1), (1, -1)):
            if mesh.neighbor(i, direction) is not None:
                total += (depths[i][side] * itemsize
                          * math.prod(s for a, s in enumerate(shape) if a != i))
    return total


def gang_worker() -> int:
    """One rank of a chip_smoke gang, started by ``run_gang`` through the
    multihost ``Supervisor``: ``CHIP_GANG_MODE`` ``fig1`` (FIG1 on 2 x 2
    ranks) or ``gp`` (GP on 2 ranks along x), on ``CHIP_GANG_DEVICE`` at
    ``CHIP_GANG_N`` (the full size when unset), over gloo. Prints one
    ``GANG {json}`` line."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import multihost

    ctx = multihost.initialize(backend="gloo", timeout_s=120, collective_timeout_s=300)
    device = os.environ.get("CHIP_GANG_DEVICE", "cuda")
    n = int(os.environ["CHIP_GANG_N"]) if os.environ.get("CHIP_GANG_N") else None
    if device == "cpu":
        torch.set_num_threads(1)
    rank_fn = {"fig1": fig1_rank, "gp": gp_rank}[os.environ["CHIP_GANG_MODE"]]
    out = rank_fn(torch, device, n)
    print("GANG " + json.dumps(out), flush=True)
    multihost.shutdown()
    return 0


def timed_steps(torch, device, fn, cur, k, timer=None):
    """``k`` steps of ``fn`` (FIG1's rotation), the device drained at both
    ends: ``(fields, seconds)``."""
    def run():
        nonlocal cur
        for _ in range(k):
            out, fresh = fn(cur, timer)
            cur = dict(fresh, T2=fresh["T"], T=out)
        return cur
    return timed(torch, device, run)


def fig1_rank(torch, device, n) -> dict:
    """FIG1 on 2 x 2 ranks: the main path (``elastic_solve_until`` with
    ``overlapped_step``, to the parent's tol, launch counts set to 0 just
    before and read just after), held on rank 0 to the single-process
    ``solve_until``; then a step of ``sequential_step`` against
    ``overlapped_step``, each timed over DIST_TIMED steps with its
    exchange's parts, the checked overlapped step (its reductions
    folded over the owned cells, combined and read on the host, as a
    check of the main path does) and the plain one with the device
    drained after it; the bytes on the wire,
    ``multi_step(k=2)`` on 2-deep ghost rings (a check: its launches are
    counted apart), and the bf16 and int8 wires."""
    import torch.distributed as dist

    from repro_torch.core import iterate
    from repro_torch.distributed import compression, elastic, halo, overlap
    from repro_torch.kernels import stencil
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(DIST_MESH, ("x", "y"))
    step, chk = fig1_kernels(device)
    fields, sc = dist_fig1(torch, n, device)
    tol = float(os.environ["CHIP_GANG_TOL"])
    out = {"rank": mesh.rank, "coords": list(mesh.coords)}

    timer = halo.ExchangeTimer()
    stencil.launches.clear()
    stencil.shape_launches.clear()
    res, wall = timed(torch, device, lambda: elastic.elastic_solve_until(
        chk, fields, sc, factors=DIST_MESH, tol=tol, max_iters=DIST_CAP, exchange=("T",),
        check_every=DIST_CHECK, step="overlapped", gather_to=0, timer=timer))
    out["launches"] = shape_counts(stencil.shape_launches)
    parts = timer.seconds()
    # wall: the whole call, cutting the blocks and the final gather to rank 0
    # (three 257 x 257 x 512 blocks a rank through gloo) included
    out["solve"] = {"iters": res.iters, "err": res.err, "host_syncs": res.host_syncs,
                    "wall_s": wall, "wall_ms_per_step": wall / res.iters * 1e3,
                    "exchanges": timer.exchanges,
                    "parts_ms_per_exchange": {k: v / timer.exchanges * 1e3
                                              for k, v in parts.items()}}
    if mesh.position == 0:
        want = iterate.solve_until(chk, fields, sc, tol=tol, max_iters=DIST_CAP,
                                   check_every=DIST_CHECK)
        out["single"] = {"iters": want.iters, "err": want.err,
                         "bitwise": {k: bool(torch.equal(res.fields[k], want.fields[k].cpu()))
                                     for k in ("T2", "T", "Ci")}}
        del want
    del res

    local = {k: halo.local_block(v, DIST_MESH, mesh.coords, 1) for k, v in fields.items()}

    def fresh_copy():
        return {k: v.clone() for k, v in local.items()}

    a, b = fresh_copy(), fresh_copy()
    seq, _ = overlap.sequential_step(step, a, sc, ("T",), mesh)
    ovl, _ = overlap.overlapped_step(step, b, sc, ("T",), mesh)
    out["ovl_equals_seq"] = bool(torch.equal(seq, ovl) and torch.equal(a["T"], b["T"]))
    out["ms_per_step"], out["parts_ms_per_exchange"] = {}, {}
    for name, fn in (("sequential", overlap.sequential_step),
                     ("overlapped", overlap.overlapped_step)):
        def one(cur, t, fn=fn):
            return fn(step, cur, sc, ("T",), mesh, timer=t)
        cur, _ = timed_steps(torch, device, one, fresh_copy(), 2)          # warm
        dist.barrier()
        cur, wall = timed_steps(torch, device, one, cur, DIST_TIMED)
        out["ms_per_step"][name] = wall / DIST_TIMED * 1e3
        t = halo.ExchangeTimer()
        timed_steps(torch, device, one, cur, DIST_TIMED, t)
        out["parts_ms_per_exchange"][name] = {k: v / t.exchanges * 1e3
                                              for k, v in t.seconds().items()}

    def checked(cur, t):
        (o, reds), fresh = overlap.overlapped_step(chk, cur, sc, ("T",), mesh, timer=t)
        float(reds["err"])            # the check's host read
        return o, fresh

    def drained(cur, t):
        # the plain step with the device drained after it, as the check's
        # host read drains it: what the fold and the all-reduce add is the rest
        res = overlap.overlapped_step(step, cur, sc, ("T",), mesh, timer=t)
        sync(torch, device)
        return res
    for name, fn in (("overlapped_checked", checked), ("overlapped_drained", drained)):
        cur, _ = timed_steps(torch, device, fn, fresh_copy(), 2)           # warm
        dist.barrier()
        _, wall = timed_steps(torch, device, fn, cur, DIST_TIMED)
        out["ms_per_step"][name] = wall / DIST_TIMED * 1e3
    ir = step.stencil_ir(**local, **sc)
    depths = ir.field_halo["T"][:2]
    shp = tuple(local["T"].shape)
    out["bytes"] = {
        "local_shape": list(shp),
        "sent_by_this_rank": sent_bytes(mesh, shp, depths, 4),
        **{f"exchange_byte_counts[{c}]": halo.exchange_byte_counts(
            {"T": shp}, {"T": 4}, {"T": True}, 2, radius=1, depths={"T": depths}, compress=c)
           for c in (None, "bf16", "int8")}}

    # the k-step path, a check off the main path: its launches are its own
    lk = {k: halo.local_block(v, DIST_MESH, mesh.coords, 2) for k, v in fields.items()}
    stencil.shape_launches.clear()
    out_k, _ = overlap.multi_step(step, lk, sc, ("T",), mesh, 2)
    sync(torch, device)
    out["check_launches"] = shape_counts(stencil.shape_launches)
    gk = elastic.fetch_global({"T": out_k}, mesh, 2, to=0)
    if mesh.position == 0:
        one = step(**fields, **sc)
        two = step(T2=fields["T"], T=one, Ci=fields["Ci"], **sc).cpu()
        own = (slice(2, -2), slice(2, -2))
        out["k2_owned_bitwise"] = bool(torch.equal(gk["T"][own], two[own]))
    del lk, out_k, gk

    out["compress"] = {}
    exact = local["T"]              # blocks cut from the global hold the exact ghosts
    for fmt in ("bf16", "int8"):
        got = halo.exchange_many(fresh_copy(), ("T",), mesh, radius=1, compress=fmt)["T"]
        diff = (got.double() - exact.double()).abs()
        if fmt == "bf16":
            ok = bool((diff <= exact.double().abs() * BF16_REL).all())
        else:
            # x ghost rows (axis 0, exchanged first: each message is the
            # neighbour's interior row, which equals the exact ghost row),
            # off the y ghost columns the y exchange overwrites
            ok = True
            for at, direction in ((0, -1), (-1, 1)):
                if mesh.neighbor(0, direction) is None:
                    continue
                row = exact[at].reshape(-1)
                _, s, meta = compression.quantize_int8(row)
                bound = compression.int8_error_bound(row, s, meta).reshape(exact[at].shape)
                ok &= bool((diff[at][1:-1] <= bound[1:-1]).all())
        out["compress"][fmt] = {"max_abs_err": float(diff.max()), "within_bound": ok,
                                "interior_exact": bool(torch.equal(got[1:-1, 1:-1],
                                                                   exact[1:-1, 1:-1]))}
    return out


def gp_rank(torch, device, n) -> dict:
    """GP's fused update on 2 ranks along x (radius 2, re and im exchanged
    to their read depths, V's ghosts cut from the global state): GP_STEPS
    overlapped steps with the sum_sq epilogues folded and summed across
    ranks, launch counts set to 0 just before; rank 0 holds the gathered
    fields to GP_STEPS single-process steps bitwise, the sums within
    DIST_SUM_RTOL. Then GP_STEPS more of each driver from the same start,
    timed: ``sequential_step``, and ``overlapped_step`` with its
    exchange's parts."""
    import torch.distributed as dist

    from repro_torch.distributed import elastic, halo, overlap
    from repro_torch.kernels import stencil
    from repro_torch.launch.mesh import make_mesh

    from repro_torch.examples import gross_pitaevskii as gp

    mesh = make_mesh(GP_MESH, ("x",))
    kern, cfg, sc = gp_kernel(n, device)
    _, re, im, V = gp.init_state(cfg)
    fields = dict(re2=re, im2=im, re=re, im=im, V=V)
    cur = {k: halo.local_block(v, GP_MESH, mesh.coords, 2) for k, v in fields.items()}
    r, depths, _ = overlap._kernel_geometry(kern, cur, sc, ("re", "im"), mesh)
    out = {"rank": mesh.rank, "coords": list(mesh.coords), "radius": r,
           "depths": {k: [list(p) for p in v] for k, v in depths.items()}}

    def one(fn=overlap.overlapped_step, timer=None):
        nonlocal cur
        (o, r_), fresh = fn(kern, cur, sc, ("re", "im"), mesh, timer=timer)
        cur = dict(fresh, re2=fresh["re"], im2=fresh["im"], re=o["re2"], im=o["im2"])
        return r_

    stencil.launches.clear()
    stencil.shape_launches.clear()
    walls = []
    for _ in range(GP_STEPS):
        reds, wall = timed(torch, device, one)
        walls.append(wall * 1e3)
    out["launches"] = shape_counts(stencil.shape_launches)
    # each step ends in its check's all-reduce and a host read; the first
    # step starts the side stream, the pinned buffers and gloo's pairs
    out["ms_per_step"] = {"first": walls[0],
                          "median_after": sorted(walls[1:])[(len(walls) - 1) // 2]}
    out["sums"] = {k: float(v) for k, v in reds.items()}
    shp = tuple(cur["re"].shape)
    out["bytes"] = {"local_shape": list(shp),
                    "sent_by_this_rank": sum(sent_bytes(mesh, shp, depths[f], 4)
                                             for f in ("re", "im")),
                    "exchange_byte_counts": halo.exchange_byte_counts(
                        {f: shp for f in ("re", "im")}, {"re": 4, "im": 4},
                        {"re": True, "im": True}, 1, radius=r, depths=depths)}
    g = elastic.fetch_global({"re": cur["re"], "im": cur["im"]}, mesh, r, to=0)
    if mesh.position == 0:
        ref = dict(fields)
        for _ in range(GP_STEPS):
            o, want = kern(**ref, **sc)
            ref = dict(ref, re2=ref["re"], im2=ref["im"], re=o["re2"], im=o["im2"])
        out["single"] = {"bitwise": {k: bool(torch.equal(g[k], ref[k].cpu()))
                                     for k in ("re", "im")},
                         "sums": {k: float(v) for k, v in want.items()}}
        del ref, want
    del g
    start = {k: halo.local_block(v, GP_MESH, mesh.coords, 2) for k, v in fields.items()}
    del fields
    out["drivers_ms_per_step"], out["parts_ms_per_exchange"] = {}, {}
    for name, fn in (("sequential", overlap.sequential_step),
                     ("overlapped", overlap.overlapped_step)):
        cur = {k: v.clone() for k, v in start.items()}
        timer = halo.ExchangeTimer()
        timed(torch, device, lambda: one(fn))                              # warm
        dist.barrier()
        walls = [timed(torch, device, lambda: one(fn, timer))[1] * 1e3
                 for _ in range(GP_STEPS)]
        out["drivers_ms_per_step"][name] = sorted(walls)[(len(walls) - 1) // 2]
        out["parts_ms_per_exchange"][name] = {k: v / timer.exchanges * 1e3
                                              for k, v in timer.seconds().items()}
    return out


def run_gang(mode: str, world: int, env: dict, deadline_s: float = 420.0) -> tuple:
    """Start ``world`` rank processes of ``gang_worker`` in ``mode`` through
    the multihost ``Supervisor`` (fresh interpreters, each rank's output in
    a log), wait for them, and return ``(rows by rank, seconds)``; any
    rank's failure (or the deadline) fails the run."""
    from repro_torch.launch import multihost

    root = tempfile.mkdtemp(prefix=f"chip_smoke_gang_{mode}_")
    try:
        sup = multihost.Supervisor(
            lambda rank, w, attempt: [sys.executable, "-c", GANG_CMD], world,
            heartbeat_dir=root, run_id=mode, attempt_deadline_s=deadline_s,
            env={"PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"), ROOT]),
                 "CHIP_GANG_MODE": mode, **env})
        rc = sup.run_attempt(0, world)
        logs = []
        for rank in range(world):
            with open(sup.log_path(0, rank)) as f:
                logs.append(f.read())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(rc == 0, f"the {mode} gang failed ({sup.reports[-1].reason}):\n"
            + "\n".join(f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(logs)))
    rows = [json.loads(ln[5:]) for t in logs for ln in t.splitlines() if ln.startswith("GANG ")]
    require(len(rows) == world, f"the {mode} gang printed {len(rows)} result lines")
    return sorted(rows, key=lambda r: r["rank"]), sup.reports[-1].duration_s


def dist_calls(n_fig1=None, n_gp=None, n_drill=DRILL_N) -> list:
    """Every generated kernel the gangs and the drill launch, at their
    shapes: FIG1's rank block, shell slabs and 2-deep k-step block, GP's
    rank block and slabs, the drill's rank blocks; and the checked FIG1
    and GP kernels at the rank blocks (``check_cost``)."""
    from repro_torch.core import init_parallel_stencil
    from repro_torch.distributed import overlap
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import RankMesh

    step, chk = fig1_kernels("cuda")
    n = n_fig1 or 512
    b1, b2 = (n - 2) // 2 + 2, (n - 4) // 2 + 4
    sc = dict.fromkeys(("lam", "dt", "_dx", "_dy", "_dz"), 1.0)
    mesh = RankMesh(DIST_MESH, ("x", "y"), 0, (0, 1, 2, 3))
    block = {k: (b1, b1, n) for k in ("T2", "T", "Ci")}
    # the checked kernels at the rank blocks: timed by check_cost
    calls = [step.compiled(**block, **sc), chk.compiled(**block, **sc),
             step.compiled(nsteps=2, **{k: (b2, b2, n) for k in block}, **sc)]
    calls += [step.compiled(**shp, **sc)
              for _, _, shp in overlap.shell_slabs(step, block, sc, ("T",), mesh)]
    kern, _, gsc = gp_kernel(n_gp)
    g = n_gp or COUPLED_FULL["gp"][0]
    gblock = {k: ((g - 4) // 2 + 4, g, g) for k in ("re2", "im2", "re", "im", "V")}
    plain = kern.with_reductions(None)
    calls += [plain.compiled(**gblock, **gsc), kern.compiled(**gblock, **gsc)]
    calls += [plain.compiled(**shp, **gsc) for _, _, shp in overlap.shell_slabs(
        plain, gblock, gsc, ("re", "im"), RankMesh(GP_MESH, ("x",), 0, (0, 1)))]
    demo = multihost.demo_kernel(init_parallel_stencil()).with_reductions(None)
    for w in (DRILL_WORLD, 2, 1):
        shp = ((n_drill - 2) // w + 2, n_drill, n_drill)
        calls.append(demo.compiled(T2=shp, T=shp, dt=1.0))
    return calls


def distributed_main_path(torch, spec, n_fig1=None, n_gp=None, device="cuda") -> dict:
    """``main_path_distributed``: FIG1 on a gang of 4 rank processes (2 x 2,
    gloo, halos staged through host memory) and GP on 2, each rank
    running the generated kernels on the one card; every kernel they
    launch is built here before the ranks start. Returns the gangs' rows
    and launch counts for the kernels line."""
    from repro_torch.core import iterate
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    if device == "cuda":
        calls = dist_calls()
        build.compile_many([(c.lib_name, c.source) for c in calls])
        emit({"phase": "build_distributed", "wall_s": time.perf_counter() - t0,
              "sources": sorted({c.lib_name for c in calls}),
              "shapes": sorted({"x".join(map(str, c.ir.base_shape)) for c in calls})})
    _, chk = fig1_kernels(device)
    fields, sc = dist_fig1(torch, n_fig1, device)
    stop = iterate.solve_until(chk, fields, sc, tol=0.0, max_iters=DIST_STOP,
                               check_every=DIST_CHECK)
    tol = stop.err                    # the gang must stop right here, as one process does
    del fields, stop
    env = {"CHIP_GANG_DEVICE": device}
    if n_fig1:
        env["CHIP_GANG_N"] = str(n_fig1)
    fig1, fig1_s = run_gang("fig1", math.prod(DIST_MESH), dict(env, CHIP_GANG_TOL=repr(tol)))
    card = {"card": getattr(spec, "name", None), "power_limit": getattr(spec, "power_limit", None)}
    note = ("the rank processes take turns on one card and their halos cross host memory: "
            "these times measure the protocol and its cost, not the paper's scaling")
    r0 = fig1[0]
    row = {"phase": "main_path_distributed", "config": "FIG1",
           "shape": [n_fig1 or 512] * 3, "mesh": list(DIST_MESH),
           "transport": "gloo, host-staged", **card, "note": note, "gang_s": fig1_s,
           "tol": tol, "iters": [r["solve"]["iters"] for r in fig1],
           "err": [r["solve"]["err"] for r in fig1], "single": r0["single"],
           "ovl_equals_seq": [r["ovl_equals_seq"] for r in fig1],
           "k2_owned_bitwise": r0["k2_owned_bitwise"],
           "compress": {r["rank"]: r["compress"] for r in fig1},
           "ranks": [{k: r[k] for k in ("rank", "coords", "ms_per_step",
                                        "parts_ms_per_exchange", "bytes", "launches",
                                        "check_launches")}
                     | {"solve": r["solve"]} for r in fig1]}
    emit(row)
    for r in fig1:
        require(r["solve"]["iters"] == r0["single"]["iters"] == DIST_STOP,
                f"rank {r['rank']} stopped at {r['solve']['iters']}, one process at "
                f"{r0['single']['iters']} (expected {DIST_STOP})")
        require(r["solve"]["err"] == r0["single"]["err"], "the gang's err differs from one "
                f"process's: {r['solve']['err']} against {r0['single']['err']}")
        require(r["ovl_equals_seq"], f"rank {r['rank']}: overlapped_step != sequential_step")
        for fmt, c in r["compress"].items():
            require(c["within_bound"] and c["interior_exact"] and c["max_abs_err"] > 0,
                    f"rank {r['rank']}: the {fmt} wire is off its bound: {c}")
    require(all(r0["single"]["bitwise"].values()),
            f"the gathered FIG1 fields differ from one process's: {r0['single']['bitwise']}")
    n = n_fig1 or 512
    b1, b2 = (n - 2) // 2 + 2, (n - 4) // 2 + 4
    for key in (f"step@{b1}x{b1}x{n}", f"step@3x{b1}x{n}", f"step@{b1}x3x{n}"):
        require(device != "cuda" or all(r["launches"].get(key, 0) > 0 for r in fig1),
                f"kernel {key} was not launched on the distributed main path")
    k2 = f"step/k2@{b2}x{b2}x{n}"
    require(device != "cuda" or all(r["check_launches"].get(k2, 0) > 0 for r in fig1),
            f"the multi_step(k=2) check did not launch {k2}")
    require(r0["k2_owned_bitwise"], "multi_step(k=2) differs from two single steps")

    gp_rows, gp_s = run_gang("gp", math.prod(GP_MESH),
                             dict(env, **({"CHIP_GANG_N": str(n_gp)} if n_gp else {})))
    g0 = gp_rows[0]
    sums = {k: [g0["sums"][k], g0["single"]["sums"][k]] for k in GP_SUMS}
    emit({"phase": "main_path_distributed_gp", "config": "GP fused, bc none",
          "shape": [n_gp or COUPLED_FULL["gp"][0]] * 3, "mesh": list(GP_MESH),
          "transport": "gloo, host-staged", **card, "note": note, "gang_s": gp_s,
          "steps": GP_STEPS, "radius": g0["radius"], "depths": g0["depths"],
          "fields_bitwise": g0["single"]["bitwise"], "sums": sums,
          "sum_rtol": DIST_SUM_RTOL,
          "ranks": [{k: r[k] for k in ("rank", "ms_per_step", "drivers_ms_per_step",
                                       "parts_ms_per_exchange", "bytes", "launches")}
                    for r in gp_rows]})
    require(all(g0["single"]["bitwise"].values()),
            f"GP on 2 ranks differs from one process: {g0['single']['bitwise']}")
    for k, (a, b) in sums.items():
        require(math.isclose(a, b, rel_tol=DIST_SUM_RTOL),
                f"GP's {k} on 2 ranks {a} against one process's {b}")
    g = n_gp or COUPLED_FULL["gp"][0]
    for key in (f"update@{(g - 4) // 2 + 4}x{g}x{g}", f"update@6x{g}x{g}"):
        require(device != "cuda" or all(r["launches"].get(key, 0) > 0 for r in gp_rows),
                f"kernel {key} was not launched on GP's distributed path")
    # the kernels line counts the main paths' launches only; the k-step
    # kernel ran in its check alone: a row with 0 main-path launches
    launches = collections.Counter({k2: 0})
    for r in fig1 + gp_rows:
        launches.update(r["launches"])
    return {"fig1": fig1, "gp": gp_rows, "launches": dict(launches)}


def multihost_main_path(torch, spec, n=DRILL_N, device="cuda") -> dict:
    """``main_path_multihost``: the supervised recovery drill through the
    launcher's CLI, ``python -m repro_torch.launch.multihost --demo --world
    4 --backend gloo --kill-rank 1 --kill-at 20`` (the demo worker's
    kernel on ``device``'s backend, a reduced DRILL_N^3 grid: the drill's
    job is recovery). The supervisor must see exit 113, replan to 2 ranks
    and resume from the global checkpoint at 20; the result is held to an
    uninterrupted run in this process within DRILL_ATOL. Every rank of
    every attempt prints its launches after each chunk; the last line of
    each counts: attempt 0's through its last checkpoint (DRILL_KILL_AT),
    before the kill (the stragglers' launches after it, until they are
    terminated, are not counted)."""
    import numpy as np

    from repro_torch.core import init_parallel_stencil
    from repro_torch.core.device import default_backend
    from repro_torch.distributed import elastic
    from repro_torch.launch import multihost

    root = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        args = ["-m", "repro_torch.launch.multihost", "--demo", "--world", str(DRILL_WORLD),
                "--backend", "gloo", "--kill-rank", "1", "--kill-at", str(DRILL_KILL_AT),
                "--device", device, "--n", str(n), "--max-iters", str(DRILL_ITERS),
                "--workdir", root, "--run-id", "drill", "--deadline", "300"]
        p, wall = timed(torch, device, lambda: child(args))
        require(p.returncode == 0, f"the drill failed: {p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        lines = p.stdout.splitlines()
        report = json.loads("\n".join(lines[lines.index("{"):]))
        logs = {}
        for a in report["attempts"]:
            for rank in range(a["world"]):
                with open(os.path.join(root, "hb", f"{a['run_id']}.rank{rank}.log")) as f:
                    logs[(a["attempt"], rank)] = f.read()
        got = np.load(os.path.join(root, "out.npy"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches, through = collections.Counter(), {}
    for (attempt, rank), text in logs.items():
        last = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")][-1:]
        if last:
            done, counts = last[0][9:].split(" ", 1)
            through[f"{attempt}/{rank}"] = int(done)
            launches.update(json.loads(counts))
    demo = multihost.demo_kernel(init_parallel_stencil(backend=default_backend(device),
                                                       device=device))
    T0 = multihost.demo_initial(n).to(device)
    want = elastic.elastic_solve_until(demo, dict(T2=T0, T=T0), dict(dt=1e-3), factors=(1,),
                                       tol=0.0, max_iters=DRILL_ITERS, exchange=("T",),
                                       check_every=multihost.DEMO_CHECK_EVERY)
    diff = float(np.abs(got - want.fields["T"].cpu().numpy()).max())
    resumed = "resumed_from=20" in logs.get((1, 0), "")
    emit({"phase": "main_path_multihost", "shape": [n] * 3, "command": " ".join(args[:-6]),
          "wall_s": wall, "restarts": report["restarts"], "final_world": report["final_world"],
          "exit_codes": report["exit_codes"],
          "attempts": [{k: a[k] for k in ("attempt", "world", "exit_codes", "reason",
                                          "duration_s")} for a in report["attempts"]],
          "resumed_from_20": resumed, "max_abs_diff_vs_uninterrupted": diff,
          "atol": DRILL_ATOL, "launches": dict(launches),
          "launches_through_step": through,
          "card": getattr(spec, "name", None), "power_limit": getattr(spec, "power_limit", None)})
    require(report["exit_codes"][0] == KILL_EXIT_CODE and report["exit_codes"][-1] == 0,
            f"the drill's exit codes: {report['exit_codes']}")
    require(report["restarts"] == 1 and report["final_world"] == 2,
            f"the drill did not replan 4 -> 2: {report}")
    require(resumed, "the drill's second attempt did not resume from the checkpoint at 20")
    require(diff <= DRILL_ATOL, f"the drill's result is {diff} off the uninterrupted run")
    want_through = {f"{a['attempt']}/{rank}": DRILL_KILL_AT if a["attempt"] == 0 else DRILL_ITERS
                    for a in report["attempts"] for rank in range(a["world"])}
    require(through == want_through,
            f"the drill's ranks counted their launches through {through}, not {want_through}")
    blocks = {f"kern@{(n - 2) // w + 2}x{n}x{n}" for w in (DRILL_WORLD, 2)}
    require(device != "cuda" or all(launches.get(k, 0) > 0 for k in blocks),
            f"the drill's ranks did not launch {sorted(blocks)}: {dict(launches)}")
    return {"launches": dict(launches)}


def nccl_main_path(torch, spec, device="cuda") -> dict:
    """A world-1 NCCL group on the card: FIG1 (NCCL_N^3) through
    ``elastic_solve_until`` with ``overlapped_step`` and periodic x and y
    (self-wrap exchanges; the check's all-reduce through NCCL), bitwise
    equal to the same solve with no process group; a periodic exchange
    against the wrap done by hand. Then ``initialize(backend="nccl")`` for
    2 ranks on this one card must refuse with the pointed error."""
    import torch.distributed as dist

    from repro_torch.distributed import elastic, halo
    from repro_torch.ir import Reduction
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_mesh

    _, chk = fig1_kernels(device)
    fields, sc = dist_fig1(torch, NCCL_N, device)

    def solve():
        return elastic.elastic_solve_until(
            chk, fields, sc, factors=(1, 1), tol=0.0, max_iters=NCCL_STEPS, exchange=("T",),
            check_every=5, periodic=True, step="overlapped")

    ctx = multihost.initialize(coordinator=multihost.default_coordinator(), num_processes=1,
                               process_id=0, backend="nccl", timeout_s=60)
    try:
        mesh = make_mesh((1, 1), ("x", "y"))
        backend = mesh.backend
        probe = float(Reduction("max_abs", "T").all_reduce(torch.tensor(3.5, device=device)))
        t = fields["T"][:10, :9, :4].clone()
        w = halo.halo_exchange(t.clone(), mesh, radius=1, periodic=True)
        by_hand = t.clone()
        by_hand[0], by_hand[-1] = t[-2], t[1]
        by_hand[:, 0], by_hand[:, -1] = by_hand[:, -2].clone(), by_hand[:, 1].clone()
        wrap_ok = bool(torch.equal(w, by_hand))
        with_nccl = solve()
    finally:
        dist.destroy_process_group()
    without = solve()
    refusal = None
    try:
        multihost.initialize(coordinator=multihost.default_coordinator(), num_processes=2,
                             process_id=0, backend="nccl", timeout_s=30)
    except multihost.RendezvousError as e:
        refusal = str(e)
    same = (with_nccl.iters == without.iters and with_nccl.err == without.err
            and all(torch.equal(with_nccl.fields[k], without.fields[k]) for k in ("T", "T2")))
    emit({"phase": "nccl", "world": ctx.world, "backend": backend, "device": ctx.device,
          "all_reduce_probe": probe, "periodic_self_wrap_ok": wrap_ok,
          "solve": {"shape": [NCCL_N] * 3, "iters": with_nccl.iters, "err": with_nccl.err,
                    "bitwise_vs_no_group": same},
          "two_ranks_one_card_refused": refusal,
          "card": getattr(spec, "name", None), "power_limit": getattr(spec, "power_limit", None)})
    require(backend == "nccl" and probe == 3.5, f"the NCCL group did not run: {backend}")
    require(wrap_ok, "the periodic self-wrap under NCCL differs from the wrap by hand")
    require(same, "FIG1 through the NCCL group differs from the same solve without one")
    require(refusal is not None and "share a card" in refusal,
            f"two NCCL ranks on one card were not refused as they should be: {refusal}")
    return {}


def dist_times(torch, spec, launches, n_fig1=None, n_gp=None, n_drill=DRILL_N) -> list:
    """A kernels-line row per (kernel, shape) the gangs and the drill
    launched: the generated kernel at that shape on random fields against
    its torch-backend twin (bitwise), CUDA-event medians of both, and the
    bound of its bytes and operations."""
    from repro_torch.core import init_parallel_stencil, teff
    from repro_torch.launch import multihost

    step, _ = fig1_kernels("cuda")
    step_plain, _ = fig1_kernels("cuda", backend="torch")
    gk, _, gsc = gp_kernel()
    gp_plain = gp_kernel(backend="torch")[0].with_reductions(None)
    demo = multihost.demo_kernel(init_parallel_stencil()).with_reductions(None)
    demo_plain = multihost.demo_kernel(init_parallel_stencil(backend="torch", device="cuda"))
    demo_plain = demo_plain.with_reductions(None)
    kinds = {"step": (step, step_plain, ("T2", "T", "Ci"),
                      dict(lam=1.0, dt=1e-4, _dx=511.0, _dy=511.0, _dz=511.0)),
             "update": (gk.with_reductions(None), gp_plain, ("re2", "im2", "re", "im", "V"),
                        dict(gsc, dt=1e-4)),
             "kern": (demo, demo_plain, ("T2", "T"), dict(dt=1e-3))}
    gen = torch.Generator(device="cpu").manual_seed(DIST_SEED)
    rows = []
    for key, n in sorted(launches.items()):
        label, shape = key.split("@")
        shape = tuple(int(s) for s in shape.split("x"))
        k_steps = 2 if label.endswith("/k2") else 1
        kern, plain, names, sc = kinds[label.split("/")[0]]
        f = {m: torch.rand(shape, generator=gen).to("cuda") for m in names}
        if "T2" in f:
            # the k-step kernel equals k rotated steps where an output and
            # its rotation target agree on the write ring, as in the runs
            f["T2"] = f["T"].clone()
        run = (lambda: kern.run_steps(k_steps, **f, **sc)) if k_steps > 1 else (
            lambda: kern(**f, **sc))
        run_plain = (lambda: plain.run_steps(k_steps, **f, **sc)) if k_steps > 1 else (
            lambda: plain(**f, **sc))
        got, want = run(), run_plain()
        got = got if isinstance(got, dict) else {"out": got}
        want = want if isinstance(want, dict) else {"out": want}
        err = max(max_abs_diff(got[o], want[o]) for o in got)
        require(err == 0.0, f"{key} differs from its torch-backend twin by {err}")
        a_eff, ops = tap_cost(kern.compiled(nsteps=k_steps, **f, **sc))
        if k_steps > 1:
            ops *= k_steps
        bound_ms, bound_by = bound_of(a_eff, ops)
        ms = teff.measure(run, iters=20, warmup=3).median_s * 1e3
        plain_ms = teff.measure(run_plain, iters=10, warmup=2).median_s * 1e3
        rows.append({"name": key, "route": "cuda",
                     "source": ("src/repro_torch/kernels/codegen_steps.py" if k_steps > 1
                                else "src/repro_torch/kernels/codegen.py"),
                     "replaces": "src/repro/kernels/stencil.py:1052", "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
        del f, got, want
    emit({"phase": "times_distributed", "card": getattr(spec, "name", None),
          "power_limit": getattr(spec, "power_limit", None), "kernels": rows,
          "check_cost": check_cost(torch, gen)})
    return rows


def check_cost(torch, gen) -> list:
    """What a check adds to a rank's step, at the rank blocks of the FIG1
    gang (mesh position (0, 0) of 2 x 2) and of GP's (position 0 of 2):
    the distributed step launches the plain kernel and folds the
    reductions over the owned cells in PyTorch operations
    (``apply_reductions``, what ``overlap.owned_reductions`` runs before
    its all-reduce); one process launches the kernel with its fused
    epilogue over the whole block. CUDA-event medians of the plain launch,
    the fused launch and the fold alone, on random fields."""
    from repro_torch.core import teff
    from repro_torch.distributed import halo

    _, chk = fig1_kernels("cuda")
    gk, _, gsc = gp_kernel()
    b1, g = (512 - 2) // 2 + 2, COUPLED_FULL["gp"][0]
    cases = [("FIG1 step[err]", chk, ("T2", "T", "Ci"), (b1, b1, 512), DIST_MESH, (0, 0),
              dict(lam=1.0, dt=1e-4, _dx=511.0, _dy=511.0, _dz=511.0)),
             ("GP update[m_re, m_im]", gk, ("re2", "im2", "re", "im", "V"),
              ((g - 4) // 2 + 4, g, g), GP_MESH, (0,), dict(gsc, dt=1e-4))]
    out = []
    for name, kern, names, shape, factors, index, sc in cases:
        f = {m: torch.rand(shape, generator=gen).to("cuda") for m in names}
        plain = kern.with_reductions(None)
        outs = plain(**f, **sc)
        outs = {kern.outputs[0]: outs} if len(kern.outputs) == 1 else outs
        r = max(kern.stencil_ir(**f, **sc).inferred_radius, 1)
        own = halo.owned_slices(shape, factors, index, r)
        ms = {"plain_ms": lambda: plain(**f, **sc), "fused_ms": lambda: kern(**f, **sc),
              "owned_fold_ms": lambda: kern.apply_reductions(
                  {n: v[own] for n, v in outs.items()}, {n: v[own] for n, v in f.items()})}
        row = {"kernel": name, "shape": list(shape)}
        row.update({k: teff.measure(fn, iters=20, warmup=3).median_s * 1e3
                    for k, fn in ms.items()})
        row["fused_added_ms"] = row["fused_ms"] - row["plain_ms"]
        out.append(row)
        del f, outs
    return out


def make_generic(ps):
    """A two-output, radius-2 update with one-sided reads, a reversed
    subtraction and a division: it exercises what Fig. 1 does not."""
    @ps.parallel(outputs=("A2", "B2"), reductions={"d": "max_abs_diff(A2, A)",
                                                   "s": "sum_sq(B2)"})
    def generic(A2, B2, A, B, c, h):
        return {
            "A2": A[2:-2, 2:-2, 2:-2] + c * (A[4:, 2:-2, 2:-2] - A[:-4, 2:-2, 2:-2])
            - (1.0 - B[2:-2, 2:-2, 1:-3]) * h,
            "B2": B[1:-1, 1:-1, 1:-1] / (2.0 + abs(A[1:-1, :-2, 1:-1]))
            - h ** 2 * B[1:-1, 1:-1, 2:],
        }

    return generic


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
