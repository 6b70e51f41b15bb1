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
logits are held against the same run on the plain versions. Then the other
LM families (``main_path_lm_families``, ``LM_FAMILIES``): stablelm-3b,
qwen3-32b and moonshot-v1-16b-a3b (8 layers each, for 80 GB at f32),
phi-3-vision-4.2b, seamless-m4t-medium and mamba2-130m at their published
widths, each served at batch 4 with a 1024-position prompt and 16
generated tokens, on the kernels and then on the plain versions with the
same weights and prompt: launches exactly as listed, logits within
``LOGITS_TOL``, the greedy tokens that agree, peak memory, and for the MoE
the routing choices that differ between the two runs and the smallest
gap between the k-th and (k+1)-th gate probability; the phase must take at
most 150 s. ``times_lm_families`` times each kernel at those shapes beside
its bound, plain version and library call. Training follows
(``train_kernel_cases``, ``main_path_train``, ``main_path_train_lm``,
``times_train``; at most 150 s together): each backward kernel
(``csrc/{conv1d,ssd,attention}_bwd.cu``) against ``autograd.grad`` of its
plain version within ``TRAIN_TOL``, twice bitwise the same, the attention
forward's log-sum-exp against the plain logsumexp, and the refusals that
keep a backward from falling back; Zamba2-1.2B trained at full width and
depth (batch 4 x 1024, f32) through ``repro_torch.launch.train`` for
``TRAIN_STEPS`` steps on the kernels and on the plain versions from the same
weights and batches (step 0's loss and gradient norm, every later loss,
exact launches a step forward and backward, peak GB, warm ms a step,
tokens/s), and, cut to its first group for the disk, a run stopped at step 2
and resumed from its checkpoint against the uninterrupted one; then the
``train_lm`` twin (mamba2-130m, 300 steps), whose loss must fall; then each
backward kernel's ms at the training shapes (``TRAIN_TIMED``: Zamba2's,
mamba2-130m's, and attention at moonshot's 16 heads of 128) beside its
bound (3xTF32 tensor cores for attention and SSD), plain version and
library call (SDPA forward plus backward, ``F.conv1d``'s backward), SDPA's
backward alone and the port's forward with its log-sum-exp plus backward,
the profiler's split of each call into its launches and ptxas's registers
and spills of each instance (``cuobjdump``'s HMMA count of each kernel in
the ``build_lm`` row), and the attention forward with and without its
log-sum-exp, in turns. On the card the attention and SSD backward are also
held within ``TRAIN_TC_LIMIT`` of their plain versions. ``python3
chip_smoke.py --train-kernels`` runs the training kernels' build, checks and
times alone; ``python3 chip_smoke.py --bwd-probes`` holds a 1xTF32 control
of the attention and SSD backward to the same checks and times variants of
the SSD chunk kernel with one part taken out; ``python3 chip_smoke.py --conv1d
[--against DIR]`` checks and times the conv1d kernels alone, of this checkout
and another in turns. The LM kernels' time rows carry, beside the events
around one call (``ms``), the profiler's device ms, the events over 20
back-to-back calls and the wrapper's host µs (``call_times``): one call
under ~0.1 ms reads the host. The paper's two coupled solvers follow
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

The LM kernels with bf16 inputs (``lm_bf16_phase``, after the f32 training
phases, the card freed between): every source also builds a bf16 instance
(``build.instance``), which converts each storage value on load, runs the
f32 instance's arithmetic and rounds once on store. Every forward case of
``lm_kernel_cases`` and every backward case of ``TRAIN_CASE_SHAPES`` at bf16
(``check_lm_bf16``) must be bitwise the f32 instance on the upcast inputs,
rounded, and within its f32 tolerance of the plain version at bf16 plus one
bf16 ulp; Zamba2-1.2B served at bf16 (``main_path_lm_bf16``, batch 4, a
1024-position prompt, 16 tokens: cold and warm prefill ms, decode tok/s,
peak GB, launches 38 / 38 / 6; the logits held on a second prompt too) and
trained at bf16 (``main_path_train_bf16``,
``TRAIN_STEPS`` steps: launches a step, warm ms, tokens/s, peak GB), each on
the kernels, the plain versions and a plain f32 run on the weights upcast
(the control that bounds the stated tolerance); ``times_lm_bf16`` times the
six bf16 instances at Zamba2's shapes beside the f32 instance's device ms,
the bound at bf16 storage bytes and at each product's operand types
(``case_bound``) and the library call at bf16. ``python3
chip_smoke.py --lm-bf16`` runs the LM kernels' checks and these phases
alone; ``python3 chip_smoke.py --lm-against DIR`` holds the f32 instances of
the six LM kernels bitwise to another checkout's (e.g. the parent's) on the
same inputs.

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

Then the simulation server (``repro_torch.serve``). ``check_batched``: the
batched kernel (the sample axis of the generated kernel: one launch a step
for a whole batch; for the serving step the column march of
``kernels/codegen_columns.py``) at B = 16 x 128^3 f32, the serving demo's
diffusion step plain and checked with its ``finite`` guard, with dead
samples and both parities, bitwise to its plain version
(``codegen.evaluate_batch_torch``): every buffer, a dead sample's two
buffers unchanged, each per-sample reduction; then at bf16 and f16 (both
parities), on a ragged 5 x 67 x 45 x 77 grid cut inside its columns at
f32 and bf16, and porosity's and GP's fused updates batched at small
sizes. ``main_path_serve``: a ``SimulationServer`` (``max_batch``
16, chunks of 64 steps, a check every 4) takes a burst of 48 healthy
requests at 128^3 and 8 at 64^3 (two buckets), one ``dt = 5.0`` request,
which must fail with ``SampleQuarantined``, and one hopeless deadline,
which must fail with ``DeadlineExceeded``; every healthy result (fields,
error, iterations) must equal its solo ``solve_until`` on the card and the
batched plain version bitwise; one chunk runs under
``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a chunk;
one state read a chunk); a ``ProcessWorkerPool`` of 2 worker processes on
the card, each first one killed after 2 requests, serves 8 spooled 128^3
requests, each bitwise to its solo solve, and must count a respawn.
``times_serve``: each batched kernel's ms per launch, the kernel alone,
in turns with its one-cell twin (the layout before the column march) at
B = 16 x 128^3, 1 x 512^3 (beside the solo kernel), 64 x 128^3 and 8 x
64^3, each first held bitwise to its plain version, beside its bound (the
live samples' bytes over 3.35 TB/s) and ptxas's registers; at 16 x 128^3
also through ``run_batch``, its plain version's ms and the same work as
16 single-sample launches; a serving chunk of 64 steps at 16 x 128^3 in
the column march and in the one-cell layout, in turns
(``tune_stencil.serve_chunk``: wall, host enqueue and device ms); and the
burst's wall seconds, requests a second, p50/p99 latency and host syncs a
chunk.

Then the launch autotuner (``main_path_autotune``, ``kernels/autotune.py``):
FIG1 512^3 tuned at f32 over k = 1, 2, 4, all-parallel and marched along
axis 0 (at most AUTOTUNE_CANDIDATES layouts a (k, march), the table's first,
priced by the cost model first), every candidate built together, held
bitwise to k single steps of the table layout and timed, the winner cached
in a fresh file under ``build/``; the tuner again must hit its memory cache
and, with that cleared, its file, launching nothing; the winner applied
through ``parallel(tile=)``, ``.marched`` and ``run_steps`` for 96 steps,
bitwise to the table layout's 96 steps, both timed in turns, and its
``stencil_roofline`` record (a fraction above 1.05 fails); a second f32
search pruned at the ratio that keeps the first's winner (the priced-out
candidates untimed, its winner the first's or within 3% of it); then FIG1
tuned at bf16, one step a launch, into an entry of its own. Its rows in the
kernels line are the two winners beside the ``torch`` backend.

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
# with bf16 storage: a product of two bf16 values is exact at the bf16 rate
# (989 TFLOP/s dense, f32 accumulation); a bf16 value times an f32 one takes
# two TF32 products (the f32 operand's hi and lo parts; bf16 is exact in TF32)
PEAK_BF16_PER_S = 989e12
PEAK_2XTF32_PER_S = 495e12 / 2
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
# k above the kernel's MAX_STEPS: launches of at most MAX_STEPS, chained
HAND_CHAINED_KS = (5, 9)

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
# (rtol, atol) of each LM kernel against its plain version, f32: conv1d
# bitwise (it sums its taps in the plain version's order, each multiply and
# add rounded on its own, and its SiLU's expf and division gave PyTorch's
# sigmoid bit for bit on the card at every case); attention's online softmax
# over key tiles rounds otherwise than
# one softmax per row, and each 3xTF32 product is about 2^-21 relative off;
# the SSD kernel sums its 3xTF32 products in another order, over 64-step
# chunks where the plain version's pick_chunk may take 1-step ones.
LM_TOL = {"conv1d": (0.0, 0.0), "ssd": (1e-4, 1e-4), "attention": (1e-5, 1e-5)}
# Prefill logits (O(1) for these random weights) of the kernels against the
# plain versions after 38 Mamba2 layers and 6 shared-block applications,
# each a few f32 roundings apart.
LOGITS_TOL = (1e-3, 1e-3)
# main_path_lm_families: the dense, MoE, VLM, enc-dec and SSM stacks at their
# published widths, each served at batch 4 with a 1024-position prompt (a
# VLM's 576 patch embeddings + 448 tokens; an enc-dec's 1024 frames + 1024
# tokens) and 16 generated tokens, on the kernels and then on the plain
# versions with the same weights and prompt. The depth cuts (overrides) keep
# the f32 weights on one 80 GB card: qwen3-32b whole is 131 GB, moonshot
# 112 GB. Each entry: (overrides, the kernels' launches a request, exactly;
# attention's split by mode where it has two).
LM_FAMILIES = {
    "stablelm-3b": ({}, {"attention": 32, "conv1d": 0, "ssd": 0}),
    "qwen3-32b": ({"n_layers": 8}, {"attention": 8, "conv1d": 0, "ssd": 0}),
    "moonshot-v1-16b-a3b": ({"n_layers": 8}, {"attention": 8, "conv1d": 0, "ssd": 0}),
    "phi-3-vision-4.2b": ({}, {"attention": 32, "conv1d": 0, "ssd": 0}),
    "seamless-m4t-medium": ({}, {"attention": 24, "conv1d": 0, "ssd": 0,
                                 "attention:noncausal": 12, "attention:causal": 12}),
    "mamba2-130m": ({}, {"attention": 0, "conv1d": 24, "ssd": 24}),
}
LM_FAMILY_SERVE = dict(batch=4, prompt_len=1024, gen_len=16)
LM_FAMILIES_BUDGET_S = 150.0
# the kernel cases at each family's prefill shapes: case label -> (arch, the
# launch count of that family's run that counts them)
LM_FAMILY_CASES = {
    "attention_stablelm": ("stablelm-3b", "attention"),
    "attention_qwen3": ("qwen3-32b", "attention"),
    "attention_moonshot": ("moonshot-v1-16b-a3b", "attention"),
    "attention_phi3": ("phi-3-vision-4.2b", "attention"),
    "attention_seamless_enc": ("seamless-m4t-medium", "attention:noncausal"),
    "attention_seamless_dec": ("seamless-m4t-medium", "attention:causal"),
    "conv1d_mamba2": ("mamba2-130m", "conv1d"),
    "ssd_mamba2": ("mamba2-130m", "ssd"),
}


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
    # the simulation server's kernels: the batched ones and their solo twins
    from repro_torch.serve.procworker import demo_kernel
    serve_kern, serve_plain = demo_kernel("cuda"), demo_kernel("cuda", backend="torch")
    calls_serve = serve_sources(torch, serve_kern, coupled)
    t0 = time.perf_counter()
    lm_sources = lm_instances()      # the six LM sources, each at f32 and at bf16
    sources = ([("diffusion3d", build.read_source(diffusion3d.SOURCE))]
               + lm_sources
               + [(c.lib_name, c.source) for c in calls]
               + [(c.lib_name, c.source) for c in calls_k.values()]
               + [(c.lib_name, c.source) for c in calls_mixed.values()]
               + [(c.lib_name, c.source) for c in calls_march]
               + [(c.lib_name, c.source) for c in calls_cells]
               + [(c.lib_name, c.source) for c in calls_serve])
    builds = build.compile_many(sources)
    # each instance of the LM kernels (forward and backward, f32 and bf16), by
    # library name
    lm_builds = builds[1:1 + len(lm_sources)]
    lm_ptx = {b.name: ptxas_by_function(b.log) for b in lm_builds}
    emit({"phase": "build_lm", "ptxas": lm_ptx,
          "hmma": {b.name: sass_hmma(b.library) for b in lm_builds},
          "seconds": {b.name: b.seconds for b in lm_builds}})
    serve_ptx = {src: ptxas_summary(b.log)
                 for b, (_, src) in zip(builds[-len(calls_serve):], sources[-len(calls_serve):])}
    builds, sources = builds[:-len(calls_serve)], sources[:-len(calls_serve)]
    require(all(not p["spills"] for p in serve_ptx.values()),
            f"ptxas spills registers in a serving kernel: "
            f"{ {c.label: serve_ptx[c.source] for c in calls_serve} }")
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
    err_at.update(check_lm_cases(torch, lm_cases))

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
    err_at.update(check_hand_steps(torch, STEPS_FULL["fig1"], cgen, ks=HAND_CHAINED_KS))
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
    # the dense, MoE, VLM, enc-dec and SSM stacks at their published widths
    families = lm_families_main_path(torch, dev)
    torch.cuda.empty_cache()

    # ---- 4b'. LM training: the backward kernels, Zamba2-1.2B trained, train_lm --
    t_train = time.perf_counter()
    train_cases, train_err = check_train_kernels(
        torch, dev, torch.Generator(device="cpu").manual_seed(20261018))
    train_run = train_main_path(torch, dev)
    torch.cuda.empty_cache()
    train_lm_main_path(torch, dev)
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t_train

    # ---- 4b''. bf16 storage in the LM kernels: the cases, Zamba2 served and
    # trained at bf16 (the card freed after the f32 phases; times at 5b)
    lm16, train16, err16 = lm_bf16_phase(torch, dev, lm_cases, train_cases)
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

    # ---- 4i. the simulation server: batched ensemble solves ---------------------------
    err_at["serve"] = serve_kernel_checks(torch, serve_kern, coupled)
    serve_run = serve_main_path(torch, spec, serve_kern, serve_plain)
    torch.cuda.empty_cache()

    # ---- 4j. the launch autotuner: FIG1 tuned, both caches hit, the winner applied ---
    tuned = autotune_main_path(torch, spec)
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
    lm_times = {case["name"]: lm_case_times(torch, teff, case)
                for label, case in lm_cases.items() if label.endswith("zamba2")}
    emit({"phase": "times_lm", "card": spec.name, "power_limit": spec.power_limit,
          "shapes": {c["name"]: c["shape"] for k, c in lm_cases.items() if k.endswith("zamba2")},
          "launches_per_request": lm_counts, "kernels": lm_times,
          "prefill_ms": lm["prefill_ms"], "decode_tok_per_s": lm["decode_tok_per_s"]})
    family_times = {}
    for label, (arch, counter) in LM_FAMILY_CASES.items():
        t = family_times[label] = lm_case_times(torch, teff, lm_cases[label])
        t.update(arch=arch, shape=lm_cases[label]["shape"],
                 launches_per_request=families[arch]["launches"][counter])
    emit({"phase": "times_lm_families", "card": spec.name, "power_limit": spec.power_limit,
          "kernels": family_times,
          "serving": {a: {k: r[k] for k in ("prefill_ms", "decode_tok_per_s", "peak_gb")}
                      for a, r in families.items()}})
    t_train = time.perf_counter()
    train_t = times_train(torch, teff, train_cases, spec, dev,
                          torch.Generator(device="cpu").manual_seed(20261019), train_run,
                          lm_ptx)
    train_s += time.perf_counter() - t_train
    emit({"phase": "train_wall", "wall_s": train_s, "budget_s": TRAIN_BUDGET_S})
    require(train_s <= TRAIN_BUDGET_S,
            f"the training phases took {train_s:.1f} s, over {TRAIN_BUDGET_S} s")
    times16 = times_lm_bf16(torch, teff, spec, lm_cases, train_cases, lm_ptx, lm16, train16)
    del lm_cases, train_cases

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

    # ---- 5g. times of the batched kernels and of the burst ------------------------
    serve_t, serve_split = serve_times(torch, spec, serve_kern, serve_plain, serve_ptx)
    from repro_torch.launch.tune_stencil import serve_chunk
    chunk = serve_chunk()
    require(all("/col" in lay for lay in chunk["column"]["layouts"].values())
            and not any("/col" in lay for lay in chunk["one_cell"]["layouts"].values()),
            f"the serving chunk's layouts are not the two compared: {chunk}")
    emit({"phase": "times_serve", "card": spec.name, "power_limit": spec.power_limit,
          "shape": [SERVE_POLICY["max_batch"], SERVE_N, SERVE_N, SERVE_N], "kernels": serve_t,
          "split": serve_split, "chunk": chunk,
          "burst": {k: serve_run[k] for k in ("healthy", "wall_s", "requests_per_s", "p50_s",
                                              "p99_s", "chunks", "host_syncs_per_chunk")}})

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
                                                "bound_f32_cuda_cores_ms", "library_ms",
                                                "device_ms", "event_ms_inner", "host_us")}}
                for k, rep in lm_rows]
    kernels += [{"name": f"{k}_bwd", "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{k}_bwd.cu", "replaces": rep,
                 "role": "backward (the TPU kernel has none; the reference differentiates "
                         "its chunked jnp twin)",
                 "launches": train_run["launches"][f"{k}_bwd"], "max_abs_err": train_err[k],
                 **{x: train_t["kernels"][f"{k}_zamba2"][x]
                    for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "bound_f32_cuda_cores_ms", "library_ms", "device_ms",
                              "event_ms_inner", "host_us")}}
                for k, rep in lm_rows]
    kernels += [{"name": f"{label.split('_')[0]}[{label.split('_', 1)[1]}]", "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{label.split('_')[0]}.cu",
                 "replaces": dict(lm_rows)[label.split("_")[0]],
                 "launches": t["launches_per_request"], "max_abs_err": err_at[label],
                 **{x: t[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "bound_f32_cuda_cores_ms", "library_ms", "device_ms",
                                      "event_ms_inner", "host_us")}}
                for label, t in family_times.items()]
    kernels += lm_bf16_rows(lm16, train16, times16, err16)
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
    kernels += [{"name": k, "route": "cuda",
                 "source": ("src/repro_torch/kernels/codegen_columns.py" if "/col" in t["layout"]
                            else gen_src),
                 "replaces": "src/repro/kernels/stencil.py:1052",
                 "launches": serve_run["launches"][k], "max_abs_err": err_at["serve"],
                 **{x: t[x] for x in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                      "singles_ms", "layout", "one_cell_ms",
                                      "one_cell_call_ms")},
                 "library_ms": None}
                for k, t in serve_t.items()]
    kernels += autotune_rows(torch, tuned)
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


def lm_instances() -> list:
    """(library name, source text) of each LM source (forward and backward
    of conv1d, SSD and attention) at each storage dtype: the f32 instances,
    then the bf16 ones (``build.instance``)."""
    from repro_torch.kernels import attention, build, conv1d, ssd

    mods = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    return [build.instance(f"{n}{part}", getattr(m, src), b) for b in (False, True)
            for part, src in (("", "SOURCE"), ("_bwd", "BWD_SOURCE")) for n, m in mods.items()]


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


def check_lm_cases(torch, lm_cases) -> dict:
    """Each forward case of lm_kernel_cases against its plain version
    (LM_TOL); every case is checked and printed before any fails. Returns
    the max abs error at Zamba2's shape by kernel and at each family's by
    case label."""
    err_at, failures = {}, []
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
        failures += [f"{kernel} ({label}): {part} outside rtol {rtol}, atol {atol}: "
                     f"{row[part]}" for part in case["parts"] if not row[part]["ok"]]
        if label.endswith("zamba2"):
            err_at[kernel] = max(row[part]["max_abs_err"] for part in case["parts"])
        if label in LM_FAMILY_CASES:
            err_at[label] = max(row[part]["max_abs_err"] for part in case["parts"])
        del got, want
    require(not failures, "; ".join(failures))
    return err_at


def lm_case_times(torch, teff, case) -> dict:
    """One LM kernel case timed (CUDA events around one call, median of 20:
    ``ms``; and ``call_times``' device ms, event ms over back-to-back calls
    and host µs) beside its plain version and its library call, with its
    bound: at the rate of the units the kernel runs its products on
    (attention, SSD: 3xTF32 tensor cores; conv1d: f32 CUDA cores), the f32
    CUDA-core bound beside it."""
    t = {"ms": teff.measure(case["kernel"], iters=20, warmup=3).median_s * 1e3,
         **call_times(torch, teff, case["kernel"]),
         "plain_ms": teff.measure(case["plain"], iters=20, warmup=3).median_s * 1e3,
         "library_ms": (teff.measure(case["library"], iters=20, warmup=3).median_s * 1e3
                        if case["library"] else None),
         "bytes": case["bytes"], "flops": case["flops"], **case_bound(case)}
    t["device_share_of_bound"] = t["bound_ms"] / t["device_ms"]
    t["library"] = case["library_name"]
    return t


class RouteLog:
    """Records every MoE routing of a run: the sorted expert choices of each
    token and the smallest gap between the k-th and (k+1)-th gate
    probability, by wrapping ``models.moe.route`` while the block is open
    (``moe_apply`` calls it by its module name)."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route = route = self.moe.route

        def recorded(p, xt, k):
            probs, ranked, idx = route(p, xt, k)
            self.calls.append((idx.sort(-1).values, (ranked[:, k - 1] - ranked[:, k]).min()))
            return probs, ranked, idx

        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def min_gap(self, n) -> float:
        return min(float(g) for _, g in self.calls[:n])

    def differ(self, other, n) -> int:
        """(token, layer) choices of the first ``n`` calls that differ."""
        return sum(int((a != b).any(-1).sum()) for (a, _), (b, _)
                   in zip(self.calls[:n], other.calls[:n]))


def lm_families_main_path(torch, dev, smoke: bool = False, serve_kw=LM_FAMILY_SERVE,
                          families=LM_FAMILIES, budget_s=LM_FAMILIES_BUDGET_S) -> dict:
    """Serve each config of ``families`` through ``repro_torch.launch.serve``
    (cut with its overrides), on the kernels (the launch counts set to 0
    just before, read just after), then on the plain versions with the same
    weights and prompt; check and free each model before the next. Every
    config is served and printed before a failure is raised."""
    import gc

    from repro_torch import configs
    from repro_torch.kernels import attention, conv1d, ssd
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import RunConfig, build as build_model, moe, synth_batch

    lm_kernels = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    scfg = lm_serve.ServeConfig(**serve_kw)
    plain_rc = RunConfig(param_dtype="float32", attn_impl="ref", ssd_impl="ref",
                         conv_impl="ref")
    on_card = dev.type == "cuda"
    out, failures = {}, []
    t_phase = time.perf_counter()
    for arch, (overrides, want) in families.items():
        t0 = time.perf_counter()
        base = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
        cfg = configs.apply_overrides(base, overrides)
        model = build_model(cfg, RunConfig(param_dtype="float32"), dev)
        params = model.init(torch.Generator(device=dev).manual_seed(scfg.seed))
        batch = synth_batch(model, torch.Generator(device=dev).manual_seed(scfg.seed + 1),
                            scfg.prompt_len, scfg.batch)
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        n_params = sum(t.numel() for t in flat_tensors(params))
        kw = dict(smoke=smoke, device=dev, params=params, tokens=batch["tokens"],
                  extras=extras, overrides=overrides, log_fn=lambda *a: None)
        logs = [RouteLog(moe), RouteLog(moe)]
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        for m in lm_kernels.values():
            m.launches = 0
        attention.launches_by_mode.clear()
        with logs[0]:
            toks, info = lm_serve.serve(arch, scfg, **kw)
        counts = {n: m.launches for n, m in lm_kernels.items()}
        counts.update({f"attention:{k}": v for k, v in attention.launches_by_mode.items()})
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        with logs[1]:
            toks_ref, info_ref = lm_serve.serve(arch, scfg, rc=plain_rc, **kw)
        plain_peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
        logits, logits_ref = info["prefill_logits"], info_ref["prefill_logits"]
        row = {"phase": "main_path_lm_families", "arch": arch, "family": cfg.family,
               "smoke": smoke, "overrides": overrides, "serve": serve_kw,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "prompt": {k: list(v.shape) for k, v in batch.items()},
               "params": n_params, "param_count": cfg.param_count(),
               "weight_gb": n_params * 4 / 1e9, "peak_gb": peak, "plain_peak_gb": plain_peak,
               "launches": counts, "prefill_ms": info["t_prefill_s"] * 1e3,
               "decode_tok_per_s": info["tok_per_s"],
               "plain_prefill_ms": info_ref["t_prefill_s"] * 1e3,
               "plain_decode_tok_per_s": info_ref["tok_per_s"],
               "logits": {"shape": list(logits.shape),
                          "finite": bool(torch.isfinite(logits).all()),
                          "min": float(logits.min()), "max": float(logits.max()),
                          "vs_plain": close_report(torch, logits, logits_ref, *LOGITS_TOL),
                          "rtol": LOGITS_TOL[0], "atol": LOGITS_TOL[1]},
               "tokens": {"agree_with_plain": int((toks == toks_ref).sum()),
                          "of": int(toks.size), "first_row": toks[0].tolist()}}
        if cfg.is_moe:
            row["routing"] = {"prefill_choices_differ": logs[0].differ(logs[1], cfg.n_layers),
                              "of": cfg.n_layers * scfg.batch * scfg.prompt_len,
                              "min_gap_k_to_k1": min(logs[0].min_gap(cfg.n_layers),
                                                     logs[1].min_gap(cfg.n_layers)),
                              "calls": [len(logs[0].calls), len(logs[1].calls)]}
        row["wall_s"] = time.perf_counter() - t0
        emit(row)
        out[arch] = row
        if not (row["logits"]["finite"] and list(logits.shape) == [scfg.batch, cfg.vocab]):
            failures.append(f"{arch}: prefill logits not finite or of the wrong shape")
        if not (toks.shape == (scfg.batch, scfg.gen_len) and 0 <= toks.min()
                and toks.max() < cfg.vocab):
            failures.append(f"{arch}: generated tokens out of range")
        if not row["logits"]["vs_plain"]["ok"]:
            failures.append(f"{arch}: prefill logits of the kernels and the plain versions "
                            f"differ: {row['logits']}")
        if on_card and not smoke and {k: counts.get(k, 0) for k in want} != want:
            failures.append(f"{arch}: launches {counts}, want {want}")
        del model, params, batch, extras, kw, logs, logits, logits_ref, info, info_ref
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    emit({"phase": "main_path_lm_families_wall", "wall_s": wall, "budget_s": budget_s,
          "configs": list(families)})
    if on_card and wall > budget_s:
        failures.append(f"main_path_lm_families took {wall:.1f} s, over {budget_s} s")
    require(not failures, "; ".join(failures))
    return out


# conv1d's forward cases: (B, L, C, K, silu, bias, offset): Zamba2's and
# mamba2-130m's prefill shapes, and the tile edges: C not a multiple of 4
# (4-byte loads), L not a multiple of the positions a block covers, L < K,
# K = 1 and 8 (the ends of the tiled kernel's instances) and 9 (the generic
# kernel), no bias, no SiLU, and x one f32 off its allocation's start (an
# offset view: 4-byte loads)
LM_CONV1D_CASES = {"odd": (2, 70, 300, 3, True, True, False),
                   "C301": (2, 70, 301, 4, True, True, False),
                   "L37": (3, 37, 256, 4, True, True, False),
                   "L2_K4": (2, 2, 132, 4, True, True, False),
                   "K1_nobias": (1, 50, 260, 1, True, False, False),
                   "K8_nosilu": (1, 150, 264, 8, False, True, False),
                   "K9": (1, 50, 264, 9, True, True, False),
                   "offset": (2, 70, 300, 4, True, True, True),
                   "zamba2": (4, 1024, 4224, 4, True, True, False),
                   "mamba2": (4, 1024, 1792, 4, True, True, False)}


def on_storage(case: dict, kernel: bool = True) -> dict:
    """A case with its ``plain`` and ``library`` calls (and ``kernel``,
    unless the case calls its kernel on inputs of its own): ``run_plain``,
    ``run_library`` and ``run`` on the case's storage inputs. A backward
    ``run`` returns (gradients, aux); ``kernel`` the gradients."""
    s, run = case["storage"], case["run"]
    case["plain"] = lambda: case["run_plain"](**s)
    lib = case["run_library"]
    case["library"] = (lambda: lib(**s)) if lib else None
    if kernel:
        case["kernel"] = ((lambda: run(**s)[0]) if case.get("backward") else
                          (lambda: run(**s)))
    return case


def products(storage: int, mixed: int) -> dict:
    """A tensor-core case's operations: ``flops`` in all, and ``products``
    by operand types at bf16 storage (``storage``: both operands storage
    values; ``mixed``: one an f32 value). At f32 storage all are f32."""
    return {"flops": storage + mixed, "tensor_cores": True,
            "products": {"storage": storage, "mixed": mixed}}


def case_bound(case, byts=None, bf16=False) -> dict:
    """A case's least time, the larger of its bytes (``byts``, else the
    case's f32 count) over the memory rate and its operations over the peak
    rate of their operand types: conv1d's on the f32 CUDA cores; a
    tensor-core case's products at 3xTF32 at f32 storage, and at bf16
    storage (``bf16``) each at its operands' rate (``products``). The bound
    on the f32 CUDA cores beside it, and at bf16 the one at 3xTF32."""
    by_bytes = (case["bytes"] if byts is None else byts) / PEAK_BYTES_PER_S
    by_f32 = case["flops"] / PEAK_F32_PER_S
    by_3x = case["flops"] / PEAK_3XTF32_PER_S
    if not case["tensor_cores"]:
        by_ops, rate = by_f32, "f32 CUDA cores"
    elif bf16:
        p = case["products"]
        by_ops = p["storage"] / PEAK_BF16_PER_S + p["mixed"] / PEAK_2XTF32_PER_S
        rate = "bf16 tensor cores (bf16 x bf16), 2xTF32 (bf16 x f32)"
    else:
        by_ops, rate = by_3x, "3xTF32 tensor cores"
    out = {"bound_ms": max(by_bytes, by_ops) * 1e3,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations", "bound_rate": rate,
           "bound_f32_cuda_cores_ms": max(by_bytes, by_f32) * 1e3}
    if bf16 and case["tensor_cores"]:
        out["bound_3xtf32_ms"] = max(by_bytes, by_3x) * 1e3
    return out


def conv1d_case(torch, randn, B, L, C, K, silu=True, bias=True, offset=False) -> dict:
    """One forward case of lm_kernel_cases: inputs from ``randn``, the
    kernel, its plain version, ``F.conv1d``, bytes and operations."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d

    x, w = randn(B, L, C), randn(K, C, scale=K ** -0.5)
    b = randn(C, scale=0.1) if bias else None
    x = off_word(torch, x) if offset else x
    return on_storage({
        "name": "conv1d", "parts": ["out"],
        "shape": {"x": [B, L, C], "K": K, "silu": silu, "bias": bias, "offset": offset},
        # the storage inputs by name, and the kernel, the plain version and
        # the library call on any such inputs (bf16 ones: storage_inputs)
        "storage": {"x": x, "w": w, **({"b": b} if bias else {})}, "offset": ("x",) * offset,
        "run": lambda x, w, b=None: (conv1d.conv1d_causal(x, w, b, silu=silu),),
        "run_plain": lambda x, w, b=None: (conv1d.plain(x, w, b, silu=silu),),
        "library_name": "F.conv1d(groups=C, padding=K-1) + SiLU (cuDNN, TF32 off)",
        "run_library": lambda x, w, b=None: F.silu(F.conv1d(
            x.transpose(1, 2), w.flip(0).t()[:, None, :], b, padding=K - 1,
            groups=C)[..., :L]).transpose(1, 2),
        "bytes": 4 * (2 * B * L * C + K * C + C), "flops": B * L * C * (2 * K + 5),
        "tensor_cores": False})


def lm_kernel_cases(torch, dev, gen, others=True):
    """Inputs, kernel, plain version, library call, bytes and operations of
    each LM kernel, at small shapes on the kernels' tile edges, at the
    Zamba2 prefill shape and at each other family's (LM_FAMILY_CASES);
    without ``others`` only conv1d's."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention, ref, ssd

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = {f"conv1d_{label}": conv1d_case(torch, randn, *shape)
             for label, shape in LM_CONV1D_CASES.items()}
    if not others:
        return cases
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
            "zamba2": (4, 1024, 64, 64, 1, 64, 64, False),
            "mamba2": (4, 1024, 24, 64, 1, 128, 64, False)}.items():
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
        cases[f"ssd_{label}"] = on_storage({
            "name": "ssd", "parts": ["y", "h_final"],
            "shape": {"x": [B, L, H, P], "G": G, "N": N, "chunk": cs, "kernel_chunk": kcs,
                      "h0": with_h0},
            "storage": {"x": x, "Bm": Bm, "Cm": Cm},
            "run": lambda x, Bm, Cm, f=(dt, A, D, h0), c=chunk:
                ssd.ssd_chunk_scan(x, f[0], f[1], Bm, Cm, D=f[2], h0=f[3], chunk=c),
            "run_plain": lambda x, Bm, Cm, f=(dt, A, D, h0), cs=cs:
                ref.ssd(x, f[0], f[1], Bm, Cm, D=f[2], h0=f[3], chunk=cs),
            "library_name": None, "run_library": None,
            # x, dt, A, B, C, D (and h0) read once; y and the final state written once
            "bytes": 4 * (2 * B * L * H * P + B * L * H + 2 * H + 2 * B * L * G * N
                          + (2 if with_h0 else 1) * B * H * P * N),
            # per kernel chunk of r steps: C·Bᵀ over the causal triangle per
            # (b, group), of two storage operands; per (b, h) W·x over the
            # triangle, C·h and the state update over (r, P, N), each with
            # one f32 operand (W, h, the decayed x)
            **products(storage=B * G * sum(r * (r + 1) * N for r in rows),
                       mixed=B * H * sum(r * (r + 1) * P + 4 * r * P * N for r in rows))})
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
            "zamba2": (4, 32, 32, 1024, 64, True, None),
            # the other families' prefill shapes (head dims 80, 96, 128; GQA
            # rep 8; the enc-dec's non-causal encoder and causal decoder)
            "stablelm": (4, 32, 32, 1024, 80, True, None),
            "qwen3": (4, 64, 8, 1024, 128, True, None),
            "moonshot": (4, 16, 16, 1024, 128, True, None),
            "phi3": (4, 32, 32, 1024, 96, True, None),
            "seamless_enc": (4, 16, 16, 1024, 64, False, None),
            "seamless_dec": (4, 16, 16, 1024, 64, True, None)}.items():
        q, k, v = randn(B, Hq, L, D), randn(B, Hkv, L, D), randn(B, Hkv, L, D)
        i = torch.arange(L)
        allowed = torch.ones(L, L, dtype=torch.bool)
        if causal:
            allowed &= i[None, :] <= i[:, None]
        if window is not None:
            allowed &= i[None, :] > i[:, None] - window
        pairs = int(allowed.sum())
        cases[f"attention_{label}"] = on_storage({
            "name": "attention", "parts": ["out"],
            "shape": {"q": [B, Hq, L, D], "Hkv": Hkv, "causal": causal, "window": window},
            "storage": {"q": q, "k": k, "v": v},
            "run": lambda q, k, v, c=causal, wd=window:
                (attention.flash_attention(q, k, v, causal=c, window=wd),),
            "run_plain": lambda q, k, v, c=causal, wd=window:
                (ref.attention(q, k, v, causal=c, window=wd),),
            "library_name": f"F.scaled_dot_product_attention(is_causal={causal}"
                            + (", enable_gqa=True)" if Hq != Hkv else ")"),
            "run_library": (lambda q, k, v, c=causal, g=Hq != Hkv:
                            F.scaled_dot_product_attention(q, k, v, is_causal=c, enable_gqa=g))
            if window is None else None,
            "bytes": 4 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D),
            # per allowed (b, q head, i, j): q·k (two storage operands) and
            # p·v (p f32)
            **products(storage=2 * B * Hq * D * pairs, mixed=2 * B * Hq * D * pairs)})
    return cases


# train_kernel_cases: each backward kernel against autograd.grad of its plain
# version. (rtol, atol relative to the largest gradient of the case, over all
# its parts: a part that is 0 in exact arithmetic, as dq and dk of a row
# that sees only its own key, comes out a few ulp of the case's scale off 0
# through the forward's log-sum-exp): conv1d
# sums dw and dbias over B x L = 4096 terms in another order than autograd;
# attention recomputes p from the forward kernel's 3xTF32 log-sum-exp and
# sums its products in tiles; the SSD backward sums its chunks' products in
# another order than the plain version's chunked algebra, and its dla is a
# suffix sum (in double) of differences over up to 1024 steps.
TRAIN_TOL = {"conv1d": (1e-4, 1e-5), "ssd": (1e-3, 1e-4), "attention": (1e-3, 1e-4)}
# On the card, besides TRAIN_TOL: the largest |error| of any part of a case
# over the case's largest gradient, for the backward kernels whose products
# run on the tensor cores. At the TRAIN_CASE_SHAPES cases 3xTF32 came within
# 3.0e-6 of it and a single TF32 product a step (the 1xTF32 control of
# ``python3 chip_smoke.py --bwd-probes``) 2.1e-4 to 1.1e-3 off (PERF.md
# §6): TRAIN_TOL's atol (1e-4 of it) rejects the control by as little as
# 2x, this limit by 10x.
TRAIN_TC_LIMIT = {"ssd": 2e-5, "attention": 2e-5}
TRAIN_KERNELS = ("conv1d_bwd", "ssd_bwd", "attention_bwd")
TRAIN_CASE_SHAPES = {
    # (B, L, C, K, silu[, bias, offset]): as LM_CONV1D_CASES's tile edges
    # (K up to 8, the backward's largest)
    "conv1d": {"odd": (2, 70, 300, 3, True), "zamba2": (4, 1024, 4224, 4, True),
               "zamba2_nosilu": (4, 1024, 4224, 4, False),
               "mamba2": (4, 128, 1792, 4, True),
               "C301": (2, 70, 301, 4, True), "L37": (3, 37, 256, 4, True),
               "L2_K4": (2, 2, 132, 4, True), "K1_nobias": (1, 50, 260, 1, True, False, False),
               "K8": (1, 150, 264, 8, True), "offset": (2, 70, 300, 4, True, True, True)},
    # (B, L, H, P, G, N, chunk, h0, dh_final)
    "ssd": {"P6_N10_h0_dhf": (1, 40, 2, 6, 1, 10, 16, True, True),
            "L1000_G2_h0_dhf": (1, 1000, 8, 64, 2, 64, 64, True, True),
            "L100_N128_G2": (2, 100, 4, 36, 2, 128, 64, False, False),
            "L65_N17_h0": (1, 65, 4, 16, 4, 17, 32, True, False),
            "zamba2": (4, 1024, 64, 64, 1, 64, 64, False, False),
            "mamba2": (4, 128, 24, 64, 1, 128, 64, False, False)},
    # (B, Hq, Hkv, L, D, causal, window)
    "attention": {"L1_rep2": (1, 4, 2, 1, 64, True, None),
                  "L63_rep4_D128_w37": (1, 8, 2, 63, 128, True, 37),
                  "L65_D16_noncausal": (2, 4, 4, 65, 16, False, None),
                  "L65_w0": (1, 2, 2, 65, 64, True, 0),
                  "L1024_D80_rep2_w256": (1, 4, 2, 1024, 80, True, 256),
                  "L1024_D128_rep4_noncausal": (1, 8, 2, 1024, 128, False, None),
                  "zamba2": (4, 32, 32, 1024, 64, True, None),
                  # moonshot's 16 heads of 128: the registers bite at D = 128
                  "moonshot": (4, 16, 16, 1024, 128, True, None)},
}
# the cases times_train times (label endings)
TRAIN_TIMED = ("zamba2", "mamba2", "moonshot")


def grad_report(torch, got, want, rtol, atol_rel, scale) -> dict:
    """``close_report`` with atol ``atol_rel`` times ``scale`` (the case's
    largest |gradient|)."""
    rep = close_report(torch, got, want, rtol, atol_rel * scale)
    rep["max_abs_want"] = float(want.abs().max()) if want.numel() else 0.0
    rep["finite"] = bool(torch.isfinite(got).all())
    rep["ok"] = rep["ok"] and rep["finite"]
    return rep


def conv1d_bwd_case(torch, randn, B, L, C, K, silu, bias=True, offset=False) -> dict:
    """One conv1d case of train_kernel_cases: inputs from ``randn`` (x and g
    one f32 off their allocations' start with ``offset``), the backward
    kernel, autograd.grad of the plain forward, F.conv1d's backward, bytes
    and operations."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d, ref

    x, w = randn(B, L, C), randn(K, C, scale=K ** -0.5)
    b = randn(C, scale=0.1) if bias else None
    g = randn(B, L, C)
    if offset:
        x, g = off_word(torch, x), off_word(torch, g)

    def library(g, x, w, b=None):
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b) if t is not None]
        out = F.conv1d(leaves[0].transpose(1, 2), leaves[1].flip(0).t()[:, None, :],
                       leaves[2] if bias else None, padding=K - 1,
                       groups=C)[..., :L].transpose(1, 2)
        out = F.silu(out) if silu else out
        return torch.autograd.grad(out, leaves, g)

    return on_storage({
        "name": "conv1d", "parts": ["dx", "dw", "db"] if bias else ["dx", "dw"],
        "shape": {"x": [B, L, C], "K": K, "silu": silu, "bias": bias, "offset": offset},
        "backward": True,
        "storage": {"g": g, "x": x, "w": w, **({"b": b} if bias else {})},
        "offset": ("g", "x") * offset,
        "run": lambda g, x, w, b=None, aux=None: (
            [t for t in conv1d.conv1d_causal_bwd(g, x, w, b, silu) if t is not None], None),
        "run_plain": lambda g, x, w, b=None: [
            t for t in ref.conv1d_bwd(g, x, w, b, silu) if t is not None],
        "run_library": library,
        "library_name": "autograd.grad of F.conv1d(groups=C) (+ SiLU): the backward "
                        "(cuDNN, TF32 off)",
        "bytes": 4 * (3 * B * L * C + 2 * (K * C + C)),
        "flops": B * L * C * (6 * K + 8), "tensor_cores": False})


def train_kernel_cases(torch, dev, gen, shapes=TRAIN_CASE_SHAPES) -> dict:
    """Inputs, backward kernel, plain backward (autograd.grad through the
    plain forward), library call, bytes and operations of each backward
    kernel at TRAIN_CASE_SHAPES. The forward kernels' outputs the backward
    reads (attention's output and log-sum-exp, SSD's chunk-start states)
    are made once here, so each case calls only its backward kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention, conv1d, ref, ssd

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def pick(grads, names):
        return [grads[n] for n in names]

    cases = {f"conv1d_{label}": conv1d_bwd_case(torch, randn, *shape)
             for label, shape in shapes["conv1d"].items()}
    for label, (B, L, H, P, G, N, chunk, with_h0, with_dhf) in shapes["ssd"].items():
        x = randn(B, L, H, P, scale=0.5)
        u = torch.rand((B, L, H), generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).to(dev)
        A = -(torch.rand((H,), generator=gen) * 15 + 1).to(dev)
        Bm, Cm = randn(B, L, G, N, scale=0.3), randn(B, L, G, N, scale=0.3)
        D = (torch.rand(H, generator=gen) + 0.5).to(dev)
        h0 = randn(B, H, P, N, scale=0.2) if with_h0 else None
        dy = randn(B, L, H, P)
        dhf = randn(B, H, P, N) if with_dhf else None
        _, h_final, states = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk,
                                                return_states=True)
        cs_k, nc = ssd.plan(L, chunk)
        names = ["dx", "ddt", "dA", "dB", "dC", "dD"] + (["dh0"] if with_h0 else [])
        cases[f"ssd_{label}"] = on_storage({
            "name": "ssd", "parts": names,
            "shape": {"x": [B, L, H, P], "G": G, "N": N, "kernel_chunk": cs_k,
                      "plain_chunk": ssd.pick_chunk(L, chunk), "h0": with_h0,
                      "dh_final": with_dhf},
            "kernel": lambda a=(x, dt, A, Bm, Cm, dy), kw=dict(
                D=D, h0=h0, dh_final=dhf, states=states, h_final=h_final, chunk=chunk),
                names=names: pick(ssd.ssd_chunk_scan_bwd(*a, **kw), names),
            "backward": True, "storage": {"x": x, "Bm": Bm, "Cm": Cm, "dy": dy},
            # the forward at the inputs' dtype gives the states (f32, the same
            # at bf16 as at f32 on the upcast inputs), then the backward
            "run": lambda x, Bm, Cm, dy, aux=None, f=(dt, A, D, h0, dhf), c=chunk,
                names=names: ssd_fwd_bwd(ssd, x, Bm, Cm, dy, f, c, names, aux),
            "run_plain": lambda x, Bm, Cm, dy, f=(dt, A, D, h0, dhf),
                c=ssd.pick_chunk(L, chunk), names=names: pick(ref.ssd_bwd(
                    x, f[0], f[1], Bm, Cm, dy, D=f[2], h0=f[3], dh_final=f[4], chunk=c), names),
            "library_name": None, "run_library": None,
            # each once: x, dy, dt, A, B, C, D, the chunk-start states, h0,
            # dh_final and h_final read; dx, ddt, dA, dB, dC, dD and dh0 written
            "bytes": 4 * (3 * B * L * H * P + 2 * B * L * H + 2 * 2 * B * L * G * N
                          + 2 * 2 * H + B * nc * H * P * N
                          + (2 if with_h0 else 0) * B * H * P * N
                          + (2 if with_dhf else 0) * B * H * P * N),
            # per step and state element, the 14 operations of the step
            # recurrence (the fewest the function needs; the chunked algebra
            # the kernel runs does more): h's update (3), y's row sum (2) and
            # dC's column sum (2) forward; G's update (3), G·B's row sum (2)
            # and dB's column sum (2) backward; each has an f32 operand (the
            # state h or G, or the step dt)
            **products(storage=0, mixed=14 * B * L * H * P * N)}, kernel=False)
    for label, (B, Hq, Hkv, L, D, causal, window) in shapes["attention"].items():
        q, k, v = randn(B, Hq, L, D), randn(B, Hkv, L, D), randn(B, Hkv, L, D)
        g = randn(B, Hq, L, D)
        out, lse = attention.flash_attention(q, k, v, causal=causal, window=window,
                                             return_lse=True)
        i = torch.arange(L)
        allowed = torch.ones(L, L, dtype=torch.bool)
        if causal:
            allowed &= i[None, :] <= i[:, None]
        if window is not None:
            allowed &= i[None, :] > i[:, None] - window
        pairs = int(allowed.sum())

        def sdpa_bwd(q=q, k=k, v=v, g=g, c=causal, gqa=Hq != Hkv):
            """SDPA's backward alone: the forward runs here, outside the
            timed calls of the function returned."""
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=c, enable_gqa=gqa)
            return lambda: torch.autograd.grad(o, (qs, ks, vs), g, retain_graph=True)

        def port_fwd_bwd(q=q, k=k, v=v, g=g, c=causal, wd=window):
            o, ls = attention.flash_attention(q, k, v, causal=c, window=wd, return_lse=True)
            return attention.flash_attention_bwd(q, k, v, o, g, ls, causal=c, window=wd)

        cases[f"attention_{label}"] = on_storage({
            "name": "attention", "parts": ["dq", "dk", "dv"],
            "shape": {"q": [B, Hq, L, D], "Hkv": Hkv, "causal": causal, "window": window},
            "kernel": lambda a=(q, k, v, out, g, lse), c=causal, wd=window:
                attention.flash_attention_bwd(*a, causal=c, window=wd),
            "backward": True, "storage": {"q": q, "k": k, "v": v, "g": g},
            # the forward at the inputs' dtype gives (out32, lse), which the
            # f32 instance then takes as they are (aux)
            "run": lambda q, k, v, g, aux=None, c=causal, wd=window:
                attention_fwd_bwd(attention, q, k, v, g, c, wd, aux),
            "run_plain": lambda q, k, v, g, c=causal, wd=window:
                ref.attention_bwd(q, k, v, g, causal=c, window=wd),
            "run_library": (lambda q, k, v, g, c=causal, gqa=Hq != Hkv:
                            sdpa_grad(torch, F, q, k, v, g, c, gqa)) if window is None else None,
            "lse": (lse, lambda q=q, k=k, c=causal, wd=window:
                    ref.attention_lse(q, k, causal=c, window=wd)),
            "library_name": (f"F.scaled_dot_product_attention(is_causal={causal}"
                             + (", enable_gqa=True)" if Hq != Hkv else ")")
                             + ": forward plus backward"),
            "sdpa_bwd": sdpa_bwd if window is None else None,
            "port_fwd_bwd": port_fwd_bwd,
            "bytes": 4 * (4 * B * Hq * L * D + 4 * B * Hkv * L * D + B * Hq * L),
            # per allowed (b, q head, i, j), the five products the function
            # needs: q·k and g·v (two storage operands), dv, dk and dq (p or
            # ds f32; the dQ launch recomputes q·k and g·v: the design's
            # cost, not the function's)
            **products(storage=4 * D * B * Hq * pairs, mixed=6 * D * B * Hq * pairs)},
            kernel=False)
    return cases


def ssd_fwd_bwd(ssd, x, Bm, Cm, dy, f, chunk, names, aux=None):
    """An SSD backward case's kernels on storage inputs: the forward's
    chunk-start states and h_final (``aux``: another call's, as they are),
    then the backward; (gradients, (states, h_final))."""
    dt, A, D, h0, dhf = f
    if aux is None:
        _, h_final, states = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk,
                                                return_states=True)
        aux = (states, h_final)
    grads = ssd.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, D=D, h0=h0, dh_final=dhf,
                                   states=aux[0], h_final=aux[1], chunk=chunk)
    return [grads[n] for n in names], aux


def attention_fwd_bwd(attention, q, k, v, g, causal, window, aux=None):
    """An attention backward case's kernels on storage inputs: the forward's
    f32 output and log-sum-exp (``aux``: another call's, as they are), then
    the backward; (gradients, (out32, lse))."""
    if aux is None:
        _, lse, out32 = attention.flash_attention(q, k, v, causal=causal, window=window,
                                                  return_lse=True, return_out32=True)
        aux = (out32, lse)
    return list(attention.flash_attention_bwd(q, k, v, aux[0], g, aux[1], causal=causal,
                                              window=window)), aux


def sdpa_grad(torch, F, q, k, v, g, causal, gqa):
    """SDPA's forward and backward on (q, k, v) given g."""
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=gqa)
    return torch.autograd.grad(o, (qs, ks, vs), g)


def train_case_report(torch, label, case, on_card) -> tuple[dict, list]:
    """One case of train_kernel_cases: its kernel called twice, held to its
    plain version (TRAIN_TOL, and on the card TRAIN_TC_LIMIT) and to its
    own first call bitwise. Returns (row, failures)."""
    kernel = case["name"]
    got, again, want = ([t for t in case[k]() if t is not None]
                        for k in ("kernel", "kernel", "plain"))
    rtol, atol = TRAIN_TOL[kernel]
    row = {"phase": "train_kernel_cases", "kernel": kernel + "_bwd", "case": label,
           "shape": case["shape"], "rtol": rtol, "atol_rel": atol,
           "bitwise_twice": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
    scale = max(float(w.abs().max()) for w in want if w.numel())
    row["scale"] = scale
    for part, g, w in zip(case["parts"], got, want):
        row[part] = grad_report(torch, g, w, rtol, atol, scale)
    failures = [f"{kernel}_bwd ({label}): {part} outside rtol {rtol}, atol {atol} x max: "
                f"{row[part]}" for part in case["parts"] if not row[part]["ok"]]
    worst = max(row[p]["max_abs_err"] for p in case["parts"])
    row["worst_err_over_scale"] = worst / scale if scale > 0 else worst
    if on_card and kernel in TRAIN_TC_LIMIT:
        row["tc_limit"] = TRAIN_TC_LIMIT[kernel]
        if not worst <= TRAIN_TC_LIMIT[kernel] * scale:
            failures.append(f"{kernel}_bwd ({label}): largest error {worst} over the case's "
                            f"largest gradient {scale} above {TRAIN_TC_LIMIT[kernel]}")
    if "lse" in case:
        lse, plain = case["lse"][0], case["lse"][1]()
        fin = torch.isfinite(plain)
        row["lse"] = {"same_infinite": bool(torch.equal(fin, torch.isfinite(lse))),
                      "finite_rows": int(fin.sum()),
                      **(close_report(torch, lse[fin], plain[fin], 1e-5, 1e-5)
                         if bool(fin.any()) else {"ok": True})}
        if not (row["lse"]["ok"] and row["lse"]["same_infinite"]):
            failures.append(f"{label}: lse {row['lse']}")
    if not row["bitwise_twice"]:
        failures.append(f"{kernel}_bwd ({label}): two calls differ")
    return row, failures


def check_train_kernels(torch, dev, gen, shapes=TRAIN_CASE_SHAPES) -> tuple[dict, dict]:
    """Each backward kernel against its plain version (train_case_report),
    the forward's log-sum-exp against the plain logsumexp; on the card, the
    refusals that keep a kernel from falling back. Returns (cases, max abs
    error by kernel); every case is printed before any fails."""
    from repro_torch.kernels import attention, conv1d, ssd

    cases = train_kernel_cases(torch, dev, gen, shapes)
    failures, err_at = [], {}
    for label, case in cases.items():
        row, fails = train_case_report(torch, label, case, dev.type == "cuda")
        emit(row)
        failures += fails
        err_at[case["name"]] = max(err_at.get(case["name"], 0.0),
                                   max(row[p]["max_abs_err"] for p in case["parts"]))
    if dev.type != "cuda":
        require(not failures, "; ".join(failures))
        return cases, err_at
    refusals = {}
    x = torch.zeros((1, 8, 32), device=dev)
    for name, call in {
            "conv1d_bwd K=9": lambda: conv1d.conv1d_causal_bwd(
                x, x, torch.zeros((9, 32), device=dev), None),
            "ssd_bwd N=130": lambda: ssd.ssd_chunk_scan_bwd(
                *(torch.zeros(s, device=dev) for s in ((1, 8, 2, 4), (1, 8, 2), (2,),
                                                       (1, 8, 1, 130), (1, 8, 1, 130),
                                                       (1, 8, 2, 4))),
                states=torch.zeros((1, 1, 2, 4, 130), device=dev)),
            "attention_bwd D=24": lambda: attention.flash_attention_bwd(
                *(torch.zeros((1, 2, 8, 24), device=dev) for _ in range(5)),
                torch.zeros((1, 2, 8), device=dev)),
            "attention_bwd f64": lambda: attention.flash_attention_bwd(
                *(torch.zeros((1, 2, 8, 16), device=dev, dtype=torch.float64)
                  for _ in range(5)), torch.zeros((1, 2, 8), device=dev))}.items():
        try:
            call()
            refusals[name] = "no error"
        except (ValueError, TypeError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    emit({"phase": "train_kernel_refusals", "refusals": refusals})
    failures += [f"{n} was not refused" for n, r in refusals.items() if r == "no error"]
    require(not failures, "; ".join(failures))
    return cases, err_at


def train_case_times(torch, teff, case) -> dict:
    """One backward kernel case timed (CUDA events, median of 20) beside its
    plain version and its library call, with its bound at the rate of the
    units it runs its products on (3xTF32 tensor cores for attention and
    SSD, f32 CUDA cores for conv1d) and on the CUDA cores beside it; for
    attention also SDPA's backward alone (its forward outside the timed
    calls) and the port's forward with its log-sum-exp plus backward; and
    ``call_times``: the profiler's device ms of each launch a call makes
    (``split``) and their sum, the event ms over back-to-back calls and the
    host µs a call."""
    t = {"ms": teff.measure(case["kernel"], iters=20, warmup=3).median_s * 1e3,
         **call_times(torch, teff, case["kernel"]),
         "plain_ms": teff.measure(case["plain"], iters=5, warmup=1).median_s * 1e3,
         "library_ms": (teff.measure(case["library"], iters=20, warmup=3).median_s * 1e3
                        if case["library"] else None),
         "library": case["library_name"], "bytes": case["bytes"], "flops": case["flops"]}
    if case.get("sdpa_bwd"):
        t["sdpa_bwd_ms"] = teff.measure(case["sdpa_bwd"](), iters=20, warmup=3).median_s * 1e3
    if case.get("port_fwd_bwd"):
        t["port_fwd_bwd_ms"] = teff.measure(case["port_fwd_bwd"], iters=20,
                                            warmup=3).median_s * 1e3
    t.update(case_bound(case))
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    t["device_share_of_bound"] = t["bound_ms"] / t["device_ms"]
    return t


def launch_split(torch, fn, reps: int = 5) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by the
    profiler's names (``key_averages``), over ``reps`` calls after a warm
    one."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key[:100]] = {"launches_a_call": e.count / reps, "ms_a_call": us / 1e3 / reps}
    return out


# calls between two events in call_times' reading: enough that the host's
# time for one call (checks, allocation, the launch) hides behind the
# device's, where a one-call reading measures the host when it is slower
CALL_INNER = 20


def call_times(torch, teff, fn, inner=CALL_INNER, host_calls=100) -> dict:
    """Three readings of a call of ``fn``: the profiler's device ms summed
    over the launches it makes (``launch_split``), the event ms a call over
    ``inner`` back-to-back calls, and the host µs a call (the host clock
    over ``host_calls`` calls that are not waited for: what the wrapper
    costs the host)."""
    split = launch_split(torch, fn)
    ev = teff.measure(fn, iters=10, warmup=3, inner=inner).median_s * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    host_us = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    return {"device_ms": sum(v["ms_a_call"] for v in split.values()), "split": split,
            "event_ms_inner": ev, "inner": inner, "host_us": host_us}


def sass_hmma(library) -> dict:
    """Tensor-core instructions (SASS lines with HMMA) of each kernel in a
    built library, from ``cuobjdump -sass``, by ``kernel_name``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True,
                         timeout=300).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name is not None and "HMMA" in ln:
            counts[name] += 1
    return counts


def ptxas_by_function(log: str) -> dict:
    """``ptxas_summary`` of each kernel in a build's log, by ``kernel_name``."""
    out = {}
    for part in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        m = re.search(r"Compiling entry function '([^']+)'", part)
        if m:
            out[kernel_name(m.group(1))] = ptxas_summary(part)
    return out


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol: the name of a kernel in the
    anonymous namespace, an instance's integer template arguments in
    brackets (``ssd_bwd_chunk<2>``, ``conv1d_tile<4, 4>``); any other symbol
    as it is."""
    # _ZN<len><anonymous namespace><len><name>[I(Li<n>E)+E]...
    ns = re.match(r"_ZN(\d+)_GLOBAL__N_", symbol)
    d = ns and re.match(r"(\d+)", symbol[ns.end(1) + int(ns.group(1)):])
    if not d:
        return symbol
    rest = symbol[ns.end(1) + int(ns.group(1)) + d.end():]
    n = int(d.group(1))
    args = re.match(r"I((?:Li\d+E)+)E", rest[n:])
    return rest[:n] + (f"<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
                       if args else "")


def lse_times(torch, teff, dev, gen) -> dict:
    """The attention forward at Zamba2's shape without and with its
    log-sum-exp output, in turns (plain, lse, lse, plain)."""
    from repro_torch.kernels import attention

    B, Hq, Hkv, L, D, causal, window = TRAIN_CASE_SHAPES["attention"]["zamba2"]
    q, k, v = ((torch.randn((B, h, L, D), generator=gen)).to(dev) for h in (Hq, Hkv, Hkv))
    runs = {"without_lse": [], "with_lse": []}
    for name in ("without_lse", "with_lse", "with_lse", "without_lse"):
        fn = (lambda: attention.flash_attention(q, k, v, causal=causal, return_lse=True)) \
            if name == "with_lse" else (lambda: attention.flash_attention(q, k, v, causal=causal))
        runs[name].append(teff.measure(fn, iters=20, warmup=3).median_s * 1e3)
    return {"shape": [B, Hq, L, D], "ms": runs,
            "without_lse_ms": min(runs["without_lse"]), "with_lse_ms": min(runs["with_lse"])}


# main_path_train: Zamba2-1.2B trained at full width and depth (38 Mamba2
# layers, the shared attention block applied 6 times, f32), batch 4 x 1024
# tokens, through repro_torch.launch.train: TRAIN_STEPS steps on the kernels,
# then on the plain versions from the same weights and batches. No remat
# (TRAIN_REMAT): a step without it peaks at 55.6 GB on an H100 (PERF.md §6).
# The resume check runs Zamba2 at full width cut to its first group
# (TRAIN_RESUME_OVERRIDES: 6 Mamba2 layers and one shared-block application):
# a full-depth checkpoint of the weights and both AdamW moments is 14.4 GB,
# and a chip call may write at most 45 GiB to its disk, which the earlier
# checkpoint phases already use much of; the cut one is 4.3 GB, written
# twice (at step 2 by the stopped run and at step 4 by the resumed one, which
# saves at its last step as the reference's train() does).
TRAIN_ARCH = "zamba2-1.2b"
TRAIN_LOOP = dict(seq_len=1024, global_batch=4)
TRAIN_STEPS = 4
TRAIN_REMAT = False
TRAIN_RESUME_OVERRIDES = {"n_layers": 6}
# the train_lm twin at its defaults but for its checkpoints (four saves of
# 1.6 GB; the resume check above covers checkpointing on the card)
TRAIN_LM_ARGV = ["--ckpt-dir", ""]
# Step 0's loss and gradient norm of the kernels against the plain versions
# (rtol): one forward and backward through 38 layers, each kernel within its
# TRAIN_TOL of its plain version. Every later loss (rtol): AdamW's first
# update is lr sign(g), so a gradient element near 0 whose sign differs
# between the runs moves its weight by 2 lr = 6e-4, and later updates carry
# that on; the loss moves by the gradient times that, far below 1e-3.
TRAIN_STEP0_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
TRAIN_LATER_RTOL = 1e-3
# A run resumed from the step-2 checkpoint against the uninterrupted run
# (rtol, the reference's own bound for its resume test): the kernels and the
# token stream are deterministic, and these runs train inside
# train.deterministic_algorithms, where PyTorch's own accumulating backwards
# are deterministic or raise. (The plain versions' chunked SSD takes a float
# cumsum, which has no deterministic CUDA algorithm, so the kernels-against-
# plain runs, held to tolerances, train outside it.)
TRAIN_RESUME_RTOL = 1e-5
TRAIN_BUDGET_S = 150.0    # train_kernel_cases, main_path_train, main_path_train_lm, times_train


def train_counts(torch) -> dict:
    from repro_torch.kernels import attention, conv1d, ssd

    return {"conv1d": conv1d.launches, "ssd": ssd.launches, "attention": attention.launches,
            "conv1d_bwd": conv1d.launches_bwd, "ssd_bwd": ssd.launches_bwd,
            "attention_bwd": attention.launches_bwd}


def zero_train_counts() -> None:
    from repro_torch.kernels import attention, conv1d, ssd

    for m in (attention, conv1d, ssd):
        m.launches = m.launches_bwd = 0
    attention.launches_by_mode.clear()


def train_main_path(torch, dev, smoke: bool = False, steps: int = TRAIN_STEPS,
                    loop_kw=TRAIN_LOOP, remat: bool = TRAIN_REMAT,
                    resume_overrides=TRAIN_RESUME_OVERRIDES) -> dict:
    """Train TRAIN_ARCH through ``repro_torch.launch.train.train`` on the
    kernels (the launch counts set to 0 just before, read after every
    step), then on the plain versions from the same weights and batches;
    then, cut by ``resume_overrides``, uninterrupted and cut at step 2 and
    resumed from its checkpoint. Check losses, gradient norms, launches and
    the resume; every check is printed before any fails."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import train as lm_train

    on_card = dev.type == "cuda"
    cfg = configs.get_smoke(TRAIN_ARCH) if smoke else configs.get_arch(TRAIN_ARCH)
    n_groups = cfg.n_layers // cfg.attn_every
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    base = lm_train.TrainLoopConfig(steps=steps, log_every=1, **loop_kw)
    rc = dataclasses.replace(lm_train.default_run_config(base), remat=remat)
    # the plain versions keep far more for their backward (the chunked SSD's
    # decay tensors, attention's L x L scores): without remat they ran out of
    # the card's 80 GB (PERF.md §6); recomputing a layer gives the
    # same values, so the same gradients
    plain_rc = dataclasses.replace(rc, attn_impl="ref", ssd_impl="ref", conv_impl="ref",
                                   remat=True)
    quiet = dict(log_fn=lambda *a: None, smoke=smoke, device=dev)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    failures = []
    try:
        # --- on the kernels -----------------------------------------------------------
        rows, last = [], {}

        def record(step, metrics, seconds):
            counts = train_counts(torch)
            rows.append({"step": step, **metrics, "ms": seconds * 1e3,
                         "launches": {k: v - last.get(k, 0) for k, v in counts.items()}})
            last.update(counts)

        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        zero_train_counts()
        t0 = time.perf_counter()
        params, _, hist = lm_train.train(TRAIN_ARCH, base, rc=rc, on_step=record, **quiet)
        wall = time.perf_counter() - t0
        counts = train_counts(torch)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
        n_params = sum(t.numel() for t in flat_tensors(params))
        del params
        free()
        # --- on the plain versions -----------------------------------------------------
        plain_rows = []
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        _, _, plain_hist = lm_train.train(
            TRAIN_ARCH, base, rc=plain_rc,
            on_step=lambda s, m, dt: plain_rows.append({"step": s, **m, "ms": dt * 1e3}),
            **quiet)
        plain_peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
        free()
        # --- cut: uninterrupted, and stopped at step 2 then resumed, at a
        # constant rate (as the reference's resume test: the two-step run's
        # schedule horizon would otherwise differ) ---------------------------------------
        cut = dict(quiet, overrides=resume_overrides, deterministic=True,
                   rc=dataclasses.replace(rc, schedule="const", warmup_steps=1))
        _, _, whole = lm_train.train(TRAIN_ARCH, base, **cut)
        free()
        ck = os.path.join(work, "resume")
        lm_train.train(TRAIN_ARCH, dataclasses.replace(base, steps=2, ckpt_dir=ck,
                                                       ckpt_every=2), **cut)
        free()
        said = []
        _, _, resumed = lm_train.train(
            TRAIN_ARCH, dataclasses.replace(base, ckpt_dir=ck, resume=True, ckpt_every=steps),
            **{**cut, "log_fn": said.append})
        free()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    warm = sorted(r["ms"] for r in rows[1:]) or [rows[0]["ms"]]
    warm_ms = warm[len(warm) // 2]
    plain_warm = sorted(r["ms"] for r in plain_rows[1:]) or [plain_rows[0]["ms"]]
    tokens = loop_kw["global_batch"] * loop_kw["seq_len"]
    mult = 2 if remat else 1
    want = {"conv1d": mult * cfg.n_layers, "ssd": mult * cfg.n_layers, "attention": n_groups,
            "conv1d_bwd": cfg.n_layers, "ssd_bwd": cfg.n_layers, "attention_bwd": n_groups}
    step0 = {k: {"kernels": rows[0][k], "plain": plain_rows[0][k],
                 "rel_err": abs(rows[0][k] - plain_rows[0][k]) / abs(plain_rows[0][k]),
                 "rtol": TRAIN_STEP0_TOL[k]} for k in ("loss", "grad_norm")}
    later = [abs(a - b) / abs(b) for a, b in zip(hist[1:], plain_hist[1:])]
    resume_err = [abs(a - b) / abs(b) for a, b in zip(resumed, whole[2:])]
    row = {"phase": "main_path_train", "arch": cfg.name, "smoke": smoke,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "shared_block_applications": n_groups,
           "params": n_params, "param_count": cfg.param_count(), "remat": remat,
           "plain_remat": plain_rc.remat,
           "batch": loop_kw["global_batch"], "seq_len": loop_kw["seq_len"], "steps": steps,
           "losses": hist, "plain_losses": plain_hist, "steps_detail": rows,
           "plain_steps_detail": plain_rows, "step0": step0,
           "later_loss_rel_err": later, "later_rtol": TRAIN_LATER_RTOL,
           "launches": counts, "launches_per_step_want": want,
           "peak_gb": peak, "plain_peak_gb": plain_peak,
           "warm_ms_per_step": warm_ms, "tokens_per_s": tokens / (warm_ms / 1e3),
           "plain_warm_ms_per_step": plain_warm[len(plain_warm) // 2], "wall_s": wall,
           "resume": {"overrides": resume_overrides, "said": said[:1], "losses": resumed,
                      "uninterrupted": whole[2:], "rel_err": resume_err,
                      "rtol": TRAIN_RESUME_RTOL}}
    emit(row)
    if not all(math.isfinite(h) for h in hist + plain_hist):
        failures.append("a training loss is not finite")
    for k, v in step0.items():
        if not v["rel_err"] <= v["rtol"]:
            failures.append(f"step 0 {k}: kernels {v['kernels']}, plain {v['plain']}")
    if not all(e <= TRAIN_LATER_RTOL for e in later):
        failures.append(f"later losses differ from the plain run: {later}")
    if said[:1] != ["resumed from step 2"] or len(resumed) != steps - 2 or \
            not all(e <= TRAIN_RESUME_RTOL for e in resume_err):
        failures.append(f"the resumed run {resumed} ({said[:1]}) is not the uninterrupted "
                        f"{whole[2:]}")
    if on_card and not smoke:
        for r in rows:
            if r["launches"] != want:
                failures.append(f"step {r['step']} launched {r['launches']}, want {want}")
    require(not failures, "; ".join(failures))
    return row


def train_lm_main_path(torch, dev, argv=TRAIN_LM_ARGV) -> dict:
    """The train_lm twin: ``python -m repro_torch.examples.train_lm`` at its
    defaults (mamba2-130m, 300 steps, batch 4 x 128) with ``argv``
    (TRAIN_LM_ARGV: no checkpoints); the loss must decrease."""
    import contextlib
    import io

    from repro_torch.examples import train_lm

    out = io.StringIO()
    zero_train_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_lm.main(["--device", dev.type] + list(argv))
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    row = {"phase": "main_path_train_lm", "exit": rc, "wall_s": wall,
           "launches": train_counts(torch), "log": lines[:3] + lines[-3:]}
    emit(row)
    require(rc == 0, f"train_lm: the loss did not decrease: {lines[-2:]}")
    return row


def train_kernel_times(torch, teff, cases, ptxas=None) -> dict:
    """train_case_times of the TRAIN_TIMED cases, with ptxas's registers and
    spills of each instance of the case's backward source (``ptxas``:
    ptxas_by_function by source name)."""
    kernels = {}
    for label, case in cases.items():
        if label.endswith(TRAIN_TIMED):
            t = kernels[label] = train_case_times(torch, teff, case)
            t.update(kernel=case["name"] + "_bwd", shape=case["shape"])
            if ptxas is not None:
                t["ptxas"] = ptxas.get(case["name"] + "_bwd")
    return kernels


def times_train(torch, teff, cases, spec, dev, gen, train_row, ptxas=None) -> dict:
    """Each backward kernel at Zamba2's training shapes (and mamba2-130m's,
    and attention at moonshot's) beside its plain version, library call and
    bound; the attention forward with and without its log-sum-exp."""
    kernels = train_kernel_times(torch, teff, cases, ptxas)
    counts = train_row["launches_per_step_want"]
    row = {"phase": "times_train", "card": spec.name, "power_limit": spec.power_limit,
           "kernels": kernels, "lse": lse_times(torch, teff, dev, gen),
           "launches_per_training_step": counts,
           "warm_ms_per_step": train_row["warm_ms_per_step"],
           "tokens_per_s": train_row["tokens_per_s"], "peak_gb": train_row["peak_gb"]}
    emit(row)
    return row


# ---- bf16 storage in the LM kernels -------------------------------------------------
# Every LM kernel takes bf16 storage as the reference's kernels take the
# parameter dtype: its bf16 instance (build.instance) converts each storage
# value to f32 on load, runs the f32 instance's arithmetic and rounds once on
# store. check_lm_bf16 holds every forward case of lm_kernel_cases and every
# backward case of TRAIN_CASE_SHAPES at bf16 (each f32 input rounded) to the
# f32 instance on the upcast inputs, rounded: bitwise, no tolerance; and to
# the plain version at bf16 within the case's f32 tolerance (LM_TOL;
# TRAIN_TOL and, for the tensor-core backward, TRAIN_TC_LIMIT) plus one bf16
# ulp of the larger of the two values (both are f32 results rounded once).
LM_KERNELS = ("conv1d", "ssd", "attention")
# Zamba2-1.2B at bf16 (RunConfig(param_dtype="bfloat16")): served at batch 4,
# a 1024-position prompt and 16 generated tokens, and trained TRAIN_STEPS
# steps at batch 4 x 1024, on the kernels and on the plain versions from the
# same bf16 weights. Prefill logits (atol) and losses (rtol) of the kernels
# against the plain versions: each kernel is within its f32 tolerance of its
# plain version before the one rounding both share, so the runs part where a
# rounding falls the other way and that difference is carried through 38
# bf16 layers. Each bound must be at most its f32 control, the plain bf16
# run's distance from a plain f32 run on the same weights upcast (printed
# beside it): the kernels move the result less than bf16 itself does. The
# logits bound is a sanity bound: one rounding that falls the other way
# spreads through the bf16 projections, so the kernels' distance nears the
# control's (0.76 of it in max, 0.80 in RMS, PERF.md); the per-case checks
# (bitwise to the f32 instance) are the guard. It holds on a second prompt
# (LM_BF16_PROMPTS: the prompts' seeds over the serving seed), same weights.
LM_BF16_SERVE = dict(batch=4, prompt_len=1024, gen_len=16)
LM_BF16_LOGITS_ATOL = 0.2
LM_BF16_PROMPTS = (1, 2)
TRAIN_BF16_RTOL = 2e-3


def bf16_ulp(torch, t):
    """One bf16 ulp of each |t| (8 significant bits), 0 where t is 0."""
    m = t.abs().float()
    return torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))


def storage_inputs(torch, case, dtype, upcast=None) -> dict:
    """A case's storage inputs at ``dtype``, new tensors: each f32 input
    rounded, or with ``upcast`` (inputs at bf16) each of those widened; an
    input the case places one element off its allocation (``offset``) is
    placed so again, so both instances take the same layout and tile."""
    src = upcast if upcast is not None else case["storage"]
    out = {}
    for n, t in src.items():
        t = t.to(dtype) if t.dtype != dtype else t.clone()
        out[n] = off_word(torch, t) if n in case.get("offset", ()) else t
    return out


def bf16_case_report(torch, label, case, backward, on_card) -> tuple[dict, list]:
    """One case at bf16: the kernels' outputs bitwise the f32 instance's on
    the upcast inputs, rounded (f32 outputs equal), the storage outputs
    bf16, and each within the case's tolerance of the plain version at bf16
    plus one bf16 ulp. Returns (row, failures)."""
    bf16 = torch.bfloat16
    s16 = storage_inputs(torch, case, bf16)
    s32 = storage_inputs(torch, case, torch.float32, upcast=s16)
    if backward:
        got, aux = case["run"](**s16)
        f32, _ = case["run"](**s32, aux=aux)
        rtol, atol = TRAIN_TOL[case["name"]]
    else:
        got, f32 = list(case["run"](**s16)), list(case["run"](**s32))
        rtol, atol = LM_TOL[case["name"]]
    plain = list(case["run_plain"](**s16))
    kernel = case["name"] + ("_bwd" if backward else "")
    scale = max(float(w.abs().max()) for w in plain if w.numel()) if backward else 1.0
    atol_abs = atol * scale if backward else atol
    limit = TRAIN_TC_LIMIT.get(case["name"]) if backward and on_card else None
    row = {"phase": "check_lm_bf16", "kernel": kernel, "case": label, "shape": case["shape"],
           "rtol": rtol, "atol": atol_abs, "tc_limit": limit, "scale": scale}
    failures = []
    for part, g, f, p in zip(case["parts"], got, f32, plain):
        same = bool(torch.equal(g, f.to(g.dtype)))
        ulp = bf16_ulp(torch, torch.maximum(g.abs().float(), p.abs().float())) \
            if g.dtype == bf16 else torch.zeros_like(g, dtype=torch.float32)
        diff = (g.float() - p.float()).abs()
        excess = diff - (atol_abs + rtol * p.float().abs() + ulp)
        rep = {"dtype": str(g.dtype).split(".")[-1], "bitwise_f32_rounded": same,
               "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
               "max_excess": float(excess.max()) if diff.numel() else 0.0,
               "finite": bool(torch.isfinite(g).all())}
        rep["ok"] = rep["max_excess"] <= 0 and rep["finite"]
        if limit is not None and diff.numel():
            rep["tc_excess"] = float((diff - (limit * scale + ulp)).max())
            rep["ok"] = rep["ok"] and rep["tc_excess"] <= 0
        row[part] = rep
        if not same:
            failures.append(f"{kernel} ({label}) at bf16: {part} is not the f32 instance's "
                            "on the upcast inputs, rounded")
        if not rep["ok"]:
            failures.append(f"{kernel} ({label}) at bf16: {part} outside the tolerance of the "
                            f"plain version: {rep}")
    storage_out = [g for g, f in zip(got, f32) if f.dtype == torch.float32 and g.dtype == bf16]
    row["storage_outputs_bf16"] = len(storage_out)
    if not storage_out:
        failures.append(f"{kernel} ({label}): no output came back bf16")
    return row, failures


def check_lm_bf16(torch, cases, backward, on_card=True) -> tuple[dict, list]:
    """bf16_case_report of every case; returns (max abs error against the
    plain version by kernel, failures); every row is printed."""
    err, failures = {}, []
    for label, case in cases.items():
        row, fails = bf16_case_report(torch, label, case, backward, on_card)
        emit(row)
        failures += fails
        key = case["name"] + ("_bwd" if backward else "")
        err[key] = max(err.get(key, 0.0), max(row[p]["max_abs_err"] for p in case["parts"]))
    return err, failures


def storage_bytes(torch, case, outs) -> int:
    """A case's bytes (``bytes``: every input read once, every output written
    once, at f32) with its storage inputs and its bf16 outputs at 2 bytes."""
    n = sum(t.numel() for t in case["storage"].values()) + \
        sum(o.numel() for o in outs if o.dtype == torch.bfloat16)
    return case["bytes"] - 2 * n


def lm_bf16_times(torch, teff, case, backward, ptx16) -> dict:
    """One Zamba2 case at bf16: the profiler's device ms of the bf16 call
    and of the f32 instance's on the upcast inputs, in turns (f32, bf16,
    bf16, f32; the lower of each); events around one call; the plain
    version and the library call at bf16; the bound at bf16 storage bytes
    and, where there are products, each at the rate of its operand types
    (``case_bound``; the 3xTF32 bound beside it); ptxas's registers of the
    bf16 instance."""
    s16 = storage_inputs(torch, case, torch.bfloat16)
    s32 = storage_inputs(torch, case, torch.float32, upcast=s16)
    if backward:
        outs, aux = case["run"](**s16)
        fns = {"bf16": lambda: case["run"](**s16, aux=aux),
               "f32": lambda: case["run"](**s32, aux=aux)}
    else:
        outs = list(case["run"](**s16))
        fns = {"bf16": lambda: case["run"](**s16), "f32": lambda: case["run"](**s32)}
    dev_ms = {"bf16": [], "f32": []}
    for way in ("f32", "bf16", "bf16", "f32"):
        dev_ms[way].append(sum(v["ms_a_call"] for v in launch_split(torch, fns[way]).values()))
    byts = storage_bytes(torch, case, outs)
    lib = case.get("run_library")
    t = {"device_ms": min(dev_ms["bf16"]), "f32_device_ms": min(dev_ms["f32"]),
         "device_ms_runs": dev_ms,
         "ms": teff.measure(fns["bf16"], iters=20, warmup=3).median_s * 1e3,
         "plain_ms": teff.measure(lambda: case["run_plain"](**s16), iters=5,
                                  warmup=1).median_s * 1e3,
         "library_ms": (teff.measure(lambda: lib(**s16), iters=20, warmup=3).median_s * 1e3
                        if lib else None),
         "library": (case["library_name"] + " at bf16") if lib else None,
         "bytes": byts, "flops": case["flops"], "products": case.get("products"),
         **case_bound(case, byts, bf16=True), "ptxas": ptx16}
    t["device_share_of_bound"] = t["bound_ms"] / t["device_ms"]
    t["over_f32"] = t["device_ms"] / t["f32_device_ms"]
    return t


def lm_bf16_main_path(torch, dev, smoke: bool = False, serve_kw=LM_BF16_SERVE) -> dict:
    """Zamba2-1.2B served at bf16 through ``repro_torch.launch.serve`` with
    ``RunConfig(param_dtype="bfloat16")``: on the kernels twice (the launch
    counts set to 0 just before the first, cold request and read just after;
    then a warm one), then on the plain versions with the same bf16 weights
    and prompt, then a plain f32 run on the weights upcast (the control);
    then the three again on a second prompt (LM_BF16_PROMPTS). Checks
    launches, shapes, and at each prompt the logits against the plain run
    within LM_BF16_LOGITS_ATOL, and that bound against the control."""
    from repro_torch import configs
    from repro_torch.kernels import attention, conv1d, ssd
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import RunConfig, build as build_model, synth_batch
    from repro_torch.optim import adamw

    on_card = dev.type == "cuda"
    mods = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    scfg = lm_serve.ServeConfig(**serve_kw)
    cfg = configs.get_smoke(LM_ARCH) if smoke else configs.get_arch(LM_ARCH)
    rc = RunConfig(param_dtype="bfloat16")
    plain = dict(attn_impl="ref", ssd_impl="ref", conv_impl="ref")
    model = build_model(cfg, rc, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(scfg.seed))
    prompts = [synth_batch(model, torch.Generator(device=dev).manual_seed(scfg.seed + k),
                           scfg.prompt_len, scfg.batch)["tokens"] for k in LM_BF16_PROMPTS]

    def serve(rc_, p, prompt):
        return lm_serve.serve(LM_ARCH, scfg, rc=rc_, params=p, smoke=smoke, device=dev,
                              tokens=prompt, log_fn=lambda *a: None)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    runs, counts = [], None
    for _ in range(2):
        for m in mods.values():
            m.launches = 0
        t0 = time.perf_counter()
        toks, info = serve(rc, params, prompts[0])
        if on_card:
            torch.cuda.synchronize()
        runs.append((toks, info, time.perf_counter() - t0))
        counts = counts or {n: m.launches for n, m in mods.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    kernels = [runs[0][:2]] + [serve(rc, params, p) for p in prompts[1:]]
    plains = [serve(RunConfig(param_dtype="bfloat16", **plain), params, p) for p in prompts]
    up = adamw.tree_map(lambda t: t.float(), params)
    del params
    f32s = [serve(RunConfig(param_dtype="float32", **plain), up, p)[1] for p in prompts]
    del up

    def rms(a, b):
        return float((a - b).square().mean().sqrt())

    logits_rows = []
    for (tk, ik), (tp, ip), i32 in zip(kernels, plains, f32s):
        got = ik["prefill_logits"].float()
        ref16, ref32 = ip["prefill_logits"].float(), i32["prefill_logits"].float()
        logits_rows.append({
            "shape": list(got.shape), "dtype": str(ik["prefill_logits"].dtype),
            "finite": bool(torch.isfinite(got).all()),
            "max_abs_err_vs_plain": max_abs_diff(got, ref16), "atol": LM_BF16_LOGITS_ATOL,
            "f32_control": max_abs_diff(ref16, ref32), "rms_vs_plain": rms(got, ref16),
            "rms_f32_control": rms(ref16, ref32),
            "tokens_agree_with_plain": int((tk == tp).sum()), "of": int(tk.size)})
    toks, info, wall = runs[0]
    info_ref = plains[0][1]
    row = {"phase": "main_path_lm_bf16", "arch": cfg.name, "smoke": smoke, "serve": serve_kw,
           "param_dtype": rc.param_dtype, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "wall_s": wall, "launches": counts,
           "prefill_ms_cold": info["t_prefill_s"] * 1e3,
           "prefill_ms_warm": runs[1][1]["t_prefill_s"] * 1e3,
           "decode_tok_per_s": runs[1][1]["tok_per_s"],
           "decode_tok_per_s_cold": info["tok_per_s"], "peak_gb": peak,
           "plain_prefill_ms": info_ref["t_prefill_s"] * 1e3,
           "plain_decode_tok_per_s": info_ref["tok_per_s"],
           "logits": logits_rows[0], "logits_prompt2": logits_rows[1:],
           "tokens": {"warm_same_as_cold": bool((runs[1][0] == toks).all()),
                      "first_row": toks[0].tolist()}}
    emit(row)
    for k, lg in zip(LM_BF16_PROMPTS, logits_rows):
        require(lg["finite"] and lg["shape"] == [scfg.batch, cfg.vocab],
                f"bf16 prefill logits (prompt {k}) are not finite or of the wrong shape")
        require(lg["max_abs_err_vs_plain"] <= LM_BF16_LOGITS_ATOL <= lg["f32_control"],
                f"bf16 prefill logits (prompt {k}): kernels against plain "
                f"{lg['max_abs_err_vs_plain']}, atol {LM_BF16_LOGITS_ATOL}, "
                f"f32 control {lg['f32_control']}")
    require(toks.shape == (scfg.batch, scfg.gen_len) and 0 <= toks.min()
            and toks.max() < cfg.vocab, "bf16 generated tokens out of range")
    if on_card:
        n_groups = cfg.n_layers // cfg.attn_every
        require(counts == {"conv1d": cfg.n_layers, "ssd": cfg.n_layers, "attention": n_groups},
                f"launches on the bf16 serving path {counts}")
    return row


def train_bf16_main_path(torch, dev, smoke: bool = False, steps: int = TRAIN_STEPS,
                         loop_kw=TRAIN_LOOP) -> dict:
    """Zamba2-1.2B trained at bf16 (bf16 parameters, the f32 master in the
    AdamW state) through ``repro_torch.launch.train.train``: ``steps`` steps on
    the kernels (the launch counts set to 0 just before, read after every
    step), on the plain versions (remat, as the f32 phase's plain run) from
    the same weights and batches, and a plain f32 run from the weights
    upcast (the control). Checks launches a step, losses within
    TRAIN_BF16_RTOL and that bound against the control."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import train as lm_train
    from repro_torch.models import build as build_model
    from repro_torch.optim import adamw

    on_card = dev.type == "cuda"
    cfg = configs.get_smoke(TRAIN_ARCH) if smoke else configs.get_arch(TRAIN_ARCH)
    n_groups = cfg.n_layers // cfg.attn_every
    base = lm_train.TrainLoopConfig(steps=steps, log_every=1, **loop_kw)
    rc = dataclasses.replace(lm_train.default_run_config(base), param_dtype="bfloat16",
                             remat=TRAIN_REMAT)
    plain_rc = dataclasses.replace(rc, attn_impl="ref", ssd_impl="ref", conv_impl="ref",
                                   remat=True)
    params = build_model(cfg, rc, dev).init(torch.Generator(device=dev).manual_seed(base.seed))
    quiet = dict(log_fn=lambda *a: None, smoke=smoke, device=dev)

    def clone(dtype=None):
        return adamw.tree_map(lambda t: t.detach().to(dtype or t.dtype).clone(), params)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    rows, last = [], {}

    def record(step, metrics, seconds):
        counts = train_counts(torch)
        rows.append({"step": step, **metrics, "ms": seconds * 1e3,
                     "launches": {k: v - last.get(k, 0) for k, v in counts.items()}})
        last.update(counts)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    zero_train_counts()
    t0 = time.perf_counter()
    out, state, hist = lm_train.train(TRAIN_ARCH, base, rc=rc, params=clone(), on_step=record,
                                      **quiet)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    dtypes = sorted({str(t.dtype) for t in adamw.leaves(out)})
    master = "master" in state
    del out, state
    free()
    plain_rows = []
    _, _, plain_hist = lm_train.train(
        TRAIN_ARCH, base, rc=plain_rc, params=clone(),
        on_step=lambda s, m, dt: plain_rows.append({"step": s, **m, "ms": dt * 1e3}), **quiet)
    free()
    _, _, f32_hist = lm_train.train(
        TRAIN_ARCH, base, rc=dataclasses.replace(plain_rc, param_dtype="float32"),
        params=clone(torch.float32), **quiet)
    free()
    warm = sorted(r["ms"] for r in rows[1:]) or [rows[0]["ms"]]
    warm_ms = warm[len(warm) // 2]
    plain_warm = sorted(r["ms"] for r in plain_rows[1:]) or [plain_rows[0]["ms"]]
    tokens = loop_kw["global_batch"] * loop_kw["seq_len"]
    err = max(abs(a - b) / abs(b) for a, b in zip(hist, plain_hist))
    control = max(abs(a - b) / abs(b) for a, b in zip(plain_hist, f32_hist))
    want = {"conv1d": cfg.n_layers, "ssd": cfg.n_layers, "attention": n_groups,
            "conv1d_bwd": cfg.n_layers, "ssd_bwd": cfg.n_layers, "attention_bwd": n_groups}
    row = {"phase": "main_path_train_bf16", "arch": cfg.name, "smoke": smoke,
           "param_dtype": rc.param_dtype, "param_dtypes": dtypes, "f32_master": master,
           "remat": rc.remat, "plain_remat": plain_rc.remat, "batch": loop_kw["global_batch"],
           "seq_len": loop_kw["seq_len"], "steps": steps, "losses": hist,
           "plain_losses": plain_hist, "plain_f32_losses": f32_hist,
           "loss_rel_err": err, "rtol": TRAIN_BF16_RTOL, "f32_control": control,
           "steps_detail": rows, "launches": train_counts(torch),
           "launches_per_step_want": want, "peak_gb": peak, "warm_ms_per_step": warm_ms,
           "tokens_per_s": tokens / (warm_ms / 1e3),
           "plain_warm_ms_per_step": plain_warm[len(plain_warm) // 2], "wall_s": wall}
    emit(row)
    failures = []
    if not all(math.isfinite(h) for h in hist + plain_hist + f32_hist):
        failures.append("a bf16 training loss is not finite")
    if not err <= TRAIN_BF16_RTOL <= control:
        failures.append(f"bf16 losses: kernels against plain {err}, rtol {TRAIN_BF16_RTOL}, "
                        f"f32 control {control}")
    if not master or "torch.bfloat16" not in dtypes:
        failures.append(f"bf16 training: parameters {dtypes}, f32 master {master}")
    if on_card and not smoke:
        for r in rows:
            if r["launches"] != want:
                failures.append(f"bf16 step {r['step']} launched {r['launches']}, want {want}")
    require(not failures, "; ".join(failures))
    return row


def lm_bf16_rows(lm16, train16, times16, err16) -> list:
    """The kernels line's rows of the six bf16 instances."""
    reps = {"conv1d": "src/repro/kernels/conv1d.py:44", "ssd": "src/repro/kernels/ssd.py:78",
            "attention": "src/repro/kernels/attention.py:74"}
    rows = []
    for k in LM_KERNELS:
        for key, launches in ((k, lm16["launches"][k]),
                              (f"{k}_bwd", train16["launches"][f"{k}_bwd"])):
            t = times16[key]
            rows.append({"name": f"{key}:bf16", "route": "cuda",
                         "source": f"src/repro_torch/kernels/csrc/{key}.cu",
                         "replaces": reps[k], "storage": "bfloat16 (f32 compute)",
                         "launches": launches, "max_abs_err": err16[key],
                         **{x: t[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "device_ms", "f32_device_ms")},
                         "bound_3xtf32_ms": t.get("bound_3xtf32_ms")})
    return rows


def lm_bf16_phase(torch, dev, lm_cases, train_cases, strict: bool = True) -> tuple:
    """The bf16 LM phases but the times: the forward and backward cases at
    bf16, Zamba2 served and trained at bf16. Returns (the serving row, the
    training row, the errors by kernel). Without ``strict`` (work on the
    kernels) a failed check stops only its own part, and all fail together
    at the end."""
    failures = []

    def part(fn, *args):
        try:
            return fn(*args)
        except SmokeFailure as e:
            if strict:
                raise
            failures.append(str(e))
            return None

    err16, fails = check_lm_bf16(torch, lm_cases, backward=False)
    err_b, fails_b = check_lm_bf16(torch, train_cases, backward=True)
    err16.update(err_b)
    part(require, not fails + fails_b, "; ".join(fails + fails_b))
    torch.cuda.empty_cache()
    lm16 = part(lm_bf16_main_path, torch, dev)
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train16 = part(train_bf16_main_path, torch, dev)
    train_s = time.perf_counter() - t_train
    torch.cuda.empty_cache()
    emit({"phase": "train_bf16_wall", "wall_s": train_s, "budget_s": TRAIN_BUDGET_S})
    part(require, train_s <= TRAIN_BUDGET_S,
         f"the bf16 training phase took {train_s:.1f} s, over {TRAIN_BUDGET_S} s")
    require(not failures, "; ".join(failures))
    return lm16, train16, err16


def times_lm_bf16(torch, teff, spec, lm_cases, train_cases, lm_ptx, lm16, train16) -> dict:
    """The six bf16 instances timed at Zamba2's shapes (``lm_bf16_times``),
    with the bf16 serving and training figures beside them. (Run with the
    other times, after the main paths: once a process had used the profiler
    before the later phases, it read no device time at the f32 times; PERF.md
    §6.)"""
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    times16 = {}
    for k in LM_KERNELS:
        times16[k] = lm_bf16_times(torch, teff, lm_cases[f"{k}_zamba2"], False,
                                   lm_ptx.get(f"{k}_bf16"))
        times16[f"{k}_bwd"] = lm_bf16_times(torch, teff, train_cases[f"{k}_zamba2"], True,
                                            lm_ptx.get(f"{k}_bwd_bf16"))
    emit({"phase": "times_lm_bf16", "card": spec.name, "power_limit": spec.power_limit,
          "shapes": {k: lm_cases[f"{k}_zamba2"]["shape"] for k in LM_KERNELS},
          "train_shapes": {k: train_cases[f"{k}_zamba2"]["shape"] for k in LM_KERNELS},
          "kernels": times16,
          "serving": {x: lm16[x] for x in ("prefill_ms_cold", "prefill_ms_warm",
                                            "decode_tok_per_s", "peak_gb")} if lm16 else None,
          "training": ({x: train16[x] for x in ("warm_ms_per_step", "tokens_per_s", "peak_gb")}
                       if train16 else None),
          "wall_s": time.perf_counter() - t0})
    return times16


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
    """The hand kernel's k steps in one launch (above MAX_STEPS in launches
    of at most MAX_STEPS, ``diffusion3d.chunks``; the row counts them), in
    place and not, against k single-step launches (T2 a copy of T), and its
    k-step ring rule against the plain version (T2 apart from T on the
    ring); fields stored as
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
            before = diffusion3d.launches
            got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=alias)
            torch.cuda.synchronize()
            row["layout"] = diffusion3d.last_layout
            row["launches"] = diffusion3d.launches - before
            require(row["launches"] == len(diffusion3d.chunks(k)),
                    f"diffusion3d nsteps={k}: {row['launches']} launches")
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
    """A copy of ``t`` one element off its allocation's start: a 2-byte
    tensor two bytes off a 4-byte word, which the hand kernel's pair layout
    refuses (``diffusion3d.pairs_fit``); an f32 one off a 16-byte line,
    which conv1d's 16-byte loads refuse (``conv1d.layout``)."""
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


# ---- the simulation server (batched ensemble solves) ------------------------
SERVE_N = 128              # the main bucket's grid extent (T, T2: 8.39 MB each)
SERVE_SMALL_N = 64         # the second bucket
SERVE_HEALTHY = {SERVE_N: 48, SERVE_SMALL_N: 8}
SERVE_POLICY = dict(max_batch=16, chunk_steps=64, check_every=4, queue_capacity=128)
SERVE_TOL, SERVE_MAX_ITERS = 1e-5, 2000
SERVE_POOL_REQUESTS = 8
# a grid that the column march's tile does not divide, its samples (False:
# dead), cut into chunks inside each column
SERVE_RAGGED = (67, 45, 77)
SERVE_RAGGED_LIVE = (True, False, True, True, True)
# the shapes (samples, grid extent) the batched kernels are timed at beside
# their one-cell twins: the main bucket first, then one 512^3 sample beside
# the solo step, the bucket at 64 samples and the small bucket
SERVE_SPLIT = ((16, SERVE_N), (1, 512), (64, SERVE_N), (8, SERVE_SMALL_N))
# batched coupled kernels held to their plain versions (off the serving path):
# (variant, base shape, samples)
SERVE_COUPLED = (("porosity_fused[neumann0]+err", (512, 512), 8),
                 ("gp_fused[none]+mass", (64, 64, 64), 4))


def serve_spike(n, amp):
    import numpy as np

    T = np.zeros((n, n, n), np.float32)
    T[n // 2, n // 2, n // 2] = amp
    return T


def serve_requests(healthy=None):
    """The burst's healthy requests, (n, amplitude, dt) each: a spike of
    amplitude 1 + 0.1 i and dt = 0.08 + 0.005 (i % 4), 48 at 128^3 then 8 at
    64^3 (``healthy``: {n: count} instead)."""
    return [(n, 1.0 + 0.1 * i, 0.08 + 0.005 * (i % 4))
            for n, count in (healthy or SERVE_HEALTHY).items() for i in range(count)]


def serve_kernels(kern, n=SERVE_N) -> dict:
    """The batched calls of the serving main path at ``n``^3 (or at the grid
    ``n``; the plain step and the checked step with the guard, as
    ``iterate.make_batched_solver`` makes them), their twins in the one-cell
    layout the serving step took before the column march
    (``tune_stencil.one_cell``, ``cells`` and ``cells_checked``), and the
    solo calls a single-request ``solve_until`` and the pool's workers
    launch."""
    from repro_torch.core import iterate
    from repro_torch.ir import Reduction
    from repro_torch.kernels import stencil
    from repro_torch.launch.tune_stencil import one_cell

    checked = kern.with_reductions(dict(kern.reductions, **{
        iterate.GUARD_NAME: Reduction("finite", kern.outputs[0])}))
    grid = (n, n, n) if isinstance(n, int) else tuple(n)
    shp = {f: grid for f in ("T2", "T")}
    out = {"batched": kern.with_reductions(None).batched_call(**shp, dt=1.0),
           "batched_checked": checked.batched_call(**shp, dt=1.0),
           "solo": kern.with_reductions(None).compiled(**shp, dt=1.0),
           "solo_checked": kern.compiled(**shp, dt=1.0),
           "kernels": {"batched": kern.with_reductions(None), "batched_checked": checked}}
    for name, twin in (("batched", "cells"), ("batched_checked", "cells_checked")):
        c, k = out[name], out["kernels"][name]
        out[twin] = stencil.StencilCall(c.ir, k.label, k.bc, one_cell(c.program, c.dtype),
                                        batched=k.rotations, dtype=c.dtype)
    return out


def check_batched(torch, call, bufs, scalars, live, odd, flip, what) -> dict:
    """One launch of a batched kernel on the card against its plain version
    (``codegen.evaluate_batch_torch``) on copies of the same buffers: every
    buffer bitwise, a dead sample's two buffers bitwise unchanged, each
    per-sample max reduction bitwise and each sum within SUM_RTOL."""
    from repro_torch.kernels import codegen

    got = {n: t.clone() for n, t in bufs.items()}
    want = {n: t.clone() for n, t in bufs.items()}
    r_got = call.run_batch(got, scalars, live, odd, flip)
    r_want = codegen.evaluate_batch_torch(call.program, call.batched, want, scalars, live,
                                          odd, flip)
    dead = [b for b, a in enumerate(live.tolist()) if not a]
    row = {"phase": "check_batched", "case": what, "label": call.label,
           "shape": [int(live.shape[0]), *call.ir.base_shape], "dead": dead,
           "max_abs_err": max(max_abs_diff(got[n].float(), want[n].float()) for n in got)}
    require(all(same(torch, got[n], want[n]) for n in got),
            f"{what}: the batched kernel differs from its plain version")
    require(all(torch.equal(got[n][dead], bufs[n][dead]) for n in got),
            f"{what}: a dead sample's buffers changed")
    require(any(not torch.equal(got[n], bufs[n]) for n in got), f"{what}: nothing was written")
    reds = {}
    for name, r in call.program.reductions:
        a, b = r_got[name].cpu(), r_want[name].cpu()
        reds[name] = {"kernel": a.tolist(), "plain": b.tolist()}
        if r.combine == "max":
            require(torch.equal(a, b), f"{what}: per-sample {name} differs")
        else:
            require(torch.allclose(a, b, rtol=SUM_RTOL, atol=0.0), f"{what}: {name} outside rtol")
        require(all(float(a[d]) == 0.0 for d in dead), f"{what}: a dead sample's {name} is not 0")
    row["reductions"] = reds if len(dead) < len(live) else None
    emit(row)
    return row


def serve_sources(torch, kern, coupled=None) -> list:
    """The calls the serving phases launch, to build with every other source:
    :func:`serve_kernels` at both buckets' extents (one source serves
    every extent) with their one-cell twins, the bf16 and f16 batched
    kernels, and the batched coupled kernels of ``SERVE_COUPLED``."""
    calls = serve_kernels(kern)
    out = [calls[k] for k in ("batched", "batched_checked", "solo", "solo_checked", "cells",
                              "cells_checked")]
    for dt in (torch.bfloat16, torch.float16):
        narrow = serve_kernels(kern.with_dtype(dt), SERVE_N // 2)
        out += [narrow["batched"], narrow["batched_checked"]]
    for name, base, _ in (SERVE_COUPLED if coupled is not None else ()):
        v = coupled[name]
        out.append(v["kernel"].batched_call(**v["shapes"](base), **v["scalars"]))
    return out


def serve_kernel_checks(torch, kern, coupled=None, n=SERVE_N, device="cuda") -> float:
    """The batched kernel held to its plain version on the card: the serving
    path's two variants at B = 16 x 128^3 f32 with a mask of dead samples and
    both parities, then at bf16 (one-cell layout) and, when ``coupled`` is
    given, porosity's fused update (2-D, staggered fluxes in-kernel, neumann0)
    and GP's (3-D, radius 2) batched at small sizes. Returns the largest
    error (0.0: bitwise)."""
    gen = torch.Generator(device=device).manual_seed(20261018)
    calls = serve_kernels(kern, n)
    b = SERVE_POLICY["max_batch"]
    live = torch.tensor([i % 5 not in (2, 4) for i in range(b)], device=device)
    odd = torch.tensor([i % 3 == 1 for i in range(b)], device=device)
    scalars = [{"dt": 0.08 + 0.001 * i} if live[i] else None for i in range(b)]
    bufs = {f: torch.rand((b, n, n, n), generator=gen, device=device) for f in ("T2", "T")}
    err = 0.0
    for name in ("batched", "batched_checked"):
        for flip in (0, 1):
            err = max(err, check_batched(torch, calls[name], bufs, scalars, live, odd, flip,
                                         f"{name}[flip {flip}]")["max_abs_err"])
    del bufs
    # 2 bytes, both parities; then a grid the tile does not divide, cut into
    # chunks inside each column, at 4 and 2 bytes
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        narrow = serve_kernels(kern.with_dtype(dt), n // 2)
        bufs = {f: torch.rand((b, n // 2, n // 2, n // 2), generator=gen,
                              device=device).to(dt) for f in ("T2", "T")}
        for name in ("batched", "batched_checked"):
            for flip in (0, 1):
                check_batched(torch, narrow[name], bufs, scalars, live, odd, flip,
                              f"{name}:{tag}[flip {flip}]")
        del bufs
    nr = len(SERVE_RAGGED_LIVE)
    lv = torch.tensor(SERVE_RAGGED_LIVE, device=device)
    od = torch.tensor([i % 2 == 0 for i in range(nr)], device=device)
    sc = [{"dt": 0.09 + 0.002 * i} if a else None for i, a in enumerate(SERVE_RAGGED_LIVE)]
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ragged = serve_kernels(kern.with_dtype(dt), SERVE_RAGGED)
        bufs = {f: torch.rand((nr, *SERVE_RAGGED), generator=gen, device=device).to(dt)
                for f in ("T2", "T")}
        for name in ("batched", "batched_checked"):
            launch = ragged[name].derive(132 if device == "cpu" else spec_sm(torch), samples=nr)
            require(launch.xc < SERVE_RAGGED[0] and SERVE_RAGGED[2] % ragged[name].shape.tile[0],
                    f"the ragged case is not cut inside its columns: {launch}")
            check_batched(torch, ragged[name], bufs, sc, lv, od, 1, f"{name}:{tag}:ragged")
        del bufs
    if coupled is not None:
        for name, base, nb in SERVE_COUPLED:
            v = coupled[name]
            shapes = v["shapes"](base)
            call = v["kernel"].batched_call(**shapes, **v["scalars"])
            fields = [coupled_fields(torch, v, base, gen) for _ in range(nb)]
            bufs = {f: torch.stack([x[f] for x in fields]) for f in shapes}
            lv = torch.tensor([i != 1 for i in range(nb)], device=device)
            od = torch.tensor([i % 2 == 0 for i in range(nb)], device=device)
            sc = [dict(v["scalars"]) if lv[i] else None for i in range(nb)]
            check_batched(torch, call, bufs, sc, lv, od, 1, name)
            del bufs, fields
    return err


def serve_solo(torch, kern, n, amp, dt):
    from repro_torch.core import iterate

    T = torch.from_numpy(serve_spike(n, amp)).to(kern.ps.device)
    return iterate.solve_until(kern, {"T": T, "T2": T.clone()}, {"dt": dt}, tol=SERVE_TOL,
                               max_iters=SERVE_MAX_ITERS, check_every=SERVE_POLICY["check_every"])


def chunk_without_syncs(torch, kern, n=SERVE_N) -> dict:
    """One serving chunk of a full batch under ``torch.cuda.
    set_sync_debug_mode("error")``: any host synchronisation inside the
    chunk raises. Then the chunk boundary's one read."""
    from repro_torch.serve import RequestQueue, ServePolicy, SolveRequest
    from repro_torch.serve.engine import BatchEngine

    pol = ServePolicy(**SERVE_POLICY)
    eng = BatchEngine(kern, pol)
    q = RequestQueue(64)
    tickets = [q.submit(SolveRequest(fields={"T": serve_spike(n, a), "T2": serve_spike(n, a)},
                                     scalars={"dt": dt}, tol=SERVE_TOL, max_iters=SERVE_MAX_ITERS))
               for _, a, dt in serve_requests()[:pol.max_batch]]
    state = eng.start(tickets)
    eng.run_chunk(state)            # warm
    cuda = kern.ps.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run_chunk(state)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    eng.harvest(state)
    return {"chunks": state.chunks, "host_syncs": state.host_syncs, "steps_per_chunk": pol.chunk}


def serve_main_path(torch, spec, kern, kern_plain, healthy=None) -> dict:
    """The simulation server on the card (module docstring): the burst of
    56 healthy requests over two buckets, a quarantine and a deadline, each
    healthy result bitwise to its solo ``solve_until`` and to the batched
    plain version; then the process pool across a worker kill. Returns the
    launches of the burst, its times and the solo results."""
    import numpy as np

    from repro_torch import telemetry
    from repro_torch.core import iterate
    from repro_torch.distributed import fault
    from repro_torch.kernels import stencil
    from repro_torch.serve import (DeadlineExceeded, ProcessWorkerPool, SampleQuarantined,
                                   ServePolicy, SimulationServer, SolveRequest)

    pol = ServePolicy(**SERVE_POLICY)
    healthy = healthy or SERVE_HEALTHY
    reqs = serve_requests(healthy)
    big, device = max(healthy), kern.ps.device.type
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def request(n, amp, dt, **kw):
        T = serve_spike(n, amp)
        return SolveRequest(fields={"T": T, "T2": T.copy()}, scalars={"dt": dt},
                            **{"tol": SERVE_TOL, "max_iters": SERVE_MAX_ITERS, **kw})

    # a warm-up request per bucket: loads the kernels and the CUDA modules
    with SimulationServer(kern, pol) as server:
        for n in healthy:
            server.solve(request(n, 1.0, 0.08), timeout=300.0)
    no_syncs = chunk_without_syncs(torch, kern, big)
    # every request made before the clock starts: the burst arrives at once
    burst = [request(*r) for r in reqs] + [
        request(big, 1.0, 5.0),
        request(big, 1.0, 0.08, tol=1e-12, max_iters=10 ** 6, deadline_s=0.05)]
    col = telemetry.configure(path=None)
    stencil.launches.clear()
    t0 = time.perf_counter()
    with SimulationServer(kern, pol) as server:
        *tickets, bad, late = [server.submit(r) for r in burst]
        outs = [t.result(timeout=600.0) for t in tickets]
        sync()
        wall = time.perf_counter() - t0
        errors = {}
        for t, want in ((bad, SampleQuarantined), (late, DeadlineExceeded)):
            try:
                t.result(timeout=600.0)
                errors[want.__name__] = None
            except want as e:
                errors[want.__name__] = str(e)
    launches = {k: v for k, v in stencil.launches.items() if k.endswith("/batched")}
    counters = {f"{n}{dict(lb) if lb else ''}": v for (n, lb), v in col.counters.items()
                if n.startswith("serve.")}
    lat = sorted(r["dur_s"] for r in col.records if r["kind"] == "span"
                 and r["name"] == "serve.request" and r["attrs"]["outcome"] == "ok")
    chunks = sum(1 for r in col.records if r["kind"] == "span" and r["name"] == "serve.chunk")
    telemetry.reset()
    require(all(errors.values()), f"the quarantine and the deadline did not fail: {errors}")
    require(len(lat) == len(reqs), f"{len(lat)} latencies for {len(reqs)} healthy requests")
    calls = serve_kernels(kern, big)
    for k in (calls["batched"].label, calls["batched_checked"].label):
        require(launches.get(k, 0) > 0 or kern.ps.backend != "cuda",
                f"kernel {k} was not launched on the serving main path")

    # every healthy result bitwise to its solo solve_until on the card
    solo = [serve_solo(torch, kern, *r) for r in reqs]
    iters = [o["iters"] for o in outs]
    for r, o, s in zip(reqs, outs, solo):
        require(o["iters"] == s.iters and o["err"] == s.err
                and all(torch.equal(o["fields"][f], s.fields[f]) for f in ("T", "T2")),
                f"request {r}: the served result differs from its solo solve_until "
                f"(iters {o['iters']} / {s.iters}, err {o['err']} / {s.err})")
    # and to the batched plain version (the torch backend, batches of 16)
    k = 0
    for n, count in healthy.items():
        group = [r for r in reqs if r[0] == n]
        for i in range(0, count, pol.max_batch):
            part = group[i:i + pol.max_batch]
            T0 = np.stack([serve_spike(n, a) for _, a, _ in part])
            res = iterate.solve_batch(kern_plain, {"T": T0, "T2": T0.copy()},
                                      {"dt": [dt for _, _, dt in part]}, tol=SERVE_TOL,
                                      max_iters=SERVE_MAX_ITERS,
                                      check_every=pol.check_every)
            fields = res.fields
            for j in range(len(part)):
                o = outs[k + j]
                require(int(res.iters[j]) == o["iters"] and float(res.err[j]) == o["err"]
                        and all(torch.equal(fields[f][j], o["fields"][f]) for f in ("T", "T2")),
                        f"request {part[j]}: the served result differs from the batched "
                        "plain version")
            k += len(part)
            del res, fields
    del outs

    # the process pool: 2 workers on the card, each first-generation worker
    # killed after 2 requests; every request resolves, bitwise to solo
    spool = tempfile.mkdtemp(prefix="serve_pool_")
    plan = fault.FaultPlan(kill_worker_after=2)
    t1 = time.perf_counter()
    try:
        pool = ProcessWorkerPool(spool, workers=2, device=device, heartbeat_timeout_s=120.0,
                                 max_worker_restarts=4, env={fault.PLAN_ENV: plan.to_env()})
        with pool:
            ptk = [pool.submit({"T": serve_spike(n, a), "T2": serve_spike(n, a)}, {"dt": dt},
                               tol=SERVE_TOL, max_iters=SERVE_MAX_ITERS,
                               check_every=pol.check_every)
                   for n, a, dt in reqs[:SERVE_POOL_REQUESTS]]
            pres = [t.result(timeout=300.0) for t in ptk]
        restarts, recovered = pool.restarts, pool.recovered
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    pool_s = time.perf_counter() - t1
    for r, (fields, meta), s in zip(reqs, pres, solo):
        require(meta["iters"] == s.iters and meta["err"] == s.err
                and all(np.array_equal(fields[f], s.fields[f].cpu().numpy()) for f in ("T", "T2")),
                f"pool request {r}: differs from its solo solve_until")
    require(restarts >= 1, "the pool counted no respawn after the planned worker kills")
    ranks = sorted({meta["rank"] for _, meta in pres})
    n_ok = len(lat)
    run = {"phase": "main_path_serve", "card": spec.name, "power_limit": spec.power_limit,
           "policy": SERVE_POLICY, "buckets": {f"{n}^3": c for n, c in healthy.items()},
           "healthy": n_ok, "iters": iters, "typed_failures": errors,
           "bitwise_to_solo": True, "bitwise_to_batched_plain": True,
           "wall_s": wall, "requests_per_s": n_ok / wall,
           "p50_s": lat[len(lat) // 2], "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "chunks": chunks, "host_syncs": counters.get("serve.host_syncs", 0),
           "host_syncs_per_chunk": counters.get("serve.host_syncs", 0) / max(chunks, 1),
           "chunk_without_syncs": no_syncs, "launches": launches, "counters": counters,
           "pool": {"requests": len(pres), "restarts": restarts, "recovered": recovered,
                    "ranks": ranks, "wall_s": pool_s, "bitwise_to_solo": True}}
    emit(run)
    return run


def serve_times(torch, spec, kern, kern_plain, ptxas_of=None) -> tuple:
    """CUDA-event medians (20), every sample live, at each (samples, extent)
    of ``SERVE_SPLIT``: each batched kernel (the column march) in turns
    with its one-cell twin (column, one-cell, one-cell, column), first held
    to its plain version, the kernel alone (``StencilCall.batch_launcher``),
    and each once through ``run_batch`` (``call_ms``: the wrapper's host
    work, the finish of the reductions too), beside its bound (the live
    samples' bytes, ``teff.sample_step_cost``, over 3.35 TB/s), with ptxas's
    registers of both; at one 512^3 sample also the solo kernel on that
    sample. Returns
    ``(rows, split)``: ``rows`` the kernels at B = 16 x 128^3 with their
    plain version's ms and the same step as 16 single-sample launches of
    the solo kernel, ``split`` every shape's turns."""
    from repro_torch.core import teff
    from repro_torch.kernels import codegen

    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = torch.device("cuda")
    ptx = ptxas_of or {}

    def timed(fn):
        return teff.measure(fn, iters=20, warmup=3).median_s * 1e3

    rows, split = {}, []
    for nb, n in SERVE_SPLIT:
        calls = serve_kernels(kern, n)
        bufs = {f: 0.1 * torch.rand((nb, n, n, n), generator=gen, device="cuda")
                for f in ("T2", "T")}
        live = torch.ones(nb, dtype=torch.bool, device="cuda")
        odd = torch.tensor([i % 2 == 1 for i in range(nb)], device="cuda")
        scalars = [{"dt": 0.08 + 0.005 * (i % 4)} for i in range(nb)]
        pairs = (("batched", "cells"), ("batched_checked", "cells_checked"))
        # held to the plain version first: the timed launches below step the
        # buffers in place
        for name, twin in pairs:
            for tag in (name, twin)[:2 if (nb, n) == SERVE_SPLIT[0] else 1]:
                check_batched(torch, calls[tag], bufs, scalars, live, odd, 0, f"{tag}@{nb}x{n}^3")
        for name, twin in pairs:
            call, cell = calls[name], calls[twin]
            params = call.batch_params(scalars, "cuda")
            turns = {"column": [], "one_cell": []}
            alone = {"column": call.batch_launcher(bufs, params, live, odd),
                     "one_cell": cell.batch_launcher(bufs, params, live, odd)}
            for v in ("column", "one_cell", "one_cell", "column"):
                turns[v].append(timed(alone[v]))
            call_ms = {v: timed(lambda: c.run_batch(bufs, scalars, live, odd, 0, params))
                       for v, c in (("column", call), ("one_cell", cell))}
            nbytes, ops = (nb * x for x in teff.sample_step_cost(call))
            by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
            bound = max(by_bytes, by_ops) * 1e3
            ms, cell_ms = (sum(turns[v]) / 2 for v in ("column", "one_cell"))
            launch = call.derive(spec_sm(torch), samples=nb)
            entry = {"kernel": call.label, "samples": nb, "base": [n] * 3, "bound_ms": bound,
                     "ms": turns["column"], "share": bound / ms, "layout":
                     codegen.layout_name(call.shape), "grid": list(launch.grid), "xc": launch.xc,
                     "ptxas": ptx.get(call.source), "call_ms": call_ms["column"],
                     "one_cell_ms": turns["one_cell"], "one_cell_share": bound / cell_ms,
                     "one_cell_call_ms": call_ms["one_cell"],
                     "one_cell_layout": codegen.layout_name(cell.shape),
                     "one_cell_ptxas": ptx.get(cell.source)}
            if nb == 1:     # the solo kernel through its wrapper, which allocates its output
                solo = calls["solo" if name == "batched" else "solo_checked"]
                one = {f: t[0] for f, t in bufs.items()}
                entry["solo_ms"] = timed(lambda: solo.run(one, scalars[0]))
                entry["solo_share"] = bound / entry["solo_ms"]
            split.append(entry)
            if (nb, n) != SERVE_SPLIT[0]:
                continue
            plain_ms = timed(lambda: codegen.evaluate_batch_torch(
                call.program, call.batched, bufs, scalars, live, odd, 0))
            one_k = calls["kernels"][name]

            def singles():
                for i in range(nb):
                    one_k(T2=bufs["T2"][i], T=bufs["T"][i], dt=scalars[i]["dt"])
            rows[call.label] = {"ms": ms, "call_ms": call_ms["column"], "plain_ms": plain_ms,
                                "singles_ms": timed(singles),
                                "bound_ms": bound,
                                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                                "bytes": nbytes, "bound_over_ms": bound / ms,
                                "layout": codegen.layout_name(call.shape), "ptxas": ptx.get(
                                    call.source), "one_cell_ms": cell_ms,
                                "one_cell_call_ms": call_ms["one_cell"],
                                "one_cell_layout": codegen.layout_name(cell.shape),
                                "one_cell_ptxas": ptx.get(cell.source)}
        del bufs
        torch.cuda.empty_cache()
    return rows, split


# ---------------------------------------------------------------------------
# the launch autotuner: FIG1 tuned on the card, the winner applied
# ---------------------------------------------------------------------------
# At most this many layouts a (k, march), the table's first, every one
# timed: the tuner prunes nothing by default, since the cost model prices
# FIG1's single step at 512^3 3.2-3.4 times its k = 4 launches a step (it
# counts every refetched halo plane, which L2 keeps on the card) where they
# measure 5-8% apart. A second f32 search prunes at the ratio that keeps
# the first one's winner: every candidate priced above it goes untimed, and
# its winner is the first's or one the first measured within AUTOTUNE_SLACK
# of it. The phase took 14.7 s, builds included, on the H100 (80GB HBM3,
# 700 W).
AUTOTUNE_CANDIDATES = 5
AUTOTUNE_SLACK = 1.03
AUTOTUNE_KS, AUTOTUNE_MARCHES = (1, 2, 4), (None, 0)
AUTOTUNE_STEPS = 96       # the winner's run: a multiple of every k tried
ROOFLINE_SLACK = 1.05     # a measured step may beat the copy-bandwidth bound by this much


def autotune_main_path(torch, spec, cfg=None, device="cuda") -> dict:
    """The launch autotuner's main path (``kernels/autotune.py``): FIG1 at
    ``cfg``'s size (512^3) tuned at f32 over k = 1, 2, 4 and the
    all-parallel and axis-0 marches, every candidate held bitwise to k
    single steps of the table layout, into a fresh cache file under
    ``build/``; the tuner again (a memory hit) and with its memory cleared
    (a disk hit), neither launching a kernel; the winner applied through
    ``parallel(tile=)``, ``.marched`` and ``run_steps`` for AUTOTUNE_STEPS
    steps, bitwise to the table layout's run, both timed in turns, with
    its roofline record against ``spec``; then the tuner at bf16 (one step
    a launch), whose cache entry must be its own. Between them a second
    f32 search, in memory, prunes at the ratio that keeps the first's
    winner: the candidates priced above it go untimed, and its winner is
    the first's or one the first measured within AUTOTUNE_SLACK of it. The
    launch counts are set to 0 before and read after; every time is the
    card's (on the CPU, a rehearsal, the host clock's)."""
    from repro_torch import telemetry
    from repro_torch.configs import FIG1
    from repro_torch.core import init_parallel_stencil, teff
    from repro_torch.examples import quickstart
    from repro_torch.kernels import autotune, codegen, stencil
    from repro_torch.launch.roofline import stencil_roofline

    def key_of(r):
        """A winner as the report names a candidate."""
        return (None if r.tile is None else codegen.layout_name(r.tile), r.nsteps, r.march_axis)

    cfg = cfg or FIG1
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    measure = teff.measure if cuda else (lambda fn, iters, warmup: teff.measure_host(
        fn, iters=iters, warmup=warmup))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="autotune_", dir=os.path.join(ROOT, "build"))
    cache = os.path.join(root, "tune.json")
    col = telemetry.configure(None)         # the decisions, read back from memory
    autotune._CACHE.clear()
    stencil.launches.clear()
    stencil.layout_launches.clear()
    kw = dict(cache_path=cache, hw=spec, max_candidates=AUTOTUNE_CANDIDATES, device=device)
    try:
        report = []
        t_tune = time.perf_counter()
        win = autotune.autotune_diffusion3d(cfg.shape, "float32", nsteps_candidates=AUTOTUNE_KS,
                                            march_candidates=AUTOTUNE_MARCHES, report=report,
                                            **kw)
        tune_s = time.perf_counter() - t_tune
        tuned = sum(stencil.launches.values())
        again = autotune.autotune_diffusion3d(cfg.shape, "float32", nsteps_candidates=AUTOTUNE_KS,
                                              march_candidates=AUTOTUNE_MARCHES, **kw)
        after_memory = sum(stencil.launches.values())
        autotune._CACHE.clear()
        disk = autotune.autotune_diffusion3d(cfg.shape, "float32", nsteps_candidates=AUTOTUNE_KS,
                                             march_candidates=AUTOTUNE_MARCHES, **kw)
        after_disk = sum(stencil.launches.values())
        decisions = [r["attrs"]["cache"] for r in col.records
                     if r["kind"] == "event" and r["name"] == "autotune.decision"]

        # a prune that removes candidates: at the ratio that keeps the winner
        # (priced as in the first search), in memory only
        preds = {(r["tile"], r["nsteps"], r["march_axis"]): r["predicted_s"] for r in report}
        ratio = preds[key_of(win)] / min(preds.values()) * (1 + 1e-9)
        report_pruned = []
        pruned = autotune.autotune_diffusion3d(
            cfg.shape, "float32", nsteps_candidates=AUTOTUNE_KS,
            march_candidates=AUTOTUNE_MARCHES, report=report_pruned, hw=spec,
            prune_ratio=ratio, max_candidates=AUTOTUNE_CANDIDATES, device=device)

        # the winner applied, beside the table layout at the same k and march
        ps = init_parallel_stencil(device=device) if cuda else \
            init_parallel_stencil(backend="torch", device=device)
        kern = autotune.diffusion3d_kernel(ps, win.tile).marched(win.march_axis)
        table = autotune.diffusion3d_kernel(ps).marched(win.march_axis)
        _, f, sc = quickstart.initial_state(cfg, device)
        k = win.nsteps

        def run(kn):
            cur = dict(f)
            for _ in range(AUTOTUNE_STEPS // k):
                out = kn.run_steps(k, **cur, **sc)
                cur["T2"], cur["T"] = cur["T"], out
            return cur["T"]

        got, want = run(kern), run(table)
        bitwise = bool(torch.equal(got, want))
        finite = bool(torch.isfinite(got).all())
        del got, want
        turns = {"table": [], "winner": []}
        for name in ("table", "winner", "winner", "table"):
            kn = kern if name == "winner" else table
            turns[name].append(measure(lambda: kn.run_steps(k, **f, **sc), iters=20,
                                       warmup=3).median_s * 1e3 / k)
        ms = {n: sum(v) / len(v) for n, v in turns.items()}
        call = kern.compiled(nsteps=k, **f, **sc)
        n_sm = stencil.sm_count(torch.device(device)) if cuda else 132
        roof = stencil_roofline(kern.cost_model(**f, **sc), nsteps=k, hw=spec,
                                measured_s=ms["winner"] / 1e3, tile=call.cost_tile(n_sm),
                                march_axis=call.march_axis)

        # bf16: one step a launch, an entry of its own
        report16 = []
        win16 = autotune.autotune_diffusion3d(cfg.shape, "bfloat16", nsteps_candidates=(1,),
                                              report=report16, **kw)
        with open(cache) as fh:
            entries = json.load(fh)["entries"]
        launches = dict(stencil.launches)
        layout_launches = dict(stencil.layout_launches)
    finally:
        telemetry.reset()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0

    def rows(rep):
        return [{"layout": r["tile"], "k": r["nsteps"], "march_axis": r["march_axis"],
                 "predicted_ms_per_step": (None if r["predicted_s"] is None
                                           else r["predicted_s"] * 1e3),
                 "measured_ms_per_step": (None if r["measured_s"] is None
                                          else r["measured_s"] * 1e3),
                 "pruned": r["pruned"], "bitwise": r["bitwise"]} for r in rep]

    def winner(r):
        return {"layout": None if r.tile is None else codegen.layout_name(r.tile),
                "k": r.nsteps, "march_axis": r.march_axis, "ms_per_step": r.per_step_s * 1e3,
                "candidates_tried": r.candidates_tried,
                "candidates_pruned": r.candidates_pruned}

    label, layout = call.label, codegen.layout_name(call.shape)
    measured = {(r["tile"], r["nsteps"], r["march_axis"]): r["measured_s"] for r in report}
    pruned_key = key_of(pruned)
    priced_out = sum(p > ratio * min(preds.values()) for p in preds.values())
    row = {"phase": "main_path_autotune", "config": "FIG1", "shape": list(cfg.shape),
           "card": getattr(spec, "name", None), "power_limit": getattr(spec, "power_limit", None),
           "candidates": rows(report), "winner": winner(win), "tune_s": tune_s,
           "decisions": decisions, "launches_tuning": tuned,
           "launches_memory_hit": after_memory - tuned, "launches_disk_hit": after_disk - tuned,
           "applied": {"steps": AUTOTUNE_STEPS, "bitwise_to_table": bitwise,
                       "table_layout": codegen.layout_name(table.compiled(nsteps=k, **f,
                                                                          **sc).shape),
                       "ms_per_step_turns": turns, "ms_per_step": ms,
                       "winner_over_table": ms["winner"] / ms["table"]},
           "roofline": roof, "bf16": {"candidates": rows(report16), "winner": winner(win16)},
           "pruned_search": {"prune_ratio": ratio, "candidates": rows(report_pruned),
                             "winner": winner(pruned),
                             "reference_ratio_2_would_prune": sum(
                                 p > 2.0 * min(preds.values()) for p in preds.values())},
           "cache_entries": len(entries), "launches": launches,
           "layout_launches": {f"{lb} {ly}": n for (lb, ly), n in layout_launches.items()},
           "wall_s": wall}
    emit(row)
    require(win.candidates_tried >= 1 and len(report) == win.candidates_tried
            + win.candidates_pruned, f"the f32 tune reported {len(report)} candidates: {win}")
    require(all(r["bitwise"] for r in report + report16 if not r["pruned"]),
            "a timed candidate was not held bitwise to the table layout")
    require(again == win and disk == win, f"the cached winners differ: {win} {again} {disk}")
    require(decisions[:3] == ["miss", "memory_hit", "disk_hit"],
            f"the tuner's cache decisions were {decisions}")
    require(after_memory == tuned and after_disk == tuned,
            "a cache hit launched a kernel")
    require(bitwise and finite, f"the winner's {AUTOTUNE_STEPS} steps are not bitwise equal to "
                                "the table layout's")
    require(0 < roof["frac_of_roofline"] <= ROOFLINE_SLACK,
            f"the winner's roofline fraction {roof['frac_of_roofline']} exceeds {ROOFLINE_SLACK}")
    require(len(entries) == 2 and len({tuple(json.loads(key)[-2]) for key in entries}) == 2,
            f"the bf16 tune did not take a cache entry of its own: {list(entries)}")
    require(pruned.candidates_pruned == priced_out
            and pruned.candidates_pruned + pruned.candidates_tried == len(report_pruned)
            and all(r["measured_s"] is None for r in report_pruned if r["pruned"]),
            f"the pruned search timed what its ratio {ratio} prunes, or pruned "
            f"{pruned.candidates_pruned} where the prices prune {priced_out}")
    require(not cuda or (pruned_key in measured
                         and measured[pruned_key] <= AUTOTUNE_SLACK * win.per_step_s),
            f"the pruned search's winner {pruned_key} is not within {AUTOTUNE_SLACK} of the "
            f"unpruned winner's {win.per_step_s} s a step")
    require(layout_launches.get((label, layout), 0) > 0 or not cuda,
            f"the winner {label} {layout} was not launched: {layout_launches}")
    return {"row": row, "label": label, "win": win, "win16": win16, "ms": ms, "kern": kern,
            "layout_launches": layout_launches, "fields": f, "scalars": sc, "k": k}


def autotune_rows(torch, tuned) -> list:
    """The kernels line's rows of the autotuner's path, the f32 and the
    bf16 winner: each launch of its k steps on the FIG1 state at its
    storage dtype, beside the ``torch`` backend's k steps on the same
    fields (``max_abs_err``, ``plain_ms``) and its bound (the fields read
    and written once over 3.35 TB/s, or k steps of operations over 67
    TFLOP/s). ``launches`` counts the launches of the row's own label and
    layout on the tuner's path; ``label_launches`` those of every layout
    of its label."""
    from repro_torch.core import init_parallel_stencil, teff
    from repro_torch.kernels import autotune, codegen

    rows = []
    for tag, win, dtype in (("f32", tuned["win"], torch.float32),
                            ("bf16", tuned["win16"], torch.bfloat16)):
        k = win.nsteps
        f = {n: t.to(dtype) for n, t in tuned["fields"].items()}
        sc = tuned["scalars"]
        kern = autotune.diffusion3d_kernel(init_parallel_stencil(dtype=dtype),
                                           win.tile).marched(win.march_axis)
        plain = autotune.diffusion3d_kernel(init_parallel_stencil(
            backend="torch", device="cuda", dtype=dtype))
        err = max_abs_diff(kern.run_steps(k, **f, **sc).float(),
                           plain.run_steps(k, **f, **sc).float())
        require(err == 0.0, f"the autotuned {tag} kernel differs from the torch backend: {err}")
        ms = teff.measure(lambda: kern.run_steps(k, **f, **sc), iters=20, warmup=3).median_s * 1e3
        plain_ms = teff.measure(lambda: plain.run_steps(k, **f, **sc), iters=5,
                                warmup=1).median_s * 1e3
        call = kern.compiled(nsteps=k, **f, **sc)
        interior = math.prod(n - 2 for n in call.ir.base_shape)
        nbytes = 3 * math.prod(call.ir.base_shape) * dtype.itemsize
        by_bytes = nbytes / PEAK_BYTES_PER_S
        by_ops = k * len(call.program.outputs[0].ops) * interior / PEAK_F32_PER_S
        rows.append({"name": f"autotune:{call.label}", "route": "cuda",
                     "source": ("src/repro_torch/kernels/codegen_steps.py" if k > 1 else
                                "src/repro_torch/kernels/codegen_pairs.py" if call.shape.vec > 1
                                else "src/repro_torch/kernels/codegen.py"),
                     "replaces": "src/repro/kernels/stencil.py:1052",
                     "launches": tuned["layout_launches"].get(
                         (call.label, codegen.layout_name(call.shape)), 0),
                     "label_launches": sum(n for (lb, _), n in tuned["layout_launches"].items()
                                           if lb == call.label),
                     "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops) * 1e3,
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     "library_ms": None, "layout": codegen.layout_name(call.shape), "k": k,
                     "march_axis": win.march_axis, "ms_per_step": ms / k})
        require(rows[-1]["launches"] > 0,
                f"the {tag} winner {call.label} {rows[-1]['layout']} was not launched on the "
                f"autotuner's path: {tuned['layout_launches']}")
        del f
    return rows


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


def train_kernels_alone() -> int:
    """``python3 chip_smoke.py --train-kernels``: the training kernels alone
    on one card, for work on them. Builds the LM sources (ptxas's registers
    and spills of each instance), holds every backward kernel against its
    plain version at every TRAIN_CASE_SHAPES case (twice bitwise), then
    times the TRAIN_TIMED cases as ``times_train`` does (with the profiler's
    split of each call) and the attention forward with and without its
    log-sum-exp. No training run, no other path; not the smoke test's contract."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import teff
    from repro_torch.kernels import attention, build, conv1d, ssd

    dev = torch.device("cuda", 0)
    card_name, card_power = teff.card_info(0)
    emit({"phase": "card", "name": card_name, "power_limit": card_power,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    mods = {"conv1d": conv1d, "ssd": ssd, "attention": attention}
    sources = ([(n, build.read_source(m.SOURCE)) for n, m in mods.items()]
               + [(f"{n}_bwd", build.read_source(m.BWD_SOURCE)) for n, m in mods.items()])
    builds = build.compile_many(sources)
    ptx = {b.name: ptxas_by_function(b.log) for b in builds}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "ptxas": ptx,
          "hmma": {b.name: sass_hmma(b.library) for b in builds}})
    cases, err = check_train_kernels(torch, dev,
                                     torch.Generator(device="cpu").manual_seed(20261018))
    torch.backends.cudnn.allow_tf32 = False
    kernels = train_kernel_times(torch, teff, cases, ptx)
    emit({"phase": "times_train_kernels", "card": card_name, "power_limit": card_power,
          "kernels": kernels,
          "lse": lse_times(torch, teff, dev, torch.Generator(device="cpu").manual_seed(20261019))})
    print(f"{card_name}, {card_power}", flush=True)
    emit({"phase": "train_kernels_alone", "ok": True, "max_abs_err": err,
          "wall_s": time.perf_counter() - START})
    return 0


# python3 chip_smoke.py --lm-against DIR, and --conv1d [--against DIR]: the
# f32 LM kernels of this checkout and of DIR's (another checkout, e.g. the
# parent unpacked by ``git archive``), each built, checked and run in a
# process of its own (``--lm-child SRC KERNELS TIMED``) on the same inputs
# (lm_kernel_cases and TRAIN_CASE_SHAPES, from fixed seeds): the sha256 of
# every output, which --lm-against requires to be the same, that is every
# output bitwise equal. --conv1d takes the conv1d kernels alone, for work on
# them, and times the CONV1D_TIMED cases in turns (DIR, this, this, DIR),
# with the device ms at each tile.
CONV1D_TIMED = ("zamba2", "mamba2")


def lm_child(src: str, names, timed=()) -> int:
    """The f32 kernels ``names`` (of LM_KERNELS) of the package under
    ``src`` built (ptxas's registers and spills of each instance), each of
    their forward and backward cases checked against its plain version and
    its outputs hashed, the ``timed`` cases timed (``lm_case_times``,
    ``train_case_times``; conv1d's also by tile); one JSON line, then exit 1
    if a check failed."""
    import hashlib

    import torch

    sys.path.insert(0, src)
    from repro_torch.core import teff
    from repro_torch.kernels import attention, build, conv1d, ssd

    dev = torch.device("cuda", 0)
    mods = {n: m for n, m in (("conv1d", conv1d), ("ssd", ssd), ("attention", attention))
            if n in names}
    t0 = time.perf_counter()
    builds = build.compile_many([(f"{n}{part}", build.read_source(getattr(m, s)))
                                 for part, s in (("", "SOURCE"), ("_bwd", "BWD_SOURCE"))
                                 for n, m in mods.items()])
    out = {"src": src, "build_s": time.perf_counter() - t0,
           "ptxas": {b.name: ptxas_by_function(b.log) for b in builds},
           "checks": {}, "sha256": {}, "forward": {}, "backward": {}}

    def sha(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()

    gen = torch.Generator(device="cpu").manual_seed(20261021)
    fwd = {k: c for k, c in lm_kernel_cases(torch, dev, gen, others=names != ["conv1d"]).items()
           if c["name"] in mods}
    bwd = train_kernel_cases(torch, dev, gen, {k: v if k in mods else {}
                                               for k, v in TRAIN_CASE_SHAPES.items()})
    failures = []
    for label, case in fwd.items():
        got = case["kernel"]()
        out["sha256"][f"forward/{label}"] = [sha(t) for t in got]
        rep = {p: close_report(torch, g, w, *LM_TOL[case["name"]])
               for p, g, w in zip(case["parts"], got, case["plain"]())}
        out["checks"][f"forward/{label}"] = {"max_abs_err": max(r["max_abs_err"]
                                                                 for r in rep.values()),
                                             "ok": all(r["ok"] for r in rep.values())}
        failures += [] if out["checks"][f"forward/{label}"]["ok"] else [f"forward {label}: {rep}"]
    for label, case in bwd.items():
        out["sha256"][f"backward/{label}"] = [sha(t) for t in case["kernel"]() if t is not None]
        row, fails = train_case_report(torch, label, case, True)
        out["checks"][f"backward/{label}"] = {
            "worst_err_over_scale": row["worst_err_over_scale"],
            "bitwise_twice": row["bitwise_twice"], "ok": not fails}
        failures += fails
    out["launches"] = {n: [m.launches, m.launches_bwd] for n, m in mods.items()}
    torch.backends.cudnn.allow_tf32 = False
    for label in timed:
        for way, cases, timer in (("forward", fwd, lm_case_times),
                                  ("backward", bwd, train_case_times)):
            for n in mods:
                case = cases[f"{n}_{label}"]
                t = out[way][f"{n}_{label}"] = timer(torch, teff, case)
                if n == "conv1d":
                    t["layout"] = conv1d_layout(conv1d, case)
                    t["by_tile"] = conv1d_by_tile(torch, conv1d, case)
    out["failures"] = failures
    print(json.dumps({"lm_child": out}), flush=True)
    return 1 if failures else 0


def conv1d_layout(conv1d, case):
    """The layout name of a conv1d case's launch (None before the tiled
    kernels)."""
    case["kernel"]()
    if getattr(conv1d, "last_layout", None) is None:
        return None
    B, L, C = case["shape"]["x"]
    return conv1d.layout_name(B, L, C, *conv1d.last_layout)


def conv1d_by_tile(torch, conv1d, case):
    """The device ms of a conv1d case at each tile the sources take (None
    before the tiled kernels)."""
    if not hasattr(conv1d, "TILES"):
        return None
    tiles, by_tile = conv1d.TILES, {}
    try:
        for tile in tiles:
            conv1d.TILES = (tile,)
            by_tile[tile] = {"layout": conv1d_layout(conv1d, case),
                             "device_ms": sum(v["ms_a_call"] for v in
                                              launch_split(torch, case["kernel"]).values())}
    finally:
        conv1d.TILES = tiles
    return by_tile


def card_or_exit(torch):
    """The card's name and power limit, after putting the port on the path;
    None without a card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return None
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import teff

    card_name, card_power = teff.card_info(0)
    emit({"phase": "card", "name": card_name, "power_limit": card_power,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card_name, card_power


def lm_against(against: str | None, names=LM_KERNELS, timed=(), same_bits=True) -> int:
    """``python3 chip_smoke.py --lm-against DIR`` (``--conv1d [--against
    DIR]``: ``names`` conv1d, ``timed`` CONV1D_TIMED, ``same_bits`` off):
    ``lm_child`` of DIR's checkout and of this one (DIR, this, this, DIR
    when timing; this one alone without DIR); each child's line, the device
    ms of each timed case by checkout, the outputs that differ. With
    ``same_bits`` every output must be bitwise the same. Not the smoke
    test's contract."""
    import torch

    card = card_or_exit(torch)
    if card is None:
        return 2
    roots = ([against, ROOT, ROOT, against] if timed else [against, ROOT]) if against else [ROOT]
    summary, shas, failures = {}, {}, []
    for root in roots:
        src = os.path.join(os.path.abspath(root), "src")
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--lm-child", src,
                               ",".join(names), ",".join(timed)],
                              capture_output=True, text=True, timeout=1500, cwd=ROOT)
        child = next((json.loads(ln)["lm_child"] for ln in done.stdout.splitlines()
                      if ln.startswith('{"lm_child"')), None)
        emit({"phase": "lm_child", "checkout": root, "exit": done.returncode,
              **(child or {"stderr": done.stderr[-6000:]})})
        if done.returncode != 0 or child is None:    # the other runs still go
            failures.append(f"the LM kernels of {root} failed: "
                            f"{child['failures'] if child else done.stderr[-2000:]}")
            continue
        name = "this" if root == ROOT else "against"
        shas.setdefault(name, child["sha256"])
        for way in ("forward", "backward"):
            for label, t in child[way].items():
                row = summary.setdefault(f"{way}/{label}", {}).setdefault(
                    name, {"device_ms": [], "event_ms_inner": [], "ms": [], "host_us": []})
                for key in row:
                    row[key].append(t[key])
                summary[f"{way}/{label}"].update(bound_ms=t["bound_ms"],
                                                 library_ms=t["library_ms"])
    a, b = shas.get("against", {}), shas.get("this", {})
    differ = sorted(k for k in a if a[k] != b.get(k))
    print(f"{card[0]}, {card[1]}", flush=True)
    emit({"phase": "lm_against", "kernels": list(names), "against": against,
          "cases": len(b), "outputs": sum(map(len, b.values())),
          "same_cases": sorted(a) == sorted(b), "differ": differ, "times": summary,
          "wall_s": time.perf_counter() - START})
    if same_bits and against:
        failures += [] if sorted(a) == sorted(b) and not differ else [
            f"the f32 LM kernels differ from {against}'s: {differ}"]
    require(not failures, "; ".join(failures))
    return 0


def lm_bf16_alone() -> int:
    """``python3 chip_smoke.py --lm-bf16``: the LM kernels alone on one card,
    for work on their storage dtypes. Builds the six LM sources at f32 and
    bf16, holds every forward and backward case to its plain version at f32
    (as the smoke test's phases 3b and 4b' do), then runs the bf16 phase
    (``lm_bf16_phase``: the cases at bf16, Zamba2 served and trained at bf16,
    the times). Not the smoke test's contract."""
    import torch

    card = card_or_exit(torch)
    if card is None:
        return 2
    from repro_torch.core import teff
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    builds = build.compile_many(lm_instances())
    lm_ptx = {b.name: ptxas_by_function(b.log) for b in builds}
    emit({"phase": "build_lm", "wall_s": time.perf_counter() - t0, "ptxas": lm_ptx,
          "seconds": {b.name: b.seconds for b in builds}})
    lm_cases = lm_kernel_cases(torch, dev, torch.Generator(device="cpu").manual_seed(20260714))
    err = check_lm_cases(torch, lm_cases)
    train_cases, train_err = check_train_kernels(
        torch, dev, torch.Generator(device="cpu").manual_seed(20261018))
    lm16, train16, err16 = lm_bf16_phase(torch, dev, lm_cases, train_cases, strict=False)
    times_lm_bf16(torch, teff, teff.device_spec(0), lm_cases, train_cases, lm_ptx, lm16,
                  train16)
    print(f"{card[0]}, {card[1]}", flush=True)
    emit({"phase": "lm_bf16_alone", "ok": True, "max_abs_err": {**err, **train_err},
          "max_abs_err_bf16": err16, "wall_s": time.perf_counter() - START})
    return 0


# --bwd-probes: variants of the attention and SSD backward sources, each a
# list of (regular expression, replacement, matches wanted; None: at least
# one) applied to the source with tf32x3.cuh inlined. "1xtf32" keeps only
# hi·hi of every product, a single TF32 product a step: the control that
# the on-card check (TRAIN_TOL, TRAIN_TC_LIMIT) must reject. The others take
# one part out of the SSD chunk kernel, for its time alone: every product
# ("no_products"), the cp.async copies into shared memory ("no_loads"), the
# decays' exponentials ("no_exp"), the read-modify-write of the slice's dB
# and dC rows ("no_rmw"). Their outputs are wrong; only their times count.
_MMA3_LO = r"  mma_tf32\(d, al, b0h, b1h\);\n  mma_tf32\(d, ah, b0l, b1l\);\n"
BWD_VARIANTS = {
    "1xtf32": [(_MMA3_LO, "", 1)],
    "no_products": [(_MMA3_LO + r"  mma_tf32\(d, ah, b0h, b1h\);\n", "", 1)],
    "no_loads": [(r'asm volatile\("cp\.async\.c[ag]\.shared\.global[^;]*;[^;]*;', "", 2)],
    "no_exp": [(r"exp2f\(", "(", None)],
    "no_rmw": [(r"if \(!first\) \{", "if (false) {", 1)],
}
BWD_PROBED = {"attention": ("1xtf32",), "ssd": tuple(BWD_VARIANTS)}


def bwd_variant(source: str, variant: str) -> str:
    for pattern, repl, want in BWD_VARIANTS[variant]:
        got = len(re.findall(pattern, source))
        require(got == want if want is not None else got > 0,
                f"bwd variant {variant}: {pattern!r} matched {got} times, not {want}")
        source = re.sub(pattern, repl, source)
    return source


def bwd_probes() -> int:
    """``python3 chip_smoke.py --bwd-probes``: what the attention and SSD
    backward kernels' on-card check and time rest on, for work on them.
    Holds the kernels to their plain versions at every TRAIN_CASE_SHAPES
    case (as check_train_kernels, each case's worst error over its largest
    gradient beside TRAIN_TC_LIMIT); holds the 1xTF32 control (BWD_VARIANTS)
    at the same cases and says which check rejects it where; then times,
    at Zamba2's training shapes, each variant beside the kernel as it is
    (in turns: the kernel, each variant, the kernel), with the profiler's
    split of the call and ptxas's registers and spills of each variant.
    Exits 0 when the kernels pass and the control is rejected at every case
    whose gradients are not all 0."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import teff
    from repro_torch.kernels import attention, build, ssd

    dev = torch.device("cuda", 0)
    card_name, card_power = teff.card_info(0)
    emit({"phase": "card", "name": card_name, "power_limit": card_power,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    mods = {"attention": attention, "ssd": ssd}
    sources = {}
    for k, m in mods.items():
        text = build.read_source(m.BWD_SOURCE)
        sources[k, "kernel"] = text
        sources.update({(k, v): bwd_variant(text, v) for v in BWD_PROBED[k]})
    t0 = time.perf_counter()
    builds = build.compile_many([(f"{k}_bwd", text) for (k, _), text in sources.items()]
                                + [(k, build.read_source(m.SOURCE)) for k, m in mods.items()])
    libs = {kv: build.Library(f"{kv[0]}_bwd", text, mods[kv[0]]._BWD_ARGTYPES)
            for kv, text in sources.items()}
    emit({"phase": "bwd_probes_build", "wall_s": time.perf_counter() - t0,
          "ptxas": {f"{k}/{v}": ptxas_by_function(b.log)
                    for (k, v), b in zip(sources, builds)}})

    shapes = {k: v if k in mods else {} for k, v in TRAIN_CASE_SHAPES.items()}
    cases = train_kernel_cases(torch, dev, torch.Generator(device="cpu").manual_seed(20261018),
                               shapes)
    originals = {k: m.bwd_library for k, m in mods.items()}
    failures, control = [], {}
    try:
        for label, case in cases.items():
            k = case["name"]
            row, fails = train_case_report(torch, label, case, True)
            emit(row)
            failures += fails
            mods[k].bwd_library = lambda bf16=False, lib=libs[k, "1xtf32"]: lib
            crow, cfails = train_case_report(torch, label, case, True)
            mods[k].bwd_library = originals[k]
            parts = case["parts"]
            control[label] = {
                "worst_err_over_scale": crow["worst_err_over_scale"],
                "kernel_worst_err_over_scale": row["worst_err_over_scale"],
                "scale": crow["scale"],
                "train_tol_rejects": not all(crow[p]["ok"] for p in parts),
                "tc_limit_rejects": any("above" in f for f in cfails),
                "bitwise_twice": crow["bitwise_twice"]}
            if crow["scale"] > 0 and not cfails:
                failures.append(f"1xtf32 control of {k}_bwd ({label}) passed the check")
        emit({"phase": "bwd_probes_control", "card": card_name, "power_limit": card_power,
              "train_tol": {k: TRAIN_TOL[k] for k in mods}, "tc_limit": TRAIN_TC_LIMIT,
              "cases": control})

        torch.backends.cudnn.allow_tf32 = False
        times = {}
        for label, case in cases.items():
            k = case["name"]
            if not label.endswith(TRAIN_TIMED):
                continue
            order = ["kernel", *BWD_PROBED[k], "kernel"]
            runs = {}
            for v in order:
                mods[k].bwd_library = lambda bf16=False, lib=libs[k, v]: lib
                runs.setdefault(v, []).append({
                    "ms": teff.measure(case["kernel"], iters=20, warmup=3).median_s * 1e3,
                    "split": launch_split(torch, case["kernel"])})
                mods[k].bwd_library = originals[k]
            times[label] = runs
        emit({"phase": "bwd_probes_times", "card": card_name, "power_limit": card_power,
              "times": times})
    finally:
        for k, m in mods.items():
            m.bwd_library = originals[k]
    print(f"{card_name}, {card_power}", flush=True)
    require(not failures, "; ".join(failures))
    emit({"phase": "bwd_probes", "ok": True, "wall_s": time.perf_counter() - START})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:] == ["--train-kernels"]:
            sys.exit(train_kernels_alone())
        if sys.argv[1:] == ["--bwd-probes"]:
            sys.exit(bwd_probes())
        if sys.argv[1:2] == ["--conv1d"]:
            sys.exit(lm_against(sys.argv[3] if sys.argv[2:3] == ["--against"] else None,
                                ["conv1d"], CONV1D_TIMED, same_bits=False))
        if sys.argv[1:] == ["--lm-bf16"]:
            sys.exit(lm_bf16_alone())
        if sys.argv[1:2] == ["--lm-against"]:
            sys.exit(lm_against(sys.argv[2]))
        if sys.argv[1:2] == ["--lm-child"]:
            sys.exit(lm_child(sys.argv[2], sys.argv[3].split(","),
                              [t for t in sys.argv[4].split(",") if t]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
