"""The all-parallel k-step kernel's layout, on the CPU.

``kernels/codegen_steps.py`` prints ``run_steps(k)`` of an all-parallel
program as one launch whose blocks of threads walk each phase's region (the
tile and its halo cone) in rounds of whole warps, keep every queue at the
frame's pitch (a tap is a base plus a constant) one step of planes shallower
than a marched layout's, and share one barrier among a sweep's stages. The
plan tests hold those rules: the cone of each tile, the queues' slots, the
shared memory, no round of a lone warp, two blocks resident. The rehearsal
tests run the printed C++ of GP's and porosity's fused kernels (every bc
that runs inside a launch, the mass and residual epilogues), FIG1's step
and a staggered rotation on one core (``kernels/rehearse.py``) at extents
with blocks wholly inside the core and blocks on the domain's edges, in the
chosen layouts, and hold each to the ``torch`` backend's ``run_steps(k)``
bitwise (sums within 1e-5), at f32 and at bf16; with a last chunk of one
plane they also hold that no load leaves the fields (``rehearse.run``
counts every ``__ldg`` outside them).
"""
import ctypes
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import codegen, codegen_steps, rehearse

from test_torch_coupled import VARIANTS, _variant, _variant_args
from test_torch_rehearse_steps import ALL_REDS, _assert_same, _outs, _staggered

# extents whose middle blocks lie wholly in the core in the chosen tiles
# (GP 32 x 16 cells, FIG1 32 x 32, porosity 224 x 1), the others on its edges
EXTENTS = {"fig1": (10, 72, 72), "porosity": (14, 600), "gp": (10, 40, 72)}
# the variants that rotate and whose bcs run inside a launch, at the k they take
STEPPED = {"porosity_fused[none]": (2, 3, 4), "porosity_fused[neumann]": (2, 3, 4),
           "porosity_fused[dirichlet]": (2, 3, 4), "porosity_fused[neumann]+err": (2, 3, 4),
           "gp_fused[none]": (2, 3), "gp_fused[neumann]": (2, 3), "gp_fused[dirichlet]": (2, 3),
           "gp_fused[none]+mass": (2, 3), "fig1_step": (2, 3, 4), "fig1_step+4red": (2, 3, 4)}


def _call(name, k):
    base = EXTENTS[VARIANTS[name][0]]
    kern = _variant(name, base)
    if name == "fig1_step+4red":
        kern = kern.with_reductions(ALL_REDS)
    f, sc = _variant_args(kern, base, np.random.RandomState(0))
    return kern, f, sc, kern.compiled(nsteps=k, **f, **sc)


@pytest.mark.parametrize("name", list(STEPPED))
def test_queues_hold_one_step_of_planes_less(name):
    """Every queue holds its readers' planes and one step of planes, a step
    less than a marched layout's queue, except where no barrier stands
    between its last reader of one step and its writer of the next (a
    stage-free program's first sweep read by its last, at k = 2)."""
    for k in STEPPED[name]:
        kern, f, sc, call = _call(name, k)
        pl, P = call.plan, call.shape.planes
        # the same program marched along its first axis (the all-parallel
        # layout's own axes), planned by a marched layout's rule
        marched = dataclasses.replace(call.program,
                                      layout=codegen.march_layout(call.program.ndim, 0))
        twin = codegen_steps.plan(marched, kern.rotations, k, call.shape)
        assert [ph.ext for ph in pl.phases] == [ph.ext for ph in twin.phases]
        for ph, old in zip(pl.phases[:-1], twin.phases[:-1]):
            hazard = not call.program.stages and k == 2 and ph.sweep == 0
            assert ph.slots == old.slots - (0 if hazard else P), (name, k, ph.name)
        # one barrier a sweep's stages share, one after its outputs
        bars = sum(ph.barrier for ph in pl.phases)
        assert bars == k * (2 if call.program.stages else 1) - 1, (name, k)


def test_halo_cone_of_the_tiles():
    """The cells every phase computes over the tile's, less 1: GP at k = 2
    computes 31% more than two cone-free sweeps in its 32 x 16 tile (52% in
    the 32 x 8 tile of the layout before), FIG1 at k = 4 20% in 32 x 32,
    porosity at k = 4 2% in 224 x 1."""
    def cone(call):
        pl, sh = call.plan, call.shape
        return sum(math.prod(pl.region(ph, sh)) for ph in pl.phases) / (
            len(pl.phases) * math.prod(sh.tile)) - 1

    gp = _call("gp_fused[none]", 2)[3]
    assert gp.shape.tile == (32, 16)
    assert cone(gp) == pytest.approx((22 * 38 + 20 * 36 + 18 * 34 + 16 * 32) / (4 * 512) - 1)
    assert cone(gp) < 0.31
    fig1 = _call("fig1_step", 4)[3]
    assert fig1.shape.tile == (32, 32) and cone(fig1) == pytest.approx(
        (38 ** 2 + 36 ** 2 + 34 ** 2 + 32 ** 2) / (4 * 1024) - 1)
    por = _call("porosity_fused[neumann]", 4)[3]
    assert por.shape.tile == (224, 1) and cone(por) < 0.03


def _typed_call(name, k, dt):
    """:func:`_call`'s kernel with its fields stored as ``dt``."""
    kern, f, sc, _ = _call(name, k)
    kern = kern.with_dtype(dt)
    f = {n: t.to(dt) for n, t in f.items()}
    return kern, kern.compiled(nsteps=k, **f, **sc)


_QUEUE = re.compile(r"(float|__nv_bfloat16)\* const q\w+ = (?:reinterpret_cast<\w+\*>\()?"
                    r"smem \+ (\d+)\)?;  // (\d+) x (\d+) x (\d+)")


@pytest.mark.parametrize("name", list(STEPPED))
def test_shared_memory_and_rounds(name):
    """The printed queues follow one another in shared memory, each its
    slots of its region's rows at the frame's pitch (2-byte outputs at half
    the words), and the dynamic bytes end at the last; ``shared_bytes`` is
    those and the reduction fold's. Every round is whole warps, and no
    phase ends on a round of one warp."""
    for k in STEPPED[name]:
        for dt in (torch.float32, torch.bfloat16):
            kern, call = _typed_call(name, k, dt)
            pl, sh, prog = call.plan, call.shape, call.program
            assert call.dtype == dt
            text = codegen_steps.cuda_source(prog, kern.rotations, k, sh, dt)
            queues = _QUEUE.findall(text)
            assert len(queues) == sum(1 if ph.stage is not None else len(prog.outputs)
                                      for ph in pl.phases[:-1])
            end = 0
            for ctype, at, slots, rows, pitch in queues:
                assert int(at) == end, (name, k, dt, at)
                item = 4 if ctype == "float" else 2
                end += -(-int(slots) * int(rows) * int(pitch) * item // 4)
            assert re.search(rf"constexpr int kShared = {4 * end};", text)
            fold = len(prog.reductions) * sh.threads // 32
            assert codegen_steps.shared_bytes(prog, pl, sh, dt) == 4 * (end + fold)
            for ph in pl.phases:
                n = math.prod(pl.region(ph, sh))
                r, width = codegen_steps.rounds(pl, ph, sh)
                assert width % 32 == 0 and width <= sh.threads and r * width >= n
                assert r == 1 or n - (r - 1) * width > 32, (name, k, ph.name)


# bytes of shared memory worked by hand from the plans: GP k = 2 (32 x 16
# tile, pitch 38): s0t0 4 slots x 22 rows, s0o 6 x 20 for each of 2 outputs,
# s1t0 4 x 18; porosity k = 2 (pitch 228, one row): s0t0 4, s0t1 5, s0o 8
# for each of 2, s1t0 4, s1t1 5 slots; FIG1 k = 2 (pitch 34): s0o 6 x 34
HAND_WORKED = {
    ("gp_fused[none]", "f32"): 4 * 38 * (4 * 22 + 2 * 6 * 20 + 4 * 18),
    ("gp_fused[none]", "bf16"): 4 * 38 * (4 * 22 + 6 * 20 + 4 * 18),
    ("porosity_fused[neumann]", "f32"): 4 * 228 * (4 + 5 + 2 * 8 + 4 + 5),
    ("porosity_fused[neumann]", "bf16"): 4 * 228 * (4 + 5 + 8 + 4 + 5),
    ("fig1_step", "f32"): 4 * 6 * 34 * 34,
    ("fig1_step", "bf16"): 2 * 6 * 34 * 34,
}


@pytest.mark.parametrize("name,tag", list(HAND_WORKED))
def test_shared_bytes_of_hand_worked_layouts(name, tag):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    kern, call = _typed_call(name, 2, dt)
    assert codegen_steps.shared_bytes(call.program, call.plan, call.shape, dt) == \
        HAND_WORKED[(name, tag)]


@pytest.mark.parametrize("name", list(STEPPED))
def test_two_blocks_resident(name):
    """Every variant keeps at least two blocks and 16 warps resident an SM
    at k <= 3: shared memory holds them, and ``__launch_bounds__`` caps the
    registers for them."""
    for k in (k for k in STEPPED[name] if k <= 3):
        kern, f, sc, call = _call(name, k)
        sh = call.shape
        regs = 65536 // (sh.threads * sh.min_blocks)
        blocks = codegen_steps.resident_blocks(call.program, kern.rotations, k, sh, regs)
        assert sh.min_blocks >= 2 and blocks >= 2 and blocks * sh.threads >= 512, (name, k, sh)


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _rehearse(kern, f, sc, k, xc):
    want, want_reds = _outs(kern, kern.run_steps(k, **f, **sc))
    call = kern.compiled(nsteps=k, **f, **sc)
    assert call.shape.block and not call.program.layout
    got, reds = rehearse.run(call, f, sc, xc=xc)
    _assert_same(kern, got, reds, want, want_reds)


CASES = [("gp_fused[none]", 2, "f32"), ("gp_fused[neumann]", 2, "f32"),
         ("gp_fused[dirichlet]", 3, "f32"), ("gp_fused[none]+mass", 2, "f32"),
         ("gp_fused[none]+mass", 3, "bf16"), ("gp_fused[neumann]", 2, "bf16"),
         ("porosity_fused[none]", 3, "f32"), ("porosity_fused[neumann]", 4, "f32"),
         ("porosity_fused[dirichlet]", 2, "f32"), ("porosity_fused[neumann]+err", 3, "f32"),
         ("porosity_fused[neumann]+err", 2, "bf16"), ("fig1_step", 4, "f32"),
         ("fig1_step+4red", 2, "f32"), ("fig1_step+4red", 3, "bf16")]


@pytest.mark.parametrize("name,k,tag", CASES)
def test_printed_layout_equals_run_steps(cxx, name, k, tag):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    base = EXTENTS[VARIANTS[name][0]]
    kern = _variant(name, base)
    if name == "fig1_step+4red":
        kern = kern.with_reductions(ALL_REDS)
    kern = kern.with_dtype(dt)
    f, sc = _variant_args(kern, base, np.random.RandomState(1))
    f = {n: t.to(dt) for n, t in f.items()}
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    _rehearse(kern, f, sc, k, xc=5)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_printed_staggered_rotation_equals_run_steps(cxx, tag):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    rng = np.random.RandomState(2)
    kern = _staggered().with_dtype(dt)
    T = torch.tensor(rng.rand(13, 500).astype(np.float32)).to(dt)
    q = torch.tensor(rng.rand(12, 500).astype(np.float32)).to(dt)
    _rehearse(kern, {"T2": T.clone(), "q2": q.clone(), "T": T, "q": q}, {"dt": 1e-3}, 3, xc=4)


# a last chunk of one plane, shorter than a step and its ring: the fast
# path's cells off the core must load at the step's own planes
SHORT_LAST_CHUNK = [("gp_fused[none]", 2, 3), ("gp_fused[neumann]", 3, 3),
                    ("fig1_step", 4, 3), ("porosity_fused[neumann]", 4, 13)]


@pytest.mark.parametrize("name,k,xc", SHORT_LAST_CHUNK)
def test_printed_layout_loads_only_its_fields(cxx, name, k, xc):
    """Each field lies in the middle of a NaN buffer (``rehearse.run``),
    and no load of the printed kernel falls outside the fields."""
    base = EXTENTS[VARIANTS[name][0]]
    assert base[0] % xc == 1
    kern = _variant(name, base)
    f, sc = _variant_args(kern, base, np.random.RandomState(3))
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    _rehearse(kern, f, sc, k, xc=xc)


def test_rehearsal_counts_loads_outside_the_fields(cxx):
    lib = rehearse._compile(rehearse._SHIM + 'extern "C" float probe(const float* p, int i) '
                            "{ return __ldg(p + i); }\n", "probe")
    t = rehearse._guarded(torch.arange(6, dtype=torch.float32))
    lo, hi = (ctypes.c_int64 * 1)(t.data_ptr()), (ctypes.c_int64 * 1)(t.data_ptr() + 24)
    lib.rehearse_inputs(1, lo, hi)
    lib.probe.argtypes, lib.probe.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_float
    lib.rehearse_stray.restype = ctypes.c_long
    assert [lib.probe(t.data_ptr(), i) for i in (0, 5)] == [0.0, 5.0]
    assert lib.rehearse_stray() == 0
    assert [lib.probe(t.data_ptr(), i) for i in (6, -1)] == [0.0, 0.0]
    assert lib.rehearse_stray() == 2
