"""The pair layout of the all-parallel kernel for 2-byte fields, on the CPU.

``kernels/codegen_pairs.py`` prints the generated single-step kernel with
``vec`` (2 or 4) adjacent cells of the contiguous axis a thread: loads,
conversions and stores a word at a time, stages ``vec`` elements a thread,
reductions folded in the one-cell layout's order. ``rehearse`` runs the
printed C++ on the CPU (bf16/f16 and their packed conversions as integer
arithmetic on their bits), so each redesigned kernel (porosity's and GP's
fused kernels with every bc and epilogue, at bf16 and f16) must equal the
``torch`` backend bitwise (sums within 1e-5), and the one-cell layout
launched with the same chunks bitwise, sums too. An odd contiguous extent
or a field at an address off a word's alignment (a view at an odd offset)
takes the one-cell layout, which ``launch_info`` names. Every source but
the all-parallel k-step kernels' (``kernels/codegen_steps.py``, redesigned
after the pair layout) is byte-identical to the printers' before that
redesign, the pair layouts, the marched kernels and the slab k-step ones
included: ``tests/test_torch_pairs_sources.json`` holds the digests of
:func:`printed_sources` as those printers gave them, written by

    PYTHONPATH=src python tests/test_torch_pairs.py tests/test_torch_pairs_sources.json

from that tree (this module imports nothing the tree did not have).
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import codegen, rehearse, stencil
from repro_torch.launch import tune_stencil

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_coupled import VARIANTS, _variant, _variant_args  # noqa: E402

LOW = {"bf16": torch.bfloat16, "f16": torch.float16}
K = codegen.KernelShape
REDESIGNED = [f"porosity_fused[{bc}]" for bc in ("none", "neumann", "dirichlet", "periodic")] \
    + ["porosity_fused[neumann]+err"] \
    + [f"gp_fused[{bc}]" for bc in ("none", "neumann", "dirichlet", "periodic")] \
    + ["gp_fused[none]+mass"]
# even contiguous extents: a face, a ring and a partial tile in each block row,
# two blocks along z for porosity
EVEN = {"porosity": (14, 300), "gp": (7, 10, 36)}


# the sources of the byte-identity check: every coupled variant (FIG1's
# three among them) at even contiguous extents, each march fed enough planes
SOURCE_BASES = {"fig1": (9, 10, 36), "porosity": (13, 20), "gp": (16, 16, 36)}
SOURCE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def printed_sources():
    """``{key: (source, pair)}``: the single step, ``run_steps(2)`` and each
    march axis (single step and k = 2) of every variant at f32, bf16 and
    f16; ``pair`` is true for a pair layout."""
    out = {}
    rng = np.random.RandomState(0)
    for name, v in VARIANTS.items():
        base = SOURCE_BASES[v[0]]
        for tag, dt in SOURCE_DTYPES.items():
            kern = _variant(name, base).with_dtype(dt)
            f, sc = _variant_args(kern, base, rng)
            f = {n: t.to(dt) for n, t in f.items()}
            calls = {"step": lambda k: k.compiled(**f, **sc)}
            if kern.rotations:
                calls["k2"] = lambda k: k.compiled(nsteps=2, **f, **sc)
            for a in range(len(base)):
                calls[f"m{a}"] = lambda k, a=a: k.marched(a).compiled(**f, **sc)
                if kern.rotations:
                    calls[f"m{a}k2"] = lambda k, a=a: k.marched(a).compiled(nsteps=2, **f, **sc)
            for kind, make in calls.items():
                try:
                    call = make(kern)
                except ValueError:          # a march along a staggered axis
                    continue
                out[f"{name}|{tag}|{kind}"] = (call.source, getattr(call.shape, "vec", 1) > 1)
    return out


def digests(sources) -> dict:
    return {k: hashlib.sha256(src.encode()).hexdigest() for k, (src, _) in sources.items()}


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _case(name, base, dt, rng):
    kern = _variant(name, base).with_dtype(dt)
    f, sc = _variant_args(kern, base, rng)
    return kern, {n: t.to(dt) for n, t in f.items()}, sc


def _want(kern, f, sc):
    res = kern(**f, **sc)
    want, reds = res if kern.reductions else (res, {})
    return ({kern.outputs[0]: want} if len(kern.outputs) == 1 else want), reds


def _bits(t):
    return t.view(torch.int16)


def _held(kern, got, reds, want, want_reds):
    for o in kern.outputs:
        assert got[o].dtype == want[o].dtype and torch.equal(_bits(got[o]), _bits(want[o])), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert float(reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


@pytest.mark.parametrize("name", REDESIGNED)
@pytest.mark.parametrize("tag", list(LOW))
def test_printed_pair_kernel_equals_torch_backend(cxx, name, tag, rng):
    solver = name.split("_")[0]
    kern, f, sc = _case(name, EVEN[solver], LOW[tag], rng)
    want, want_reds = _want(kern, f, sc)
    call = kern.compiled(**f, **sc)
    assert call.shape == codegen.pair_shape(call.program)
    assert "narrow2(" in call.source and "load_word(" in call.source
    got, reds = rehearse.run(call, f, sc, xc=3)
    _held(kern, got, reds, want, want_reds)
    assert kern.launch_info[EVEN[solver]]["layout"] == codegen.layout_name(call.shape)


# the other programs that take the pairs (PAIRS: stage-free 3-D updates),
# each at one storage dtype
OTHERS = [("fig1_step", (9, 10, 36), "bf16"), ("fig1_step+err", (9, 10, 36), "f16"),
          ("fig1_step+4red", (9, 10, 36), "bf16"), ("gp_step_re", (7, 10, 36), "f16"),
          ("gp_step_im", (7, 10, 36), "bf16")]


@pytest.mark.parametrize("name,base,tag", OTHERS)
def test_other_printed_pair_kernels_equal_torch_backend(cxx, name, base, tag, rng):
    kern, f, sc = _case(name, base, LOW[tag], rng)
    want, want_reds = _want(kern, f, sc)
    call = kern.compiled(**f, **sc)
    assert call.shape == codegen.pair_shape(call.program) and call.shape.vec > 1
    got, reds = rehearse.run(call, f, sc, xc=3)
    _held(kern, got, reds, want, want_reds)


@pytest.mark.parametrize("name,base,shapes", [
    ("gp_fused[none]+mass", (7, 10, 36), [((16, 8), 4, 8, 2), ((8, 8), 2, 8, 4)]),
    ("porosity_fused[neumann]+err", (9, 300), [((128, 1), 4, 8, 2), ((64, 1), 4, 8, 4),
                                               ((128, 1), 2, 8, 4)])])
def test_pair_layout_equals_one_cell_layout_bitwise(cxx, name, base, shapes, rng):
    """Launched with the same chunks, every pair layout equals the one-cell
    layout bit for bit, its reductions too: each cell folds in the same
    order (for a sum: the same cells per block, 256)."""
    kern, f, sc = _case(name, base, torch.bfloat16, rng)
    ir = kern.compiled(**f, **sc).ir
    one = stencil.StencilCall(ir, kern.label, kern.bc, codegen.kernel_shape(codegen.lower(
        ir, kern.bc)), dtype=torch.bfloat16)
    assert one.shape.vec == 1
    for tile, planes, blocks, vec in shapes:
        shape = K(tile, planes, blocks, vec=vec)
        call = stencil.StencilCall(ir, kern.label, kern.bc, shape, dtype=torch.bfloat16)
        for xc in (3, 5):
            got, reds = rehearse.run(call, f, sc, xc=xc)
            want, want_reds = rehearse.run(one, f, sc, xc=xc)
            for o in kern.outputs:
                assert torch.equal(_bits(got[o]), _bits(want[o])), (shape, o)
            for n in kern.reductions:
                same_cells = shape.cells[0] * shape.cells[1] == 256
                if same_cells or kern.reductions[n].combine == "max":
                    assert float(reds[n]) == float(want_reds[n]), (shape, n)


def test_odd_extent_takes_the_one_cell_layout(cxx, rng):
    kern, f, sc = _case("porosity_fused[neumann]", (13, 21), torch.bfloat16, rng)
    call = kern.compiled(**f, **sc)
    assert call.shape.vec == 1 and call.shape == codegen.kernel_shape(call.program)
    assert call.source == codegen.cuda_source(call.program, call.shape, torch.bfloat16)
    got, _ = rehearse.run(call, f, sc, xc=3)
    want, _ = _want(kern, f, sc)
    for o in kern.outputs:
        assert torch.equal(_bits(got[o]), _bits(want[o])), o
    assert kern.launch_info[(13, 21)]["layout"] == "256x1/p4/b5"


@pytest.mark.parametrize("tag", list(LOW))
def test_misaligned_view_takes_the_one_cell_layout(cxx, tag, rng):
    """Fields at an odd offset of their storage (contiguous views whose
    addresses are off a 4-byte word) launch the one-cell layout of the same
    program, under the same label, and say so; aligned ones the pairs."""
    dt = LOW[tag]
    base = (14, 20)
    kern, f, sc = _case("porosity_fused[neumann]+err", base, dt, rng)
    want, want_reds = _want(kern, f, sc)
    call = kern.compiled(**f, **sc)
    assert call.shape == codegen.pair_shape(call.program)
    got, reds = rehearse.run(call, f, sc, xc=3)
    _held(kern, got, reds, want, want_reds)
    assert kern.launch_info[base]["layout"] == codegen.layout_name(call.shape)
    views = {}
    for n, t in f.items():
        views[n] = torch.empty(t.numel() + 1, dtype=dt)[1:].view(base)
        views[n].copy_(t)
        assert views[n].is_contiguous() and views[n].data_ptr() % 4 == 2
    assert call.layout_call(views) is not call
    assert call.layout_call(views).shape == codegen.kernel_shape(call.program)
    got, reds = rehearse.run(call, views, sc, xc=3)
    _held(kern, got, reds, want, want_reds)
    assert kern.launch_info[base]["layout"] == "256x1/p4/b5"
    # a view 4 bytes off an 8-byte word: enough for 2 cells a thread, not 4
    for n, t in f.items():
        views[n] = torch.empty(t.numel() + 2, dtype=dt)[2:].view(base)
        views[n].copy_(t)
    one = call.layout_call(views)
    assert (one is call) == (call.shape.vec == 2)
    got, reds = rehearse.run(call, views, sc, xc=3)
    _held(kern, got, reds, want, want_reds)


def test_pair_rules():
    """Which programs take the pairs, and where the pairs fit."""
    from repro_torch.kernels import codegen_pairs

    kern, f, sc = _case("gp_fused[none]", (7, 10, 36), torch.bfloat16, np.random.RandomState(0))
    call = kern.compiled(**f, **sc)
    p = call.program
    assert codegen.kernel_shape(p) == codegen.KernelShape((32, 8), 4, 5)
    assert codegen.kernel_shape(p, torch.float16) == codegen.pair_shape(p)
    assert codegen.kernel_shape(p, torch.float32) == codegen.kernel_shape(p)
    assert codegen.layout_name(codegen.pair_shape(p)).endswith("/v2")
    assert codegen.pair_shape(p).cells == (32, 8)
    assert codegen.layout_name(K((32, 8), 4, 5)) == "32x8/p4/b5"
    fig1 = _variant("fig1_step").with_dtype(torch.bfloat16)
    fp = fig1.compiled(**{n: (9, 10, 36) for n in ("T2", "T", "Ci")}, lam=1.0, dt=1.0, _dx=1.0,
                       _dy=1.0, _dz=1.0).program
    assert codegen.kernel_shape(fp, torch.bfloat16) == codegen.PAIRS[(3, False, False)]
    fluxes, ff, fsc = _case("porosity_fluxes", (14, 20), torch.bfloat16, np.random.RandomState(0))
    assert codegen.pair_shape(fluxes.compiled(**ff, **fsc).program) is None
    ext = [(7, 10, 36)]
    assert codegen_pairs.fits(p, 2, ext, [(360, 36, 1)])
    assert codegen_pairs.fits(p, 4, ext, [(360, 36, 1)])
    assert not codegen_pairs.fits(p, 2, [(7, 10, 35)], [(350, 35, 1)])
    assert not codegen_pairs.fits(p, 4, [(7, 10, 34)], [(340, 34, 1)])
    marched = kern.marched(2).compiled(**f, **sc).program
    assert not codegen_pairs.fits(marched, 2, ext, [(360, 36, 1)])
    assert codegen_pairs.aligned_ptrs([64, 4, 8], 2, 2)
    assert not codegen_pairs.aligned_ptrs([64, 6], 4, 2)
    odd = kern.compiled(**{n: (7, 10, 35) for n in f}, **sc)
    assert odd.shape.vec == 1
    with pytest.raises(ValueError, match="does not fit"):
        stencil.StencilCall(odd.ir, kern.label, kern.bc, codegen.pair_shape(p),
                            dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2-byte"):
        codegen.cuda_source(p, codegen.pair_shape(p), torch.float32)


def test_sources_byte_identical_outside_the_pair_layout():
    """Every single-step source (the pair layouts among them: exactly the
    3-D and the staged single steps at bf16 and f16, porosity's and GP's
    fused kernels, GP's two launches and FIG1's three), every marched one
    and every k-step kernel marching the contiguous axis (a slab) equals
    the printers' before the all-parallel k-step kernel was redesigned;
    the changed sources are exactly those all-parallel k-step kernels
    (``run_steps(2)`` of every variant that rotates, at every dtype)."""
    with open(os.path.join(os.path.dirname(__file__), "test_torch_pairs_sources.json")) as fh:
        before = json.load(fh)
    sources = printed_sources()
    now = digests(sources)
    assert set(now) == set(before)
    pairs = {k for k, (_, pair) in sources.items() if pair}
    assert pairs == {f"{n}|{t}|step" for n in REDESIGNED + [n for n, _, _ in OTHERS] for t in LOW}
    k_steps = {k for k in now if k.endswith("|k2")}
    changed = {k for k in now if now[k] != before[k]}
    assert changed == k_steps, sorted(changed ^ k_steps)
    assert len(now) - len(k_steps) == 258 and len(k_steps) == 33


def test_timing_parts_of_the_all_parallel_kernel():
    """``part`` "load" keeps the loads and drops compute and stores;
    "compute" keeps compute and drops the core cells' stores; both fold
    what they drop into a value stored only if it is 1e38."""
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kern, f, sc = _case("gp_fused[none]+mass", (7, 10, 36), dt, np.random.RandomState(0))
        call = kern.compiled(**f, **sc)
        whole = codegen.cuda_source(call.program, call.shape, dt)
        load = codegen.cuda_source(call.program, call.shape, dt, part="load")
        compute = codegen.cuda_source(call.program, call.shape, dt, part="compute")
        assert whole == call.source and "sink" not in whole
        for src in (load, compute):
            assert "if (sink == 1.0e38f)" in src
        core = load.split("auto core = ", 1)[1].split("};", 1)[0]
        assert "sink +=" in core and "acc0" not in core and " e0" not in core
        assert "acc0" in compute.split("auto core = ", 1)[1].split("};", 1)[0]


def test_sass_loop_counts():
    """``tune_stencil.sass_loop`` on a loop of a stage (one partial
    iteration skipped by a forward branch), a barrier and two blocks after
    it, the one with the most stores taken as the core."""
    lines = ["        /*0000*/                   MOV R1, c[0x0][0x28] ;",
             "        /*0010*/                   LDG.E.U16 R2, desc[UR4][R4.64] ;",
             "        /*0020*/               @P0 BRA 0x50 ;",
             "        /*0030*/                   LDG.E.U16 R3, desc[UR4][R4.64+0x2] ;",
             "        /*0040*/                   FADD R3, R3, R2 ;",
             "        /*0050*/                   STS [R5], R3 ;",
             "        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
             "        /*0070*/               @P1 BRA 0xb0 ;",
             "        /*0080*/                   LDS R6, [R5] ;",
             "        /*0090*/                   F2FP.BF16.F32.PACK_AB R6, R6, R6 ;",
             "        /*00a0*/                   STG.E desc[UR4][R8.64], R6 ;",
             "        /*00b0*/                   IADD3 R9, R9, 0x1, RZ ;",
             "        /*00c0*/              @!P2 BRA 0x0 ;",
             "        /*00d0*/                   EXIT ;"]
    got = tune_stencil.sass_loop("\n".join(lines), 2)
    assert got["loop"] == 13 and got["stage"] == 4 and got["core_block"] == 3
    assert got["per_cell"] == {"all": 3.5, "loads": 0.5, "stores": 0.5, "shared": 1.0,
                               "fp": 0.0, "convert": 0.5}


if __name__ == "__main__":
    with open(sys.argv[1], "w") as fh:
        json.dump(digests(printed_sources()), fh, indent=0, sort_keys=True)
        fh.write("\n")
