"""The march along the contiguous axis (the async slab), on the CPU.

A march along the fields' contiguous axis (3-D axis 2, 2-D axis 1) prints
the async slab (``codegen.KernelShape.async_copies``): each field the
update reads from device memory is copied into a plane queue in shared
memory by asynchronous copies a step ahead, and the outputs go out from a
step buffer a step later, both planes fastest; the single-step kernel
(``kernels/codegen.py``) and the k-step kernel (``kernels/codegen_steps.py``)
print it through the same emitters. ``repro_torch.kernels.rehearse`` runs
the printed C++ on the CPU with each copy held back until the thread's
wait and its destination NaN until then, so a read of a plane before its
copy landed shows.

Tolerances: within the port everything is bitwise. Every printed kernel
equals the ``torch`` backend (outputs bitwise, max reductions and counts
exact, sums within 1e-5 relative: the fold order differs), at f32, bf16
and f16, and each ``run_steps(k)`` equals k single steps. The odd shapes
cut every march into several chunks and the other axes into partial
tiles.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import codegen, codegen_steps, rehearse, stencil

from test_torch_coupled import _solver_kernel
from test_torch_streaming import SC3, _fields3, _hold, _outs, _port, _rehearse_k, _t

ALL_KINDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
             "m2": "sum_sq(T2)", "bad": "finite(T2)", "nin": "nan_count(T)"}
SHAPE = (9, 10, 33)
SOLVER_SC = dict(dtau=1e-3, g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0)


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _solver(solver, bc, base, rng, reductions=None):
    """A coupled solver's fused kernel marched along its contiguous axis,
    its fields (outputs as copies of their targets) and scalars."""
    kern = _solver_kernel(solver, base[0], 0, reductions, bc=bc).marched(len(base) - 1)
    names = list(inspect.signature(kern.fn).parameters)
    sc = {n: v for n, v in SOLVER_SC.items() if n in names}
    f = {n: torch.tensor((rng.rand(*base) * 0.01 + 0.005).astype(np.float32))
         for n in names if n not in sc}
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    return kern, f, sc


@pytest.mark.parametrize("xc", [None, 3])
@pytest.mark.parametrize("layout", ["async", "sync"])
def test_fig1_every_reduction_kind(cxx, layout, xc, rng):
    """FIG1's step with every reduction kind, the async slab and the
    synchronous one, whole-grid chunks and chunks of 3 planes."""
    f = _t(_fields3(rng, (13, 12, 33)))
    kern = _port(2, reductions=ALL_KINDS)
    call = kern.compiled(**f, **SC3)
    assert call.shape.slab and call.shape.async_copies
    if layout == "sync":
        call = stencil.StencilCall(call.ir, kern.label, kern.bc,
                                   codegen.slab_layout(call.program, False), march_axis=2)
        assert not call.shape.async_copies
    want, want_reds = _outs(kern, kern(**f, **SC3))
    _hold(kern, *rehearse.run(call, f, SC3, xc=xc), want, want_reds)


@pytest.mark.parametrize("bc", ["none", "neumann", "dirichlet", "periodic"])
def test_porosity_every_bc(cxx, bc, rng):
    """Porosity's fused kernel marched along axis 1 with every boundary
    condition and its convergence check."""
    # a periodic bc refuses fused reductions, as the reference's does
    reds = None if bc == "periodic" else {"err": "max_abs_diff(Pe2, Pe)"}
    kern, f, sc = _solver("porosity", bc, (13, 70), rng, reds)
    call = _rehearse_k(kern, f, sc, 1)
    assert call.march_axis == 1 and call.shape.async_copies and call.program.stages


def test_gp_marched_along_axis_2(cxx, rng):
    kern, f, sc = _solver("gp", "none", (7, 8, 20), rng, {"m": "sum_sq(re2)"})
    for k in (1, 2):
        call = _rehearse_k(kern, f, sc, k)
        assert call.march_axis == 2 and call.shape.slab and call.shape.async_copies


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_storage_dtypes(cxx, dtype, rng):
    """bf16 and f16 fields are widened on their way into the f32 queues;
    outputs round to storage in the step buffer."""
    f = _t(_fields3(rng, SHAPE), dtype)
    kern = _port(2, dtype=dtype, reductions={"err": "max_abs_diff(T2, T)", "bad": "finite(T2)"})
    for k in (1, 2):
        assert _rehearse_k(kern, f, SC3, k).dtype == dtype


@pytest.mark.parametrize("k", [2, 3])
def test_k_steps_bitwise_to_single_steps(cxx, k, rng):
    """``run_steps(k)`` along the contiguous axis, one launch of the k-step
    slab, against k rehearsed single-step slab launches."""
    a = _fields3(rng, SHAPE)
    f = _t(a)
    kern = _port(2)
    call = _rehearse_k(kern, f, SC3, k)
    assert call.shape.async_copies and call.nsteps == k and not call.march_fallback
    cur = dict(f)
    one = kern.compiled(**f, **SC3)
    for _ in range(k):
        out, _ = rehearse.run(one, cur, SC3)
        cur = {"T2": cur["T"], "T": out["T2"], "Ci": cur["Ci"]}
    got, _ = rehearse.run(call, f, SC3, xc=5)
    assert torch.equal(got["T2"], cur["T"])


def test_porosity_k_steps(cxx, rng):
    kern, f, sc = _solver("porosity", "neumann", (13, 70), rng)
    call = _rehearse_k(kern, f, sc, 2)
    assert call.shape.async_copies and codegen_steps.field_boxes(call.program, call.plan)


def test_staggered_field_beside_the_march(cxx, rng):
    """A field staggered along axis 0 while the march runs along the
    contiguous axis 1: its queue has extents of its own; a march along the
    staggered axis is refused."""
    from test_torch_streaming import _coupled2d, _coupled_args
    from repro_torch.core import fd2d, init_parallel_stencil

    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    a = _t(_coupled_args(rng, 21))
    for k in (1, 2):
        call = _rehearse_k(_coupled2d(ps, fd2d, 1), a, {"dtau": 1e-3}, k)
        assert call.shape.async_copies and len(call.classes) == 2
    with pytest.raises(ValueError, match="staggered"):
        _coupled2d(ps, fd2d, 0).compiled(**a, dtau=1e-3)


def test_fallback_shorter_than_the_queue(cxx, rng):
    """A contiguous axis shorter than the slab's plane queue launches the
    all-parallel kernel, bitwise all the same."""
    kern = _port(2)
    long = kern.compiled(**_t(_fields3(rng, (6, 8, 40))), **SC3)
    assert long.march_axis == 2 and long.queue_planes == long.shape.planes + long.lag + 2
    f = _t(_fields3(rng, (6, 8, long.queue_planes - 1)))
    call = _rehearse_k(kern, f, SC3, 1)
    assert call.march_fallback and call.march_axis is None and not call.shape.slab


def test_slab_shape_shared_memory():
    """The async slab takes dynamic shared memory above the 48 KB a block
    has statically, up to the 227 KB an H100 block can have; the
    synchronous slab stays within 48 KB."""
    shapes = {n: SHAPE for n in ("T2", "T", "Ci")}
    p = _port(2).compiled(**shapes, **SC3).program
    big = codegen.slab_shape(p, (32, 8), 16)
    assert big is not None and big.async_copies
    assert codegen.SHARED_LIMIT < codegen.shared_bytes(p, big) <= codegen.SM_SHARED
    assert codegen.slab_shape(p, (32, 8), 16, async_copies=False) is None
    assert codegen.shared_bytes(p, codegen.KernelShape((32, 16), 32, 1, True, True)) \
        > codegen.SM_SHARED
    assert codegen.slab_shape(p, (32, 16), 32) is None
    src = codegen.cuda_source(p, big)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert f"kShared = {codegen.shared_bytes(p, big)};" in src


def test_padding_spreads_the_banks():
    """A queue plane's words and the step buffer's row are padded so that a
    warp's copies and stores, planes fastest, fall in 32 banks."""
    for planes in (4, 8, 16, 32):
        for cells in (100, 128, 204, 340):
            words = codegen.plane_words(cells, planes)
            assert words >= cells
            lanes = {(p * words + g) % 32 for p in range(min(planes, 32))
                     for g in range(max(1, 32 // planes))}
            assert len(lanes) == 32
    shape = codegen.KernelShape((32, 4), 16, 1, True, True)
    row = codegen.out_row(shape)
    assert len({(p * row + e) % 32 for p in range(16) for e in range(2)}) == 32


def test_a_missing_wait_is_caught(cxx, rng):
    """The rehearsal performs each copy only at the thread's wait and holds
    its destination at NaN until then: a kernel printed without its waits
    reads NaN where the card might read stale planes."""
    f = _t(_fields3(rng, SHAPE))
    kern = _port(2)
    call = kern.compiled(**f, **SC3)
    text = rehearse.source(call)
    got, _ = rehearse.run(call, f, SC3)
    assert torch.equal(got["T2"], kern(**f, **SC3))
    broken = text.replace("    wait_copies();\n    __syncthreads();", "    __syncthreads();")
    assert broken != text
    bad, _ = rehearse.run(call, f, SC3, text=broken)
    assert bool(bad["T2"].isnan().any())
