"""The batched kernel (the sample axis of the generated ``@parallel``
kernel) printed as CUDA C++ and run on the CPU through
``kernels/rehearse.py``, against its plain version.

A batched launch steps every live sample of a stack of fields ``(B,
*grid)`` at once: each rotation pair's two buffers swapped per sample by
its parity, each output written in place into its own buffer, each sample's
scalars and divisors its own, dead samples not touched, and the partials
folded per sample. Every case must equal ``codegen.evaluate_batch_torch``
(the tap program on each live sample) bitwise, and each live sample the
``torch`` backend's single step on that sample's fields: buffers bitwise, a
dead sample's two buffers unchanged, max reductions bitwise, sums within
1e-5 (a sum reassociates over the blocks).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fd2d, fd3d, init_parallel_stencil
from repro_torch.ir.bc import BoundaryCondition
from repro_torch.kernels import codegen, rehearse, stencil

from test_torch_coupled import _field_shapes, _scalars, _variant

GUARDED = {"err": "max_abs_diff(T2, T)", "__finite": "finite(T2)", "s": "sum(T2)"}


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def diffusion_kernel(dtype=torch.float32, reductions=None, bc=None):
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype)

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, reductions=reductions, bc=bc)
    def diffusion(T2, T, dt, h, c):
        return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T)) / h
                - c * fd3d.inn(T)}

    return diffusion


def batch(rng, shapes: dict, b: int, dtype=torch.float32, scale=1.0, offset=0.0):
    return {n: torch.tensor((rng.rand(b, *s) * scale + offset).astype(np.float32)).to(dtype)
            for n, s in shapes.items()}


def check(call, kern, bufs, scalars, live, odd, flip, xc=None):
    """Rehearse one batched launch and hold it to the plain version and,
    sample by sample, to the torch backend's single step."""
    got, reds = rehearse.run_batch(call, bufs, scalars, live, odd, flip, xc=xc)
    want = {n: t.clone() for n, t in bufs.items()}
    want_reds = call.run_batch(want, scalars, live, odd, flip)      # CPU: the plain version
    for n in bufs:
        assert torch.equal(got[n], want[n]), n
    for b, (alive, par) in enumerate(zip(live.tolist(), odd.tolist())):
        if not alive:
            for n in bufs:
                assert torch.equal(got[n][b], bufs[n][b]), (n, b)     # untouched
            for n in reds or {}:
                assert float(reds[n][b]) == 0.0
            continue
        before = codegen.sample_fields(bufs, kern.rotations, b, par != bool(flip))
        after = codegen.sample_fields(got, kern.rotations, b, par != bool(flip))
        res = kern(**before, **scalars[b])
        outs, r = res if kern.reductions else (res, {})
        outs = {kern.outputs[0]: outs} if len(kern.outputs) == 1 else outs
        for o, t in outs.items():
            assert torch.equal(after[o], t), (o, b)
        for tgt in kern.rotations.values():
            assert torch.equal(after[tgt], before[tgt]), (tgt, b)     # a target is only read
        for n, v in r.items():
            if kern.reductions[n].combine == "max":
                assert float(reds[n][b]) == float(v) == float(want_reds[n][b]), (n, b)
            else:
                np.testing.assert_allclose(float(reds[n][b]), float(v), rtol=1e-5)
    return got, reds


@pytest.mark.parametrize("xc", [1, 3, None])
def test_batched_kernel_per_sample_scalars_divisors_and_dead_slots(cxx, rng, xc):
    kern = diffusion_kernel(reductions=GUARDED)
    shp = (9, 10, 33)
    call = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    assert call.label == "diffusion[err,__finite,s]/batched"
    assert call.divisors, "h divides a tensor: its reciprocal is a per-sample argument"
    b = 5
    bufs = batch(rng, {"T2": shp, "T": shp}, b)
    scalars = [{"dt": 0.05 + 0.01 * i, "h": 10.0 / (23 + i), "c": 0.1 * i} for i in range(b)]
    scalars[3] = None
    live = torch.tensor([True, True, False, False, True])
    odd = torch.tensor([False, True, True, False, True])
    for flip in (0, 1):
        check(call, kern, bufs, [s if live[i] else None for i, s in enumerate(scalars)],
              live, odd, flip, xc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_batched_kernel_two_byte_storage(cxx, rng, dtype):
    kern = diffusion_kernel(dtype, reductions=GUARDED)
    shp = (7, 8, 36)
    call = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    # the one-cell layout, measured for a guarded 3-D step at 2 bytes
    assert call.shape == codegen.BATCHED[(3, False, True, False)] and call.shape.vec == 1
    bufs = batch(rng, {"T2": shp, "T": shp}, 3, dtype)
    scalars = [{"dt": 0.1, "h": 0.7, "c": 0.2}, None, {"dt": 0.12, "h": 1.3, "c": 0.0}]
    check(call, kern, bufs, scalars, torch.tensor([True, False, True]),
          torch.tensor([True, False, False]), 1, xc=3)


def test_batched_periodic_wraps_within_each_sample(cxx, rng):
    """A periodic face takes its value across its own sample's domain: each
    sample holds different data, so a wrap into a neighbour shows."""
    kern = diffusion_kernel(bc={"T2": "periodic"})
    shp = (8, 9, 34)
    call = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    bufs = batch(rng, {"T2": shp, "T": shp}, 3)
    bufs["T"][1] += 5.0
    scalars = [{"dt": 0.1, "h": 1.0, "c": 0.0}] * 3
    check(call, kern, bufs, scalars, torch.ones(3, dtype=torch.bool),
          torch.tensor([False, True, False]), 0, xc=2)


@pytest.mark.parametrize("name,base", [("porosity_fused[neumann]+err", (33, 20)),
                                       ("porosity_fused[dirichlet]", (9, 12)),
                                       ("gp_fused[none]+mass", (7, 8, 35))])
def test_batched_staggered_and_coupled_programs(cxx, rng, name, base):
    """Porosity's fused update (two outputs, staggered fluxes in the launch,
    a boundary condition) and GP's (3-D, radius 2, staged), batched."""
    kern = _variant(name, base)
    sc = _scalars(kern)
    call = kern.batched_call(**_field_shapes(kern, base), **sc)
    assert call.program.stages
    bufs = batch(rng, _field_shapes(kern, base), 3, scale=0.01, offset=0.005)
    scalars = [dict(sc), dict(sc, **{k: 2 * v for k, v in sc.items()}), None]
    check(call, kern, bufs, scalars, torch.tensor([True, True, False]),
          torch.tensor([False, True, True]), 1, xc=3)


def test_batched_launch_counts_every_sample():
    kern = diffusion_kernel()
    call = kern.batched_call(T2=(128, 128, 128), T=(128, 128, 128), dt=0.1, h=1.0, c=0.0)
    one, sixteen = call.derive(132), call.derive(132, samples=16)
    assert sixteen.samples == 16 and sixteen.grid[:2] == one.grid[:2]
    # the column march: BATCH_COLUMN_WAVES waves of resident blocks over all
    # samples, not over each one
    assert call.shape.column and stencil.waves_of(call.shape, False, 4) == \
        stencil.BATCH_COLUMN_WAVES
    waves = sixteen.n_blocks / (stencil.BATCH_COLUMN_WAVES * call.shape.min_blocks * 132)
    assert 0.5 < waves < 2.0 and sixteen.grid[2] < one.grid[2]
    # the one-cell layout: BATCH_WAVES waves of resident blocks over all samples
    cells = stencil.StencilCall(call.ir, kern.label, kern.bc, codegen.KernelShape((32, 8), 2, 6),
                                batched=kern.rotations)
    one, sixteen = cells.derive(132), cells.derive(132, samples=16)
    waves = sixteen.n_blocks / (stencil.BATCH_WAVES * cells.shape.min_blocks * 132)
    assert 0.5 < waves < 2.0 and sixteen.grid[2] < one.grid[2]
    with pytest.raises(ValueError, match="grid limits"):
        stencil.derive_launch((4, 8, 32), 132, call.shape, samples=70000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_layout_by_kind_and_storage_width(dtype):
    """A batched program takes the layout measured for its kind (rank,
    stages, reductions) at its storage width; the guarded 3-D step takes the
    column march at 4 resident blocks at 4 bytes and 5 at 2; a kind not
    measured takes the single step's one-cell layout."""
    guarded = diffusion_kernel(dtype, reductions=GUARDED)
    call = guarded.batched_call(T2=(8, 8, 8), T=(8, 8, 8), dt=0.1, h=1.0, c=0.0)
    assert call.shape == codegen.BATCHED[(3, False, True, dtype.itemsize == 4)]
    assert call.shape.vec == 1 and call.shape.column
    assert call.shape.min_blocks == (4 if dtype == torch.float32 else 5)
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype, ndims=1)

    @ps.parallel(outputs=("U2",), rotations={"U2": "U"})
    def line(U2, U, a):
        return {"U2": U[1:-1] + a * (U[2:] - U[:-2])}

    one = line.batched_call(U2=(40,), U=(40,), a=0.5)
    assert one.shape == codegen.kernel_shape(one.program) and one.shape.vec == 1


def test_batched_source_printed_only_where_asked():
    kern = diffusion_kernel(reductions=GUARDED)
    shp = (8, 8, 8)
    single = kern.compiled(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    batched = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    assert "live[bs]" in batched.source and "live[" not in single.source
    assert single.source == codegen.cuda_source(single.program, single.shape)
    assert batched.lib_name != single.lib_name and batched.argtypes() != single.argtypes()


def test_batched_refusals():
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("A2",), rotations={"A2": "A"})
    def reads_output(A2, A):
        return {"A2": fd2d.inn(A) + fd2d.inn(A2)}

    with pytest.raises(ValueError, match="reads its outputs"):
        reads_output.batched_call(A2=(8, 8), A=(8, 8))
    kern = diffusion_kernel()
    shp = (8, 8, 8)
    with pytest.raises(ValueError, match="all-parallel"):
        kern.marched(0).batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    call = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    with pytest.raises(ValueError, match="one-cell all-parallel"):
        codegen.cuda_source(call.program, codegen.KernelShape((16, 8), 2, 6, vec=2),
                            torch.bfloat16, batched=kern.rotations)
    with pytest.raises(ValueError, match="rotating into a field"):
        codegen.check_batched(call.program, {"T2": "T2"})


# ---- the column march (kernels/codegen_columns.py) -------------------------
def column_call(kern, shp, dtype=torch.float32, planes=1, ahead=0, read_first=False):
    """The batched call of ``kern`` at ``shp`` in the column march, its y and
    z taps through ``__ldg``, its loads ``ahead`` planes further ahead;
    ``read_first`` lists T before T2, as a batched solve's buffers do."""
    fields = {"T": shp, "T2": shp} if read_first else {"T2": shp, "T": shp}
    call = kern.batched_call(**fields, dt=0.1, h=1.0, c=0.0)
    return stencil.StencilCall(call.ir, kern.label, kern.bc,
                               codegen.KernelShape((32, 8), planes, 6, column=True, ahead=ahead),
                               batched=kern.rotations, dtype=dtype)


@pytest.mark.parametrize("ahead", [0, 2, 4], ids=["ldg-0", "ldg-2", "ldg-4"])
@pytest.mark.parametrize("b", [1, 3])
def test_column_march_ragged_extents_chunks_and_dead_slots(cxx, rng, ahead, b):
    """Extents the 32 x 8 tile does not divide, chunks that end inside each
    column (xc = 4 of 37 planes), B = 1 and an odd B with a dead slot, both
    parities, loads 0, 2 or 4 planes further ahead (4: the guarded f32
    step's layout), the read field listed first; the guarded check's max
    partials bitwise, its sum within 1e-5."""
    kern = diffusion_kernel(reductions=GUARDED)
    shp = (37, 29, 45)
    call = column_call(kern, shp, planes=2, ahead=ahead, read_first=b == 3)
    assert call.shape.column and "__ldg(" in call.source
    bufs = batch(rng, {"T2": shp, "T": shp}, b)
    scalars = [{"dt": 0.05 + 0.01 * i, "h": 10.0 / (23 + i), "c": 0.1 * i} for i in range(b)]
    live = torch.tensor([i != 1 for i in range(b)])
    odd = torch.tensor([i % 2 == 0 for i in range(b)])
    for flip in (0, 1):
        check(call, kern, bufs, [s if live[i] else None for i, s in enumerate(scalars)],
              live, odd, flip, xc=4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ahead", [0, 2], ids=["ldg", "ldg-2"])
def test_column_march_two_byte_storage(cxx, rng, dtype, ahead):
    """bf16 and f16 fields: each load widened, each store rounded, the
    guarded check folding the stored values, bitwise to the plain version,
    the loads 0 or 2 planes further ahead."""
    kern = diffusion_kernel(dtype, reductions=GUARDED)
    shp = (11, 12, 37)
    call = column_call(kern, shp, dtype, ahead=ahead)
    bufs = batch(rng, {"T2": shp, "T": shp}, 3, dtype)
    scalars = [{"dt": 0.1, "h": 0.7, "c": 0.2}, None, {"dt": 0.12, "h": 1.3, "c": 0.0}]
    check(call, kern, bufs, scalars, torch.tensor([True, False, True]),
          torch.tensor([True, False, False]), 1, xc=5)


@pytest.mark.parametrize("bc", ["neumann0", "dirichlet", "periodic",
                                BoundaryCondition("neumann0", axes=(0,)),
                                BoundaryCondition("dirichlet", value=0.5, axes=(1,))],
                         ids=["neumann0", "dirichlet", "periodic", "neumann0-x", "dirichlet-y"])
def test_column_march_boundary_conditions(cxx, rng, bc):
    """An output's bc in the launch: a face cell takes its value at its
    source cell (neumann0, periodic: across its own sample) or its value
    (dirichlet), through the direct program beside the ring; a bc along x
    alone leaves the (y, z) ring to the core loop, kept by predication."""
    periodic = getattr(bc, "kind", bc) == "periodic"
    kern = diffusion_kernel(reductions=None if periodic else GUARDED, bc={"T2": bc})
    shp = (9, 10, 35)
    call = column_call(kern, shp)
    assert ("const bool kin" in call.source) == (getattr(bc, "axes", None) == (0,))
    bufs = batch(rng, {"T2": shp, "T": shp}, 3)
    bufs["T"][1] += 5.0
    scalars = [{"dt": 0.1, "h": 1.0, "c": 0.0}, {"dt": 0.07, "h": 0.9, "c": 0.1}, None]
    check(call, kern, bufs, scalars, torch.tensor([True, True, False]),
          torch.tensor([False, True, False]), 0, xc=3)


def test_column_march_ring_keeps_its_bits_without_a_store(cxx, rng):
    """The kept ring of T2 is neither loaded nor stored by the plain step:
    signaling-NaN payloads there keep their bits at bf16, where a load
    widened and a store rounded (the one-cell layout's copy of the ring onto
    itself) quiets them; with a reduction that reads T2 the guarded check
    still folds them. The interior is bitwise the plain version's (which
    widens the whole field to f32 and back, so its ring NaNs are PyTorch's
    own and not compared)."""
    shp = (6, 9, 34)
    ring = torch.ones(shp, dtype=torch.bool)
    ring[1:-1, 1:-1, 1:-1] = False
    for reductions in (None, GUARDED):
        kern = diffusion_kernel(torch.bfloat16, reductions=reductions)
        bufs = batch(rng, {"T2": shp, "T": shp}, 2, torch.bfloat16)
        bits = bufs["T2"].view(torch.int16)
        bits[:, ring] = torch.tensor(0x7F81 + np.arange(int(ring.sum())) % 60,
                                     dtype=torch.int16)
        scalars = [{"dt": 0.1, "h": 1.0, "c": 0.0}] * 2
        live, odd = torch.ones(2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool)
        call = column_call(kern, shp, dtype=torch.bfloat16)
        assert "if (!keep0) h0[at0]" in call.source
        got, reds = rehearse.run_batch(call, bufs, scalars, live, odd, 0, xc=4)
        want = {n: t.clone() for n, t in bufs.items()}
        call.run_batch(want, scalars, live, odd, 0)                # the plain version
        assert torch.equal(got["T"].view(torch.int16), want["T"].view(torch.int16))
        assert torch.equal(got["T2"].view(torch.int16)[:, ~ring],
                           want["T2"].view(torch.int16)[:, ~ring])
        assert torch.equal(got["T2"].view(torch.int16)[:, ring], bits[:, ring])
        if reductions:
            assert reds["__finite"].tolist() == [1.0, 1.0]      # some cell is not finite
    cells = stencil.StencilCall(call.ir, kern.label, kern.bc, codegen.KernelShape((32, 8), 2, 6),
                                batched=kern.rotations, dtype=torch.bfloat16)
    old, _ = rehearse.run_batch(cells, bufs, scalars, live, odd, 0, xc=4)
    assert not torch.equal(old["T2"].view(torch.int16)[:, ring], bits[:, ring])


def test_column_march_refusals():
    kern = diffusion_kernel()
    shp = (8, 8, 8)
    call = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    col = codegen.KernelShape((32, 8), 1, 6, column=True)
    with pytest.raises(ValueError, match="batched layout"):
        codegen.cuda_source(call.program, col)
    with pytest.raises(ValueError, match="one cell a thread"):
        codegen.cuda_source(call.program, dataclasses.replace(col, vec=2),
                            batched=kern.rotations)
    gp = _variant("gp_fused[none]+mass", (7, 8, 35))
    staged = gp.batched_call(**_field_shapes(gp, (7, 8, 35)), **_scalars(gp))
    with pytest.raises(ValueError, match="without stages"):
        codegen.cuda_source(staged.program, col, batched=gp.rotations)


def test_one_cell_batched_layouts_hold_only_inside():
    """``tune_stencil.one_cell_batched``, how the serving chunk is timed in
    the layout the column march replaced: calls made inside take the
    one-cell layouts and keep them, ``codegen.BATCHED`` is restored after,
    and a kernel made after takes the column march again."""
    from repro_torch.launch import tune_stencil

    before = dict(codegen.BATCHED)
    kern = diffusion_kernel(reductions=GUARDED)
    shp = (8, 8, 8)
    with tune_stencil.one_cell_batched():
        inside = kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0)
    assert codegen.BATCHED == before
    assert inside.shape == tune_stencil.ONE_CELL[(True, True)] and not inside.shape.column
    assert kern.batched_call(T2=shp, T=shp, dt=0.1, h=1.0, c=0.0) is inside
    fresh = diffusion_kernel(reductions=GUARDED).batched_call(T2=shp, T=shp, dt=0.1, h=1.0,
                                                              c=0.0)
    assert fresh.shape == codegen.BATCHED[(3, False, True, True)] and fresh.shape.column
