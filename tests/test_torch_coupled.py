"""Coupled and staggered kernels in the port against the JAX package.

Footprints (halos, offsets, write modes and rings, read intervals) of the
staggered kernels must equal ``repro.ir.trace_stencil``'s exactly. Updates
on the ``torch`` backend are held to the reference's ``jnp`` backend within
rtol/atol 1e-6 (f32 arithmetic in two frameworks), and the generated
kernel's torch form to the ``torch`` backend bitwise. The reference's
interpret-mode Pallas 3-step staggered launch is not used: it differs from
three sequential calls by an ulp on the reference side (ROADMAP queue 3),
so the port's sequential calls are held to the reference's ``jnp`` ones.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fd2d as r_fd2d, fd3d as r_fd3d, init_parallel_stencil as r_init
from repro_torch.core import fd2d, fd3d, init_parallel_stencil
from repro_torch.ir import field_geometry
from repro_torch.kernels import codegen, stencil

SHAPE = (20, 24)


def _stag(fd):
    """Cell field T coupled to a rotated face-centred field q (x-faces)."""
    def kern(T2, q2, T, q, dt):
        return {"T2": fd.inn(T) + dt * fd.d_xi(q),
                "q2": 0.7 * q + 0.3 * fd.av_xa(T)}
    return kern


def _flux(fd, dx, dy):
    def fluxes(qx, qy, phi, Pe):
        k = (phi / 0.01) ** 3.0
        return {"qx": -fd.av_xa(k) * fd.d_xa(Pe) / dx,
                "qy": -fd.av_ya(k) * (fd.d_ya(Pe) / dy - 30.0 * (fd.av_ya(phi) - 0.01))}
    return fluxes


def _div(fd, dx, dy):
    def update(phi2, Pe2, phi, Pe, qx, qy, dtau):
        div_q = fd.d_xa(qx[:, 1:-1]) / dx + fd.d_ya(qy[1:-1, :]) / dy
        Pe_new = fd.inn(Pe) + dtau * (-(div_q + fd.inn(Pe) / 1.0))
        return {"phi2": fd.inn(phi) + dtau * (-(1.0 - fd.inn(phi)) * Pe_new), "Pe2": Pe_new}
    return update


def _gp(fd):
    def H(f, re, im, V, g, a, b, c):
        lap = fd.d2_xi(f) * a + fd.d2_yi(f) * b + fd.d2_zi(f) * c
        return -0.5 * lap + (fd.inn(V) + g * (fd.inn(re) ** 2 + fd.inn(im) ** 2)) * fd.inn(f)

    def update(re2, im2, re, im, V, g, dt, a, b, c):
        re1 = fd.inn(re) + dt * H(im, re, im, V, g, a, b, c)
        im1, V1 = fd.inn(im), fd.inn(V)
        return {"re2": fd.inn(re1), "im2": fd.inn(im1) - dt * H(re1, re1, im1, V1, g, a, b, c)}
    return update


N, M = SHAPE
G3 = (9, 10, 12)
CASES = {
    "stag": (_stag, ("T2", "q2"), 2, dict(T2=SHAPE, q2=(N - 1, M), T=SHAPE, q=(N - 1, M)),
             dict(dt=0.1)),
    "fluxes": (lambda fd: _flux(fd, 0.5, 0.25), ("qx", "qy"), 2,
               dict(qx=(N - 1, M), qy=(N, M - 1), phi=SHAPE, Pe=SHAPE), {}),
    "update": (lambda fd: _div(fd, 0.5, 0.25), ("phi2", "Pe2"), 2,
               dict(phi2=SHAPE, Pe2=SHAPE, phi=SHAPE, Pe=SHAPE, qx=(N - 1, M), qy=(N, M - 1)),
               dict(dtau=1e-3)),
    "gp": (_gp, ("re2", "im2"), 3, dict(re2=G3, im2=G3, re=G3, im=G3, V=G3),
           dict(g=0.5, dt=1e-3, a=3.0, b=2.0, c=5.0)),
}
FD = {2: (fd2d, r_fd2d), 3: (fd3d, r_fd3d)}


def _kernels(case):
    make, outs, nd, _, _ = CASES[case]
    fd, r_fd = FD[nd]
    port = init_parallel_stencil(backend="torch", device="cpu", ndims=nd).parallel(
        outputs=outs)(make(fd))
    ref = r_init(ndims=nd).parallel(outputs=outs)(make(r_fd))
    return port, ref


def _inputs(rng, shapes):
    return {n: (rng.rand(*s).astype(np.float32) * 0.01 + 0.01) for n, s in shapes.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_footprints_equal_reference(case):
    _, _, _, shapes, sc = CASES[case]
    port, ref = _kernels(case)
    a, b = port.stencil_ir(**shapes, **sc), ref.stencil_ir(**shapes, **sc)
    for attr in ("base_shape", "field_shapes", "offsets", "out_shapes", "write_modes",
                 "write_rings", "reads_rel", "field_halo", "halo", "inferred_radius",
                 "read_fields"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a.io_bytes(4) == b.io_bytes(4)


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_reference_jnp(case, rng):
    _, outs, _, shapes, sc = CASES[case]
    port, ref = _kernels(case)
    a = _inputs(rng, shapes)
    got = port(**{n: torch.tensor(v) for n, v in a.items()}, **sc)
    want = ref(**{n: jnp.asarray(v) for n, v in a.items()}, **sc)
    for o in outs:
        assert tuple(got[o].shape) == shapes[o]
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_form_equals_torch_backend_bitwise(case, rng):
    _, outs, _, shapes, sc = CASES[case]
    port, _ = _kernels(case)
    f = {n: torch.tensor(v) for n, v in _inputs(rng, shapes).items()}
    want = port(**f, **sc)
    call = stencil.StencilCall(port.stencil_ir(**f, **sc), port.label, port.bc)
    got, _ = call.run(f, sc)          # CPU tensors: the tap program's torch form
    for o in outs:
        assert torch.equal(got[o], want[o]), o


def test_shape_classes_of_the_flux_kernels():
    port, _ = _kernels("fluxes")
    prog = codegen.lower(port.stencil_ir(**CASES["fluxes"][3]))
    # a 2-D grid (n0, n1) lies on the kernel's (x, z) axes: qx is short on x
    assert codegen.shape_classes(prog) == ((0, 0, 0), (0, 0, 1), (1, 0, 0))
    src = codegen.cuda_source(prog)
    # each staggered output is written inside its own extent only
    assert "if (x < m2x && y < m2y && z < m2z)" in src
    assert "const int m2x = static_cast<int>(nx) - 1;" in src
    # the division by a scalar is PyTorch's CUDA product with its reciprocal
    assert " / " not in src.split("stencil_kernel(", 1)[1].split("}  // namespace")[0] \
        .replace("1.0f / ", "")


def test_staggered_rotation_sequential_matches_reference_jnp(rng):
    """Three rotated calls of the staggered coupled kernel: the port against
    the reference's jnp backend (the rotation that the reference's
    run_steps(3) realizes)."""
    port, ref = _kernels("stag")
    port = init_parallel_stencil(backend="torch", device="cpu", ndims=2).parallel(
        outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})(_stag(fd2d))
    T, q = rng.rand(*SHAPE).astype(np.float32), rng.rand(N - 1, M).astype(np.float32)
    cur = {"T2": torch.tensor(T), "q2": torch.tensor(q), "T": torch.tensor(T),
           "q": torch.tensor(q)}
    rcur = {n: jnp.asarray(v.numpy()) for n, v in cur.items()}
    for _ in range(3):
        o, ro = port(**cur, dt=0.1), ref(**rcur, dt=0.1)
        for out, tgt in (("T2", "T"), ("q2", "q")):
            cur[out], cur[tgt] = cur[tgt], o[out]
            rcur[out], rcur[tgt] = rcur[tgt], ro[out]
    for n in ("T", "q"):
        np.testing.assert_allclose(cur[n].numpy(), np.asarray(rcur[n]), rtol=1e-6, atol=1e-6)


def test_field_and_write_geometry_refusals(rng):
    shapes, offsets = field_geometry((16, 16), ("a", "q"), {"q": (15, 16)}, radius=1)
    assert shapes["a"] == (16, 16) and offsets["q"] == (1, 0)
    with pytest.raises(ValueError, match="staggering band"):
        field_geometry((16, 16), ("q",), {"q": (13, 16)}, radius=1)
    with pytest.raises(ValueError, match="rank"):
        field_geometry((16, 16), ("q",), {"q": (16,)}, radius=1)
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("q2",))
    def interior_on_faces(q2, q, T):
        return {"q2": fd2d.inn(q)}        # staggered axis written as `inn`

    with pytest.raises(ValueError, match="staggered along axis 0"):
        interior_on_faces(q2=torch.zeros(N - 1, M), q=torch.zeros(N - 1, M),
                          T=torch.zeros(*SHAPE))

    @ps.parallel(outputs=("U2",))
    def odd_extent(U2, U):
        return {"U2": U[:-1, :]}

    with pytest.raises(ValueError, match="expected"):
        odd_extent(U2=torch.zeros(*SHAPE), U=torch.zeros(*SHAPE))

    @ps.parallel(outputs=("T2",))
    def far(T2, T, q):
        return {"T2": fd2d.inn(T)}

    with pytest.raises(ValueError, match="staggering band"):
        far(T2=torch.zeros(*SHAPE), T=torch.zeros(*SHAPE), q=torch.zeros(N - 3, M))


def test_rotation_checks_come_before_the_run_steps_refusal(rng):
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("T2",), rotations={"T2": "q"})
    def mismatched(T2, T, q):
        return {"T2": fd2d.inn(T)}

    T = torch.zeros(*SHAPE)
    with pytest.raises(ValueError, match="different"):
        mismatched.run_steps(2, T2=T, T=T, q=torch.zeros(N - 1, M))

    @ps.parallel(outputs=("A2", "B2"), rotations={"A2": "A"})
    def partial(A2, B2, A, B):
        return {"A2": fd2d.inn(A), "B2": fd2d.inn(B)}

    with pytest.raises(ValueError, match="rotations"):
        partial.run_steps(2, A2=T, B2=T, A=T, B=T)
    stag = ps.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})(_stag(fd2d))
    q = torch.zeros(N - 1, M)
    # run_steps(k) is ported (tests/test_torch_temporal.py): a staggered
    # rotation's two steps equal two rotated calls
    Tr = torch.arange(float(N * M)).reshape(N, M) / (N * M)
    qr = torch.arange(float((N - 1) * M)).reshape(N - 1, M) / (N * M)
    one = stag(T2=Tr, q2=qr, T=Tr, q=qr, dt=0.1)
    two = stag(T2=Tr, q2=qr, T=one["T2"], q=one["q2"], dt=0.1)
    got = stag.run_steps(2, T2=Tr, q2=qr, T=Tr, q=qr, dt=0.1)
    assert all(torch.equal(got[o], two[o]) for o in ("T2", "q2"))
    with pytest.raises(ValueError, match="nsteps"):
        stag.run_steps(0, T2=T, q2=q, T=T, q=q, dt=0.1)
    assert set(stag.run_steps(1, T2=T, q2=q, T=T, q=q, dt=0.1)) == {"T2", "q2"}


# ------------------------------------------------- the staged, shared program
def _solver_kernel(solver, n, pick=0, reductions=None, **kw):
    """A kernel of the port's solver twins on the ``torch`` backend."""
    from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw
    mod, cls = (pw, pw.PorosityConfig) if solver == "porosity" else (gp, gp.GPConfig)
    cfg = cls(n=n, device="cpu", backend="torch", **kw)
    k = mod.make_step(mod.make_grid(cfg), cfg).kernels[pick]
    return k.with_reductions(reductions) if reductions else k


def _fig1_kernel(reductions=None):
    from repro_torch.examples import quickstart
    k = quickstart.make_step(init_parallel_stencil(backend="torch", device="cpu"))
    return k.with_reductions(reductions) if reductions else k


ERR_PW = {"err": "max_abs_diff(Pe2, Pe)"}
MASS = {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}
FIG1_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
             "m2": "sum_sq(T2)"}
# the 14 coupled variants chip_smoke.py holds on the card, and FIG1's three
VARIANTS = {
    **{f"porosity_fused[{bc}]": ("porosity", 0, None, dict(bc=bc))
       for bc in ("none", "neumann", "dirichlet", "periodic")},
    "porosity_fused[neumann]+err": ("porosity", 0, ERR_PW, dict(bc="neumann")),
    "porosity_fluxes": ("porosity", 0, None, dict(flux_split=True)),
    "porosity_update[neumann]": ("porosity", 1, None, dict(flux_split=True)),
    **{f"gp_fused[{bc}]": ("gp", 0, None, dict(bc=bc))
       for bc in ("none", "neumann", "dirichlet", "periodic")},
    "gp_fused[none]+mass": ("gp", 0, MASS, {}),
    "gp_step_re": ("gp", 0, None, dict(fused=False)),
    "gp_step_im": ("gp", 1, None, dict(fused=False)),
    "fig1_step": ("fig1", 0, None, {}),
    "fig1_step+err": ("fig1", 0, {"err": "max_abs_diff(T2, T)"}, {}),
    "fig1_step+4red": ("fig1", 0, FIG1_REDS, {}),
}
# the tile edges of chip_smoke.py, and extents that neither the 256-wide
# 2-D tile, the 32 x 8 3-D tile nor a chunk of planes divides
EDGE_SIZES = {"porosity": [(33, 20), (37, 300)], "gp": [(13, 17, 130), (11, 19, 41)],
              "fig1": [(33, 20, 130), (9, 10, 33)]}
STAGGER = {"qx": (1, 0), "qy": (0, 1)}
SCALARS = dict(dtau=1e-3, g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0, lam=1.0, _dx=31.0,
               _dy=19.0, _dz=129.0)


def _variant(name, base=None):
    solver, pick, reds, kw = VARIANTS[name]
    if solver == "fig1":
        return _fig1_kernel(reds)
    return _solver_kernel(solver, base[0] if base else 16, pick, reds, **kw)


def _field_shapes(kern, base):
    names = inspect.signature(kern.fn).parameters
    return {n: tuple(b - o for b, o in zip(base, STAGGER.get(n, (0,) * len(base))))
            for n in names if n not in SCALARS}


def _scalars(kern):
    names = inspect.signature(kern.fn).parameters
    return {n: v for n, v in SCALARS.items() if n in names}


def _variant_args(kern, base, rng):
    fields = {n: torch.tensor((rng.rand(*s) * 0.01 + 0.005).astype(np.float32))
              for n, s in _field_shapes(kern, base).items()}
    return fields, _scalars(kern)


@pytest.mark.parametrize("name,base", [(n, b) for n, v in VARIANTS.items()
                                       for b in EDGE_SIZES[v[0]]])
def test_staged_torch_form_equals_torch_backend_bitwise(name, base, rng):
    """The shared, staged program (core cells) and the outputs' direct
    programs (rings and faces) together equal the ``torch`` backend bitwise;
    max reductions bitwise, sums within 1e-5."""
    kern = _variant(name, base)
    f, sc = _variant_args(kern, base, rng)
    want = kern(**f, **sc)
    want, want_reds = want if kern.reductions else (want, {})
    want = {kern.outputs[0]: want} if len(kern.outputs) == 1 else want
    prog = codegen.lower(kern.stencil_ir(**f, **sc), kern.bc)
    got, reds = codegen.evaluate_torch(prog, f, sc)
    for o in kern.outputs:
        assert torch.equal(got[o], want[o]), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert torch.equal(reds[n], want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)
    box = codegen.core_box(prog, {o: tuple(t.shape) for o, t in got.items()})
    assert box is not None and all(hi - lo >= 1 for lo, hi in box)


def test_one_tap_program_and_its_stages():
    """Porosity's fused update shares one program (124 operations per cell
    when each output was lowered alone) and stages its face fluxes; GP's
    stages re1 (197 before). Footprints are centred on the intermediate: a
    cell reads qx on its low and own x-face, qy on its low and own y-face,
    re1 at -1..1 on every axis. FIG1, the flux kernel (k = (phi/phi0)**3 is
    cheaper to recompute) and the two-launch GP steps have none."""
    pw = _solver_kernel("porosity", 33)
    prog = codegen.lower(pw.stencil_ir(phi2=(33, 20), Pe2=(33, 20), phi=(33, 20), Pe=(33, 20),
                                       dtau=1e-3), pw.bc)
    assert prog.ops_per_cell() <= 65
    assert sum(codegen.op_count(o.ops) for o in prog.outputs) == 124
    # qx and qy, face-centred, in the order the lowering meets them
    assert sorted((s.trim, s.footprint) for s in prog.stages) == [
        ((0, 1), ((0, 0), (-1, 0))), ((1, 0), ((-1, 0), (0, 0)))]
    assert len(prog.core.results) == 2 and len(prog.core.reads) == 4
    gp = _solver_kernel("gp", 13)
    g3 = (13, 17, 30)
    prog = codegen.lower(gp.stencil_ir(re2=g3, im2=g3, re=g3, im=g3, V=g3, g=0.5, dt=1e-3,
                                       _dx2=1.0, _dy2=1.0, _dz2=1.0))
    assert prog.ops_per_cell() <= 50
    assert sum(codegen.op_count(o.ops) for o in prog.outputs) == 197
    (re1,) = prog.stages
    assert re1.footprint == ((-1, 1),) * 3 and re1.trim == (2, 2, 2)
    assert len(prog.core.reads) == 7 and prog.core.results[0][0] == "read"   # re2 = inn(re1)
    for name, base in (("fig1_step", (9, 10, 33)), ("porosity_fluxes", (33, 20)),
                       ("gp_step_re", (13, 17, 30)), ("gp_step_im", (13, 17, 30))):
        kern = _variant(name, base)
        f, sc = _variant_args(kern, base, np.random.RandomState(0))
        assert codegen.lower(kern.stencil_ir(**f, **sc)).stages == (), name


@pytest.mark.parametrize("name,base", [
    ("porosity_fused[neumann]", (8192, 8192)), ("porosity_fused[neumann]+err", (8192, 8192)),
    ("porosity_fluxes", (8192, 8192)), ("gp_fused[none]", (512, 512, 512)),
    ("gp_step_re", (512, 512, 512)), ("fig1_step+err", (512, 512, 512)),
    ("porosity_fused[periodic]", (33, 20)), ("porosity_update[neumann]", (37, 300)),
    ("gp_fused[dirichlet]", (13, 17, 130)), ("gp_fused[none]+mass", (11, 19, 41)),
    ("fig1_step", (33, 20, 130))])
def test_launch_writes_every_cell_once(name, base):
    """The launch ``StencilCall.run`` derives for the H100's 132 SMs: blocks
    and threads partition the (y, z) plane, chunks partition x, and the
    march (its lead of staged planes, then steps of ``planes``, as the
    printed loop runs them) writes each plane of a chunk
    once. The stages' queues fit the static shared memory of a block and a
    chunk with its halo stays within 32-bit offsets."""
    kern = _variant(name, base)
    call = stencil.StencilCall(kern.stencil_ir(**_field_shapes(kern, base), **_scalars(kern)),
                               kern.label, kern.bc)
    nx, ny, nz = codegen.to3(base, 1)
    la = stencil.derive_launch((nx, ny, nz), 132, call.shape, call.halo, call.lag)
    (gz, gy, gx), (bz, by, _) = la.grid, la.block
    assert (bz, by) == call.shape.tile
    for n, g, b in ((nz, gz, bz), (ny, gy, by)):
        cover = np.zeros(n, dtype=int)
        for blk in range(g):
            t = blk * b + np.arange(b)
            np.add.at(cover, t[t < n], 1)
        assert (cover == 1).all()
    planes, lead = call.shape.planes, call.lag
    cover = np.zeros(nx, dtype=int)
    for bx in range(gx):
        x0, x1 = bx * la.xc, min(bx * la.xc + la.xc, nx)
        for xs in range(x0 - lead, x1, planes):
            for x in range(max(xs, x0), min(xs + planes, x1)):
                cover[x] += 1
    assert (cover == 1).all()
    assert (la.xc + lead) % planes == 0 and gx <= 65535 and gy <= 65535
    assert (la.xc + 2 * call.halo) * ny * nz < 2 ** 31
    assert codegen.shared_bytes(call.program) <= codegen.SHARED_LIMIT
    if nx * ny * nz >= 8192 ** 2:
        # several waves of resident blocks on 132 SMs
        assert la.n_blocks >= 2 * call.shape.min_blocks * 132




def test_staged_shared_memory_is_checked_before_the_build(monkeypatch):
    """A program whose staged planes exceed a block's static shared memory
    is refused when its kernel is made, before nvcc would refuse it."""
    kern = _variant("gp_fused[none]", (13, 17, 30))
    ir = kern.stencil_ir(**_field_shapes(kern, (13, 17, 30)), **_scalars(kern))
    stencil.StencilCall(ir, kern.label)
    monkeypatch.setattr(codegen, "SHARED_LIMIT", 4096)
    with pytest.raises(NotImplementedError, match="shared memory"):
        stencil.StencilCall(ir, kern.label)
