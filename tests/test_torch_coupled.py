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
    assert codegen.shape_classes(prog) == ((0, 0, 0), (0, 0, 1), (0, 1, 0))
    src = codegen.cuda_source(prog)
    # each staggered output is written inside its own extent only
    assert "if (x < m2x && y < m2y && z < m2z)" in src and "const int64_t m2y = ny - 1;" in src
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
    with pytest.raises(NotImplementedError, match="run_steps"):
        stag.run_steps(2, T2=T, q2=q, T=T, q=q, dt=0.1)
    with pytest.raises(ValueError, match="nsteps"):
        stag.run_steps(0, T2=T, q2=q, T=T, q=q, dt=0.1)
    assert set(stag.run_steps(1, T2=T, q2=q, T=T, q=q, dt=0.1)) == {"T2", "q2"}
