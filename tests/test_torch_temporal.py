"""``run_steps(k)``: k time steps per launch, in the port against the JAX
package (the reference's ``tests/test_temporal.py``, ``test_coupled.py``,
``test_ir.py``, ``test_reductions.py`` and ``test_examples.py`` k-step
cases), from the same numpy inputs.

Two forms of the port's k steps are held here. The ``torch`` backend's
``run_steps`` is k single steps with the double-buffer rotation (the
reference's ``jnp`` path). The generated k-step kernel's plain version
(``StencilCall.run`` on CPU tensors, ``codegen.evaluate_steps_torch``) and
the hand kernel's (``ref.diffusion3d_steps``) run k sweeps with the
reference's in-launch semantics: an intermediate sweep keeps the rotation
target's ring, the last the output's own.

Tolerances: the port against the reference's ``jnp`` backend (and its
interpret-mode Pallas kernels where the reference's own test passes), rtol
= atol = 1e-6 (f32 arithmetic in two frameworks), reductions rtol 1e-5
(sums fold in another order); within the port, bitwise: the k-step forms
equal k rotated single steps when each output and its target agree on the
ring, as they do in the solvers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fd2d as r_fd2d, fd3d as r_fd3d, init_parallel_stencil as r_init
from repro.core import teff as r_teff
from repro.ir import BoundaryCondition as RBC
from repro.kernels import diffusion3d as r_diffusion3d
from repro_torch.core import fd2d, fd3d, init_parallel_stencil, teff
from repro_torch.ir import BoundaryCondition
from repro_torch.kernels import diffusion3d, ref

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE3 = (20, 16, 24)
SHAPE2 = (20, 24)
SC3 = dict(lam=1.0, dt=1e-4, _dx=float(SHAPE3[0] - 1), _dy=float(SHAPE3[1] - 1),
           _dz=float(SHAPE3[2] - 1))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _both(arrays):
    """The same numpy arrays as port tensors and reference arrays."""
    return ({n: torch.tensor(a) for n, a in arrays.items()},
            {n: jnp.asarray(a) for n, a in arrays.items()})


def _kernels(define, ndims, **kw):
    """``define(ps, fd)`` on the port's ``torch`` backend and the reference's
    ``jnp`` backend."""
    port = define(init_parallel_stencil(backend="torch", device="cpu", ndims=ndims),
                  fd3d if ndims == 3 else fd2d, **kw)
    refk = define(r_init(backend="jnp", ndims=ndims), r_fd3d if ndims == 3 else r_fd2d, **kw)
    return port, refk


def _sequential(kern, fields, scalars, k):
    """k calls with the double-buffer rotation: each output becomes its
    target, the target's old buffer the next output."""
    cur = dict(fields)
    for _ in range(k):
        res = kern(**cur, **scalars)
        res = res[0] if kern.reductions else res
        outs = {kern.outputs[0]: res} if len(kern.outputs) == 1 else res
        for o, t in kern.rotations.items():
            cur[o], cur[t] = cur[t], outs[o]
    return {o: cur[t] for o, t in kern.rotations.items()}


def _steps_plain(kern, fields, scalars, k):
    """The generated k-step kernel's plain version: ``(outs, reds)``."""
    return kern.compiled(nsteps=k, **fields, **scalars).run(fields, scalars)


def _check(port, refk, arrays, scalars, k, rscalars=None):
    """The port's run_steps against the reference's, the kernel's k-step
    plain version and k rotated port calls against both, bitwise."""
    f, rf = _both(arrays)
    got = port.run_steps(k, **f, **scalars)
    want = refk.run_steps(k, **rf, **(rscalars or scalars))
    got = {port.outputs[0]: got} if len(port.outputs) == 1 else got
    want = {port.outputs[0]: want} if len(port.outputs) == 1 else want
    for o in port.outputs:
        np.testing.assert_allclose(_np(got[o]), _np(want[o]), err_msg=o, **TOL)
    seq = _sequential(port, f, scalars, k)
    plain, _ = _steps_plain(port, f, scalars, k)
    for o in port.outputs:
        assert torch.equal(got[o], seq[o]), o
        assert torch.equal(plain[o], seq[o]), o
    return got


# ------------------------------------------------------------------ FIG1
def _fig1(ps, fd, **kw):
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, **kw)
    def kern(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx ** 2 + fd.d2_yi(T) * _dy ** 2 + fd.d2_zi(T) * _dz ** 2))}
    return kern


def _fig1_arrays(rng, shape=SHAPE3):
    T = rng.rand(*shape).astype(np.float32)
    return {"T2": T.copy(), "T": T, "Ci": (rng.rand(*shape) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fig1_run_steps_matches_reference(k, rng):
    port, refk = _kernels(_fig1, 3)
    _check(port, refk, _fig1_arrays(rng), SC3, k)


def test_fig1_run_steps_matches_reference_pallas(rng):
    """The reference's temporally blocked Pallas kernel (interpret mode),
    k = 2, squares the scalars in f32 where both plain paths square them in
    Python double: rtol = atol = 1e-5, as ``tests/test_torch_parallel.py``."""
    port, _ = _kernels(_fig1, 3)
    refk = _fig1(r_init(backend="pallas", ndims=3), r_fd3d)
    arrays = _fig1_arrays(rng)
    f, rf = _both(arrays)
    np.testing.assert_allclose(_np(port.run_steps(2, **f, **SC3)),
                               np.asarray(refk.run_steps(2, **rf, **SC3)), rtol=1e-5,
                               atol=1e-5)


def test_k_step_ring_rule_matches_reference(rng):
    """With T2 and T apart on the ring, the k-step kernel keeps T's ring on
    its intermediate sweeps and takes T2's on the last, as the reference's
    launch does (its jnp backend rotates instead and is not this rule)."""
    port, _ = _kernels(_fig1, 3)
    refk = _fig1(r_init(backend="pallas", ndims=3), r_fd3d)
    arrays = _fig1_arrays(rng, (12, 10, 14))
    arrays["T2"] = rng.rand(12, 10, 14).astype(np.float32)
    f, rf = _both(arrays)
    sc = dict(SC3, _dx=11.0, _dy=9.0, _dz=13.0)
    plain, _ = _steps_plain(port, f, sc, 3)
    want = np.asarray(refk.run_steps(3, **rf, **sc))
    np.testing.assert_allclose(plain["T2"].numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(plain["T2"].numpy()[0], arrays["T2"][0])
    # the hand kernel's plain version has the same rule
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
    assert torch.equal(ref.diffusion3d_steps(f["T2"], f["T"], f["Ci"], *args, nsteps=3),
                       plain["T2"])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_hand_diffusion3d_nsteps_bitwise(k, rng):
    arrays = _fig1_arrays(rng)
    f, rf = _both(arrays)
    args = (1.0, 1e-4, SC3["_dx"], SC3["_dy"], SC3["_dz"])
    a, b = f["T2"], f["T"]
    for _ in range(k):
        a = diffusion3d.diffusion3d_step(a, b, f["Ci"], *args)
        a, b = b, a
    got = diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args, nsteps=k)
    assert torch.equal(got, b)
    want = r_diffusion3d.diffusion3d_step(rf["T2"], rf["T"], rf["Ci"], *args, nsteps=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hand_diffusion3d_alias(rng):
    """``alias=True`` returns T2's own buffer holding the result; by default
    the CPU plain version returns a new tensor; T2 may not share T's or
    Ci's storage."""
    f, _ = _both(_fig1_arrays(rng, (9, 10, 11)))
    args = (1.0, 1e-3, 8.0, 9.0, 10.0)
    T2 = f["T2"].clone()
    want = diffusion3d.diffusion3d_step(T2, f["T"], f["Ci"], *args, nsteps=2)
    assert want.data_ptr() != T2.data_ptr() and torch.equal(T2, f["T2"])
    got = diffusion3d.diffusion3d_step(T2, f["T"], f["Ci"], *args, nsteps=2, alias=True)
    assert got.data_ptr() == T2.data_ptr() and torch.equal(got, want)
    for T2_bad in (f["T"], f["Ci"][:]):
        with pytest.raises(ValueError, match="storage"):
            diffusion3d.diffusion3d_step(T2_bad, f["T"], f["Ci"], *args, alias=True)
    with pytest.raises(ValueError, match="nsteps"):
        diffusion3d.diffusion3d_step(T2, f["T"], f["Ci"], *args, nsteps=0)


def test_nsteps_boundary_preserved(rng):
    T = rng.rand(*SHAPE3).astype(np.float32)
    for idx in (0, -1):
        T[idx], T[:, idx], T[:, :, idx] = 3.0, 3.0, 3.0
    T = torch.tensor(T)
    got = diffusion3d.diffusion3d_step(T.clone(), T, torch.ones(SHAPE3), 1.0, 1e-4,
                                       SC3["_dx"], SC3["_dy"], SC3["_dz"], nsteps=4)
    for face in (got[0], got[-1], got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert bool((face == 3.0).all())


# ------------------------------------------------------------- 2-D kernels
def _diffuse2(ps, fd, **kw):
    @ps.parallel(outputs=("U2",), rotations={"U2": "U"}, **kw)
    def kern(U2, U, dt):
        return {"U2": fd.inn(U) + dt * (fd.d2_xi(U) + fd.d2_yi(U))}
    return kern


def test_run_steps_2d_multi_sweep(rng):
    port, refk = _kernels(_diffuse2, 2)
    U = rng.rand(24, 32).astype(np.float32)
    _check(port, refk, {"U2": U.copy(), "U": U}, dict(dt=1e-3), 3)


def test_run_steps_requires_rotations(rng):
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("U2",))
    def kern(U2, U, dt):
        return {"U2": fd2d.inn(U) * 2.0}

    U = torch.tensor(rng.rand(8, 8).astype(np.float32))
    with pytest.raises(ValueError, match="rotations"):
        kern.run_steps(2, U2=U, U=U, dt=0.1)
    with pytest.raises(ValueError, match="rotations"):
        kern.compiled(nsteps=2, U2=U, U=U, dt=0.1)
    assert torch.equal(kern.run_steps(1, U2=U, U=U, dt=0.1), kern(U2=U, U=U, dt=0.1))


_BC_CASES = {
    "dirichlet": (dict(kind="dirichlet", value=0.5), {}),
    "neumann0": (dict(kind="neumann0"), {}),
    "periodic": (dict(kind="periodic"), {}),
    "neumann0_d2": (dict(kind="neumann0", depth=2), {}),
    "dirichlet_ax0": (dict(kind="dirichlet", value=1.5, axes=(0,)), {}),
}


@pytest.mark.parametrize("case", list(_BC_CASES))
def test_fused_bc_run_steps_matches_reference(case, rng):
    """Boundary conditions between sweeps (``tests/test_ir.py:292``),
    k = 3; periodic runs as three single steps."""
    spec, _ = _BC_CASES[case]
    port = _diffuse2(init_parallel_stencil(backend="torch", device="cpu", ndims=2), fd2d,
                     bc={"U2": BoundaryCondition(**spec)})
    refk = _diffuse2(r_init(backend="jnp", ndims=2), r_fd2d, bc={"U2": RBC(**spec)})
    U = rng.rand(*SHAPE2).astype(np.float32)
    arrays = {"U2": U.copy(), "U": U}
    if case != "periodic":
        _check(port, refk, arrays, dict(dt=1e-3), 3)
        return
    # the wrap sources lie outside every block's window: no k-step kernel
    with pytest.raises(ValueError, match="periodic"):
        port.compiled(nsteps=3, U2=SHAPE2, U=SHAPE2, dt=1e-3)
    f, rf = _both(arrays)
    got = port.run_steps(3, **f, dt=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(refk.run_steps(3, **rf, dt=1e-3)),
                               **TOL)
    assert torch.equal(got, _sequential(port, f, dict(dt=1e-3), 3)["U2"])


def test_inferred_zero_halo_axis_run_steps(rng):
    """An axis the update never differences (``tests/test_ir.py:145``)."""
    def xonly(ps, fd):
        @ps.parallel(outputs=("T2",), rotations={"T2": "T"})
        def kern(T2, T, dt):
            return {"T2": T[1:-1, :] + dt * (T[2:, :] - 2.0 * T[1:-1, :] + T[:-2, :])}
        return kern

    port, refk = _kernels(xonly, 2)
    assert port.stencil_ir(T2=SHAPE2, T=SHAPE2, dt=0.0).halo == ((1, 1), (0, 0))
    U = rng.rand(*SHAPE2).astype(np.float32)
    _check(port, refk, {"T2": U.copy(), "T": U}, dict(dt=1e-3), 3)


# ---------------------------------------------------------------- coupled
def _coupled(ps, fd):
    @ps.parallel(outputs=("A2", "B2"), rotations={"A2": "A", "B2": "B"})
    def kern(A2, B2, A, B, dt):
        return {"A2": fd.inn(A) + dt * (fd.d2_xi(A) + fd.d2_yi(A)) + dt * fd.inn(B),
                "B2": fd.inn(B) + dt * (fd.d2_xi(B) + fd.d2_yi(B)) - dt * fd.inn(A)}
    return kern


def _staggered(ps, fd):
    @ps.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})
    def kern(T2, q2, T, q, dt):
        return {"T2": fd.inn(T) + dt * fd.d_xi(q), "q2": 0.7 * q + 0.3 * fd.av_xa(T)}
    return kern


@pytest.mark.parametrize("k", [2, 3])
def test_coupled_run_steps_matches_reference(k, rng):
    port, refk = _kernels(_coupled, 2)
    A, B = (rng.rand(*SHAPE2).astype(np.float32) for _ in range(2))
    _check(port, refk, {"A2": A.copy(), "B2": B.copy(), "A": A, "B": B}, dict(dt=1e-3), k)


def test_staggered_rotation_run_steps_matches_reference(rng):
    """A face-centred field in the rotation, k = 3, against the reference's
    ``jnp`` backend (its interpret-mode Pallas case is 1 ulp off there)."""
    port, refk = _kernels(_staggered, 2)
    T = rng.rand(*SHAPE2).astype(np.float32)
    q = rng.rand(SHAPE2[0] - 1, SHAPE2[1]).astype(np.float32)
    _check(port, refk, {"T2": T.copy(), "q2": q.copy(), "T": T, "q": q}, dict(dt=1e-3), 3)


# -------------------------------------------------------------- reductions
def test_run_steps_reduces_final_sweep_only(rng):
    """``max_abs_diff(T2, T)`` compares step k with step k - 1
    (``tests/test_reductions.py:139``), on both k-step forms."""
    reds = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}
    port, refk = _kernels(_fig1, 3, reductions=reds)
    arrays = _fig1_arrays(rng, (16, 16, 16))
    sc = dict(lam=1.0, dt=1e-3, _dx=1.0, _dy=1.0, _dz=1.0)
    f, rf = _both(arrays)
    out, got = port.run_steps(3, **f, **sc)
    rout, want = refk.run_steps(3, **rf, **sc)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    plain = port.with_reductions(None)
    cur = dict(f)
    for _ in range(3):
        new = plain(**cur, **sc)
        cur["T2"], cur["T"] = cur["T"], new
    assert torch.equal(out, cur["T"])
    assert float(got["err"]) == float((cur["T"] - cur["T2"]).abs().max())
    pout, preds = _steps_plain(port, f, sc, 3)
    assert torch.equal(pout["T2"], out)
    for n in reds:
        np.testing.assert_allclose(float(got[n]), float(want[n]), rtol=1e-5, err_msg=n)
        np.testing.assert_allclose(float(preds[n]), float(got[n]), rtol=1e-5, err_msg=n)


# --------------------------------------------------------------- solvers
def test_gp_fused_kernel_run_steps_matches_reference():
    """The radius-2 coupled GP kernel, k = 2 (``tests/test_examples.py:82``),
    from the reference's numpy state."""
    from examples import gross_pitaevskii as r_gp
    from repro_torch.examples import gross_pitaevskii as gp

    rcfg = r_gp.GPConfig(n=12, backend="jnp")
    grid, re, im, V = r_gp.init_state(rcfg)
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)
    sc = dict(g=rcfg.g, dt=r_gp.timestep(grid), _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
    rkern = r_gp.make_step(grid, rcfg).kernels[0]
    want = rkern.run_steps(2, re2=re, im2=im, re=re, im=im, V=V, **sc)
    cfg = gp.GPConfig(n=12, device="cpu")
    kern = gp.make_step(gp.make_grid(cfg), cfg).kernels[0]
    f = {n: torch.tensor(np.asarray(a)) for n, a in dict(re=re, im=im, V=V).items()}
    f.update(re2=f["re"].clone(), im2=f["im"].clone())
    got = kern.run_steps(2, **f, **sc)
    seq = _sequential(kern, f, sc, 2)
    plain, _ = _steps_plain(kern, f, sc, 2)
    for o in ("re2", "im2"):
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]), err_msg=o, **TOL)
        assert torch.equal(got[o], seq[o]) and torch.equal(plain[o], seq[o]), o


@pytest.mark.parametrize("bc", ["none", "neumann", "dirichlet"])
def test_porosity_fused_kernel_run_steps_bitwise(bc):
    """Porosity's fused kernel, k = 2, on its own state: the k-step plain
    version equals two rotated steps."""
    from repro_torch.examples import porosity_waves as pw

    cfg = pw.PorosityConfig(n=24, device="cpu", bc=bc)
    grid, phi, Pe = pw.init_state(cfg)
    kern = pw.make_step(grid, cfg).kernels[0]
    f = dict(phi2=phi.clone(), Pe2=Pe.clone(), phi=phi, Pe=Pe)
    sc = dict(dtau=pw.timestep(cfg, grid))
    seq = _sequential(kern, f, sc, 2)
    got = kern.run_steps(2, **f, **sc)
    plain, _ = _steps_plain(kern, f, sc, 2)
    for o in ("phi2", "Pe2"):
        assert torch.equal(got[o], seq[o]) and torch.equal(plain[o], seq[o]), o


# ------------------------------------------------------------------ T_eff
@pytest.mark.parametrize("block,halo,k,march", [
    ((32, 8), 1, 4, None), ((16, 8, 8), ((1, 1), (2, 0), (0, 3)), 2, None),
    ((8, 8, 32), 1, 3, 0), ((256,), 2, 1, None)])
def test_window_overlap_factor_matches_reference(block, halo, k, march):
    assert teff.window_overlap_factor(block, halo, k, march) == \
        r_teff.window_overlap_factor(block, halo, k, march)


@pytest.mark.parametrize("block,radius,k", [((32, 8), 1, 4), ((8, 32), 2, 2),
                                            ((16, 16, 16), 1, 3), ((256,), 1, 1)])
def test_halo_compute_overhead_matches_reference(block, radius, k):
    got = teff.halo_compute_overhead(block, radius, k)
    assert got == r_teff.halo_compute_overhead(block, radius, k)
    if block == (32, 8) and k == 4:
        # the cone of the generated FIG1 kernel's 32 x 8 tile over four
        # sweeps: (38*14 + 36*12 + 34*10 + 32*8) / (4*256) - 1
        assert got == pytest.approx((38 * 14 + 36 * 12 + 34 * 10 + 32 * 8) / (4 * 256) - 1)


# ---------------------------------------------------------- k-step launch
@pytest.mark.parametrize("name,base,k", [
    ("fig1_step", (512, 512, 512), 4), ("fig1_step+err", (33, 20, 130), 3),
    ("porosity_fused[neumann]", (8192, 8192), 4), ("porosity_fused[neumann]+err", (37, 300), 2),
    ("gp_fused[neumann]", (512, 512, 512), 3), ("gp_fused[none]+mass", (13, 17, 130), 2)])
def test_k_step_launch_writes_every_cell_once(name, base, k):
    """The launch of a k-step kernel for the H100's 132 SMs: chunks
    partition x and the march (its lead, then steps of planes, as the
    printed loop runs them) writes each plane of a chunk once; a chunk with
    its reach stays within 32-bit offsets; the phases' queues fit a block's
    227 KB of shared memory, and their lags fall sweep by sweep."""
    from repro_torch.kernels import codegen, codegen_steps, stencil
    from test_torch_coupled import _field_shapes, _scalars, _variant

    kern = _variant(name, base)
    call = kern.compiled(nsteps=k, **_field_shapes(kern, base), **_scalars(kern))
    nx, ny, nz = codegen.to3(base, 1)
    la = stencil.derive_launch((nx, ny, nz), 132, call.shape, call.halo, call.lag,
                               stencil.STEPS_WAVES)
    planes, lead = call.shape.planes, call.plan.lead
    cover = np.zeros(nx, dtype=int)
    for bx in range(la.grid[2]):
        x0, x1 = bx * la.xc, min(bx * la.xc + la.xc, nx)
        for xs in range(x0 - lead, x1, planes):
            for x in range(max(xs, x0), min(xs + planes, x1)):
                cover[x] += 1
    assert (cover == 1).all()
    assert (la.xc + lead) % planes == 0
    assert (la.xc + 2 * call.halo) * ny * nz < 2 ** 31
    assert codegen_steps.shared_bytes(call.program, call.plan, call.shape) <= \
        codegen_steps.SHARED_LIMIT
    lags = [ph.lag for ph in call.plan.phases if ph.stage is None]
    assert lags == sorted(lags, reverse=True) and lags[-1] == 0 and len(lags) == k
    assert call.label == f"{kern.label}/k{k}" and f"/k{k}" not in kern.label


@pytest.mark.parametrize("name,base,k", [("fig1_step", (512, 512, 512), 1),
                                         ("porosity_fused[neumann]", (8192, 8192), 3),
                                         ("gp_fused[none]", (512, 512, 512), 2)])
def test_tune_steps_builds_candidates_and_choice(name, base, k):
    """``tune_stencil --steps`` builds the candidate layouts of a k-step
    kernel and names ``codegen_steps.steps_shape``'s choice as it names
    them, without the card (the sources are printed, not compiled; the
    fields are given by their shapes)."""
    from repro_torch.kernels import codegen_steps
    from repro_torch.launch import tune_stencil
    from test_torch_coupled import _field_shapes, _scalars, _variant

    kern = _variant(name, base)
    calls = tune_stencil.steps_candidates(kern, _field_shapes(kern, base), _scalars(kern), k)
    assert calls and all(c.nsteps == k and c.label == f"{kern.label}/k{k}" for c in calls)
    assert all("cudaFuncSetAttribute" in c.source for c in calls)
    sh = codegen_steps.steps_shape(calls[0].program, kern.rotations, k)
    assert tune_stencil.steps_choice(calls[0]) == \
        f"{tune_stencil.layout_name(sh)}/w{tune_stencil.stencil.STEPS_WAVES}"
