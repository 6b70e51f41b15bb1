"""Streaming (``march_axis=``) and the ``finite``/``nan_count`` reductions in
the port, on the CPU: the port-relevant cases of ``tests/test_streaming.py``
and ``tests/test_serve.py``.

Tolerances:

* the port's ``torch`` backend against the reference's marched ``jnp`` and
  interpret-mode Pallas kernels: atol 1e-6, the reference's own tolerance
  between its streamed and all-parallel paths (its ``jnp`` slab scan is
  1 ulp off its own all-parallel step in some cells);
* within the port everything is bitwise: a marched kernel on the ``torch``
  backend against the all-parallel one (marching changes the launch, not
  the values), and every printed marched kernel, single step and k steps,
  f32, bf16 and f16, run through ``repro_torch.kernels.rehearse`` against
  the ``torch`` backend; max reductions bitwise, sums within 1e-5 relative
  (the fold order differs);
* ``finite`` and ``nan_count`` are exact: 0 or 1, and an integer count
  equal to the ``torch`` backend's (and to the reference's);
* the port's cost model equals the reference's exactly for the same IR
  and tile.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import gross_pitaevskii as r_gp, porosity_waves as r_pw
from repro.core import fd1d as r_fd1d, fd2d as r_fd2d, fd3d as r_fd3d
from repro.core import init_parallel_stencil as r_init, teff as r_teff
from repro_torch.core import fd1d, fd2d, fd3d, init_parallel_stencil, iterate, teff
from repro_torch.kernels import codegen, rehearse

from test_torch_coupled import _solver_kernel

SHAPE3 = (20, 16, 24)
SC3 = dict(lam=1.0, dt=1e-4, _dx=19.0, _dy=15.0, _dz=23.0)
ATOL = 1e-6
REDS = {"err": "max_abs_diff(T2, T)", "s": "sum(T2)", "bad": "finite(T2)",
        "nbad": "nan_count(T)"}


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _diffusion(ps, fd, march=None, reductions=None, **kw):
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, march_axis=march,
                 reductions=reductions, **kw)
    def kern(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx ** 2 + fd.d2_yi(T) * _dy ** 2 + fd.d2_zi(T) * _dz ** 2))}
    return kern


def _port(march=None, dtype=torch.float32, **kw):
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype)
    return _diffusion(ps, fd3d, march, **kw)


def _ref(backend, march=None, **kw):
    return _diffusion(r_init(backend=backend, ndims=3), r_fd3d, march, **kw)


def _fields3(rng, shape=SHAPE3):
    T = rng.rand(*shape).astype(np.float32)
    return {"T2": T.copy(), "T": T, "Ci": (rng.rand(*shape) + 0.5).astype(np.float32)}


def _t(a, dtype=torch.float32):
    return {n: torch.tensor(v).to(dtype) for n, v in a.items()}


def _j(a):
    return {n: jnp.asarray(v) for n, v in a.items()}


def _outs(kern, res):
    """``(outputs dict, reductions dict)`` of a call's result."""
    res, reds = res if kern.reductions else (res, {})
    return ({kern.outputs[0]: res} if len(kern.outputs) == 1 else dict(res)), reds


def _hold(kern, got, reds, want, want_reds):
    """Outputs bitwise (NaN where the other has NaN), max reductions and
    counts exact, sums within 1e-5 relative."""
    for o in kern.outputs:
        a, b = got[o], want[o]
        assert torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all()), o
    for n, r in kern.reductions.items():
        if r.combine == "max" or r.kind == "nan_count":
            assert float(reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


def _rehearse_k(kern, f, sc, k):
    """The printed kernel (single step, or k steps per launch) on the CPU,
    held bitwise against the ``torch`` backend; returns the call."""
    want, want_reds = _outs(kern, kern.run_steps(k, **f, **sc))
    call = kern.compiled(nsteps=k, **f, **sc)
    got, reds = rehearse.run(call, f, sc)
    _hold(kern, got, reds, want, want_reds)
    return call


# ---------------------------------------------------------------------------
# FIG1's step: marched on every axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("march", [0, 1, 2])
def test_marched_matches_reference(backend, march, rng):
    a = _fields3(rng)
    got = _port(march)(**_t(a), **SC3)
    assert torch.equal(got, _port()(**_t(a), **SC3))
    k = _ref(backend, march, tile=(4, 4, 8) if backend == "pallas" else None)
    want = np.asarray(k(**_j(a), **SC3))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if backend == "pallas":
        run = next(iter(k._cache.values()))
        assert run.march_axis == march and not run.march_fallback


@pytest.mark.parametrize("backend,k", [("jnp", 1), ("jnp", 2), ("jnp", 4), ("pallas", 2)])
def test_marched_run_steps_matches_reference(backend, k, rng):
    a = _fields3(rng)
    got = _port(0).run_steps(k, **_t(a), **SC3)
    assert torch.equal(got, _port().run_steps(k, **_t(a), **SC3))
    kern = _ref(backend, 0, tile=(4, 4, 8) if backend == "pallas" else None)
    want = np.asarray(kern.run_steps(k, **_j(a), **SC3))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("march", [0, 1, 2])
def test_printed_marched_kernel_bitwise(cxx, march, k, rng):
    """Every reduction kind rides along; at (13, 12, 33) each march axis
    is cut into several chunks and the others into partial tiles."""
    f = _t(_fields3(rng, (13, 12, 33)))
    kern = _port(march, reductions=REDS)
    call = _rehearse_k(kern, f, SC3, k)
    assert call.march_axis == march and not call.march_fallback
    assert call.shape.slab == call.shape.async_copies == (march == 2)
    assert call.label.endswith(f"@m{march}" + (f"/k{k}" if k > 1 else ""))
    assert call.program.axes3[march] == 0 and call.queue_planes > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("march", [1, 2])
def test_printed_marched_kernel_bitwise_narrow(cxx, dtype, march, rng):
    f = _t(_fields3(rng, (9, 10, 33)), dtype)
    kern = _port(march, dtype=dtype, reductions=REDS)
    for k in (1, 2):
        assert _rehearse_k(kern, f, SC3, k).dtype == dtype


# ---------------------------------------------------------------------------
# the coupled solvers' fused kernels, marched
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("solver,bc,march,base", [
    ("porosity", "neumann", 0, (13, 20)), ("porosity", "neumann", 1, (13, 300)),
    ("porosity", "dirichlet", 1, (13, 40)),
    ("gp", "none", 0, (13, 8, 9)), ("gp", "none", 1, (7, 13, 9)), ("gp", "neumann", 2, (7, 8, 20)),
])
def test_printed_marched_coupled_bitwise(cxx, solver, bc, march, base, rng):
    """Along the contiguous axis (porosity 1, GP 2) the kernel is a slab,
    single step and k steps."""
    reds = {"err": "max_abs_diff(Pe2, Pe)"} if solver == "porosity" else {"m": "sum_sq(re2)"}
    kern = _solver_kernel(solver, base[0], 0, reds, bc=bc).marched(march)
    names = list(inspect.signature(kern.fn).parameters)
    sc = {n: v for n, v in dict(dtau=1e-3, g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0,
                                 _dz2=5.0).items() if n in names}
    f = {n: torch.tensor((rng.rand(*base) * 0.01 + 0.005).astype(np.float32))
         for n in names if n not in sc}
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()        # outputs start as their targets, as in the solvers
    plain = kern.marched(None)
    want, want_reds = _outs(plain, plain(**f, **sc))
    _hold(kern, *_outs(kern, kern(**f, **sc)), want, want_reds)
    for k in (1, 2):
        call = _rehearse_k(kern, f, sc, k)
        assert call.march_axis == march and call.shape.slab == (march == len(base) - 1)


def _coupled2d(ps, fd, march=None, **kw):
    """Coupled outputs beside a face-centred input staggered along axis 0,
    so axis 1 is the one that can march."""
    @ps.parallel(outputs=("phi2", "Pe2"), march_axis=march,
                 rotations={"phi2": "phi", "Pe2": "Pe"}, **kw)
    def kern(phi2, Pe2, phi, Pe, qx, dtau):
        div = qx[1:, 1:-1] - qx[:-1, 1:-1]
        return {"phi2": fd.inn(phi) + dtau * (fd.d2_xi(phi) + fd.d2_yi(phi) - div),
                "Pe2": fd.inn(Pe) + dtau * (fd.d2_xi(Pe) + fd.d2_yi(Pe) + fd.inn(phi))}
    return kern


def _coupled_args(rng, n=24):
    phi, Pe = (rng.rand(n, n).astype(np.float32) for _ in range(2))
    return dict(phi2=phi, Pe2=Pe, phi=phi, Pe=Pe, qx=rng.rand(n - 1, n).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
def test_marched_coupled_staggered(cxx, k, rng):
    a = _coupled_args(rng)
    port = _coupled2d(init_parallel_stencil(backend="torch", device="cpu", ndims=2), fd2d, 1)
    got = port.run_steps(k, **_t(a), dtau=1e-3)
    want = _coupled2d(r_init(backend="jnp", ndims=2), r_fd2d, 1).run_steps(k, **_j(a),
                                                                            dtau=1e-3)
    for o in ("phi2", "Pe2"):
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]), atol=ATOL)
    plain = port.marched(None).run_steps(k, **_t(a), dtau=1e-3)
    assert all(torch.equal(got[o], plain[o]) for o in got)
    call = _rehearse_k(port, _t(a), {"dtau": 1e-3}, k)
    assert call.march_axis == 1 and call.program.z_strided


def test_staggered_march_axis_raises(rng):
    a = _t(_coupled_args(rng))
    kern = _coupled2d(init_parallel_stencil(backend="torch", device="cpu", ndims=2), fd2d, 0)
    with pytest.raises(ValueError, match="staggered"):
        kern(**a, dtau=1e-3)
    with pytest.raises(ValueError, match="staggered"):
        kern.compiled(**a, dtau=1e-3)
    # the porosity flux-split kernels stagger both axes
    for pick in (0, 1):
        split = _solver_kernel("porosity", 12, pick, flux_split=True)
        args = {n: 1.0 if n == "dtau" else
                tuple(12 - d for d in {"qx": (1, 0), "qy": (0, 1)}.get(n, (0, 0)))
                for n in inspect.signature(split.fn).parameters}
        for march in (0, 1):
            with pytest.raises(ValueError, match="staggered"):
                split.marched(march).stencil_ir(**args)


def test_march_axis_out_of_range():
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    with pytest.raises(ValueError, match="out of range"):
        ps.parallel(outputs=("T2",), march_axis=2)
    with pytest.raises(ValueError, match="out of range"):
        _port().marched(3)
    with pytest.raises(ValueError, match="out of range"):
        codegen.march_layout(2, -1)


# ---------------------------------------------------------------------------
# asymmetric footprints, 1-D kernels, fallback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("march", [0, 1])
def test_marched_upwind_asymmetric(cxx, march, rng):
    def upwind(T2, T, dt):
        return {"T2": T[1:-1, 1:-1] + dt * (T[:-2, 1:-1] - T[1:-1, 1:-1])}

    U = rng.rand(20, 24).astype(np.float32)
    want = r_init(backend="jnp", ndims=2).parallel(outputs=("T2",), march_axis=march)(upwind)(
        T2=jnp.asarray(U), T=jnp.asarray(U), dt=1e-3)
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    kern = ps.parallel(outputs=("T2",), march_axis=march)(upwind)
    f = {"T2": torch.tensor(U), "T": torch.tensor(U)}
    got = kern(**f, dt=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(got, kern.marched(None)(**f, dt=1e-3))
    out, _ = rehearse.run(kern.compiled(**f, dt=1e-3), f, {"dt": 1e-3})
    assert torch.equal(out["T2"], got)


@pytest.mark.parametrize("march", [None, 0])
def test_one_dimensional_kernel(cxx, march, rng):
    """A 1-D kernel, marched (its one axis on the kernel's x, one warp per
    block) and not (the axis on z)."""
    def diffuse(ps, fd):
        @ps.parallel(outputs=("U2",), rotations={"U2": "U"}, march_axis=march,
                     reductions={"e": "max_abs_diff(U2, U)"})
        def kern(U2, U, dt):
            return {"U2": fd.inn(U) + dt * fd.d2_xi(U)}
        return kern

    U = rng.rand(300).astype(np.float32)
    kern = diffuse(init_parallel_stencil(backend="torch", device="cpu", ndims=1), fd1d)
    f = {"U2": torch.tensor(U), "U": torch.tensor(U)}
    got, reds = kern(**f, dt=0.2)
    want, want_reds = diffuse(r_init(backend="jnp", ndims=1), r_fd1d)(
        U2=jnp.asarray(U), U=jnp.asarray(U), dt=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(reds["e"]), float(want_reds["e"]), atol=ATOL)
    for k in (1, 3):
        call = _rehearse_k(kern, f, {"dt": 0.2}, k)
        assert call.march_axis == march
        assert call.shape.tile == ((32, 1) if march == 0 else (256, 1) if k == 1 else (224, 1))


def test_fallback_short_march_extent(cxx, rng):
    """A march extent shorter than the plane queue launches the all-parallel
    kernel: k = 4 sweeps of FIG1 need 12 planes along the march axis, one
    step of its slab kernel along the contiguous axis a step's planes, its
    lag, 1 behind and 1 ahead."""
    f = _t(_fields3(rng, (20, 8, 10)))
    kern = _port(1)
    call = _rehearse_k(kern, f, SC3, 4)
    assert call.march_fallback and call.march_axis is None and call.queue_planes == 0
    assert "@m" not in call.label
    single = kern.compiled(**f, **SC3)           # one step needs 4 planes: it marches
    assert single.march_axis == 1 and single.queue_planes == 4 and not single.march_fallback
    long = _port(2).compiled(**_t(_fields3(rng, (20, 8, 40))), **SC3)
    assert long.queue_planes == long.shape.planes + long.lag + 2 and long.march_axis == 2
    short = _t(_fields3(rng, (20, 8, long.queue_planes - 1)))
    slab = _port(2).compiled(**short, **SC3)
    assert slab.march_fallback and slab.march_axis is None


def test_fallback_tiny_axis(cxx, rng):
    U = rng.rand(3, 24).astype(np.float32)

    def lap(T2, T, dt):
        return {"T2": T[1:-1, 1:-1] + dt * (T[2:, 1:-1] - 2.0 * T[1:-1, 1:-1] + T[:-2, 1:-1]
                                            + T[1:-1, 2:] - 2.0 * T[1:-1, 1:-1] + T[1:-1, :-2])}

    want = r_init(backend="jnp", ndims=2).parallel(outputs=("T2",), march_axis=0)(lap)(
        T2=jnp.asarray(U), T=jnp.asarray(U), dt=1e-3)
    kern = init_parallel_stencil(backend="torch", device="cpu", ndims=2).parallel(
        outputs=("T2",), march_axis=0)(lap)
    f = {"T2": torch.tensor(U), "T": torch.tensor(U)}
    got = kern(**f, dt=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    call = kern.compiled(**f, dt=1e-3)
    assert call.march_fallback and call.march_axis is None
    out, _ = rehearse.run(call, f, {"dt": 1e-3})
    assert torch.equal(out["T2"], got)


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------
def test_marched_variant_memoized_and_kept(rng):
    kern = _port()
    assert kern.marched(None) is kern
    m0 = kern.marched(0)
    assert m0 is kern.marched(0) and m0.march_axis == 0 and kern.march_axis is None
    # every variant keeps the others
    err = {"err": "max_abs_diff(T2, T)"}
    assert m0.with_reductions(err).march_axis == 0
    assert m0.with_reductions(err).with_reductions(None).march_axis == 0
    bf = m0.with_dtype(torch.bfloat16)
    assert bf.march_axis == 0 and bf.ps.dtype == torch.bfloat16
    assert kern.with_reductions(err).marched(2).reductions == kern.with_reductions(err).reductions
    assert bf.marched(1).ps.dtype == torch.bfloat16
    # solve_until on a marched kernel runs marched kernels, with the same result
    a = _t(_fields3(rng))
    args = dict(tol=1e-9, max_iters=12, check_every=4)
    runs = [iterate.solve_until(k.with_reductions(err), {"T2": a["T2"], "T": a["T"]},
                                {"Ci": a["Ci"], **SC3}, **args) for k in (m0, kern)]
    assert runs[0].iters == runs[1].iters == 12 and runs[0].err == runs[1].err
    assert torch.equal(runs[0].output(m0.with_reductions(err)),
                       runs[1].output(kern.with_reductions(err)))


# ---------------------------------------------------------------------------
# the cost model and teff
# ---------------------------------------------------------------------------
class _HW:
    peak_bw, peak_flops = 3.35e12, 67e12


def _same_cost(port, ref, tiles):
    for key in ("shape", "itemsize", "read_bytes", "write_bytes", "halo", "field_offsets",
                "check_read_bytes", "n_reductions", "field_itemsizes", "partials_itemsize"):
        assert tuple(np.ravel(getattr(port, key))) == tuple(np.ravel(getattr(ref, key))), key
    assert port.flops.to_dict() == ref.flops.to_dict()
    assert port.check_flops.to_dict() == ref.check_flops.to_dict()
    assert port.intensity == ref.intensity
    for k in (1, 2):
        assert port.a_eff_bytes(k) == ref.a_eff_bytes(k)
        for tile in tiles:
            assert port.check_bytes_per_step(4, True, tile) == ref.check_bytes_per_step(4, True, tile)
            for march in (None, *range(len(tile))):
                assert port.fetched_bytes_per_step(tile, k, march, 4) == \
                    ref.fetched_bytes_per_step(tile, k, march, 4)
                assert port.predict_per_step_s(tile, k, _HW, march, 4) == \
                    ref.predict_per_step_s(tile, k, _HW, march, 4)
                if march is not None:
                    assert port.a_eff_streamed(tile, k, march) == ref.a_eff_streamed(tile, k, march)


def test_cost_model_equals_reference_fig1():
    shapes = {n: SHAPE3 for n in ("T2", "T", "Ci")}
    port = _port(reductions=REDS)
    ref = _ref("jnp", reductions=REDS)
    tiles = [(4, 4, 8), port.compiled(**shapes, **SC3).cost_tile(),
             port.marched(2).compiled(**shapes, **SC3).cost_tile()]
    _same_cost(port.cost_model(**shapes, **SC3), ref.cost_model(**shapes, **SC3), tiles)
    assert port.cost_model(**shapes, **SC3).check_flops.total() > 0


@pytest.mark.parametrize("solver", ["porosity", "gp"])
def test_cost_model_equals_reference_coupled(solver):
    n = 12
    if solver == "porosity":
        cfg = r_pw.PorosityConfig(n=n)
        ref = r_pw.make_step(r_pw.make_grid(cfg), cfg).kernels[0]
        shapes, sc, tiles = {x: (n, n) for x in ("phi2", "Pe2", "phi", "Pe")}, {"dtau": 1.0}, [(4, 8)]
    else:
        cfg = r_gp.GPConfig(n=n)
        ref = r_gp.make_step(r_gp.make_grid(cfg), cfg).kernels[0]
        shapes = {x: (n, n, n) for x in ("re2", "im2", "re", "im", "V")}
        sc, tiles = dict(g=1.0, dt=1.0, _dx2=1.0, _dy2=1.0, _dz2=1.0), [(4, 4, 8)]
    port = _solver_kernel(solver, n)
    tiles.append(port.marched(1).compiled(**shapes, **sc).cost_tile())
    _same_cost(port.cost_model(**shapes, **sc), ref.cost_model(**shapes, **sc), tiles)


def test_streamed_bytes_model_and_teff():
    cost = _port().cost_model(**{n: SHAPE3 for n in ("T2", "T", "Ci")}, **SC3)
    tile = (4, 4, 8)
    assert cost.a_eff_bytes(2) < cost.a_eff_streamed(tile, 2, 0) < \
        cost.fetched_bytes_per_step(tile, 2)
    with pytest.raises(ValueError, match="concrete march_axis"):
        cost.a_eff_streamed(tile, 2, None)
    n = int(np.prod(SHAPE3))
    for march in (None, 0):
        over = teff.window_overlap_factor(tile, cost.halo, 2, march)
        assert over == r_teff.window_overlap_factor(tile, cost.halo, 2, march)
        assert teff.a_eff_streamed(n, 2, 1, 4, 2, over) == \
            r_teff.a_eff_streamed(n, 2, 1, 4, nsteps=2, overlap=over)
    assert "reduction" in _port(reductions=REDS).stencil_ir(
        **{n: SHAPE3 for n in ("T2", "T", "Ci")}, **SC3).describe()


# ---------------------------------------------------------------------------
# finite / nan_count
# ---------------------------------------------------------------------------
def _health(ps, fd):
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                 reductions={"bad": "finite(T2)", "nbad": "nan_count(T2)",
                             "nin": "nan_count(T)"})
    def step(T2, T):
        return {"T2": fd.inn(T) * 2.0}
    return step


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_finite_and_nan_count(dtype):
    """``tests/test_serve.py``'s case at each storage dtype: clean fields
    fold to 0, a NaN and an inf inside count as 2, on the torch backend
    and the reference's ``jnp`` backend alike."""
    tdt, jdt = DTYPES[dtype]
    port = _health(init_parallel_stencil(backend="torch", device="cpu", dtype=tdt), fd3d)
    ref = _health(r_init(backend="jnp", ndims=3, dtype=jdt), r_fd3d)
    n = 8
    clean = np.ones((n, n, n), np.float32)
    poisoned = clean.copy()
    poisoned[4, 4, 4] = np.nan
    poisoned[2, 2, 2] = np.inf
    for T, want in ((clean, (0.0, 0.0, 0.0)), (poisoned, (1.0, 2.0, 2.0))):
        _, reds = port(T2=torch.tensor(clean).to(tdt), T=torch.tensor(T).to(tdt))
        _, r_reds = ref(T2=jnp.asarray(clean, jdt), T=jnp.asarray(T, jdt))
        got = tuple(float(reds[k]) for k in ("bad", "nbad", "nin"))
        assert got == want == tuple(float(r_reds[k]) for k in ("bad", "nbad", "nin"))
        assert all(np.isfinite(got)) and reds["nbad"].dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_finite_and_nan_count_printed(cxx, dtype, rng):
    """The printed fold, single step and k steps, marched and not: counts
    exact and equal to the torch backend's, NaN and inf at known cells and
    a random tenth of cells non-finite; at f16 a value that rounds to inf
    on store counts (60000 * 2 overflows f16)."""
    tdt, _ = DTYPES[dtype]
    kern = _health(init_parallel_stencil(backend="torch", device="cpu", dtype=tdt), fd3d)
    shape = (9, 10, 33)
    T = rng.rand(*shape).astype(np.float32)
    T[rng.rand(*shape) < 0.1] = np.nan
    T[4, 4, 4], T[2, 3, 5], T[1, 1, 1] = np.inf, -np.inf, 60000.0
    f = {"T2": torch.tensor(T).to(tdt), "T": torch.tensor(T).to(tdt)}
    out, reds = kern(**f)
    assert float(reds["nin"]) == int((~torch.isfinite(f["T"])).sum())
    assert float(reds["nbad"]) == int((~torch.isfinite(out)).sum()) and float(reds["bad"]) == 1
    assert bool(torch.isinf(out[1, 1, 1])) == (tdt == torch.float16)
    for march, k in ((None, 1), (2, 1), (0, 2)):
        _rehearse_k(kern.marched(march), f, {}, k)


@pytest.mark.parametrize("march", [1, 2])
def test_quickstart_marched_and_guarded(march):
    """The FIG1 entry point marched and with the health guard folded into
    its checked launch: the same fields, iterations and error as the plain
    run, and a guard that stays 0."""
    from repro_torch.configs import Diffusion3DConfig
    from repro_torch.examples import quickstart

    cfg = Diffusion3DConfig(nx=12, ny=10, nz=24, nt=5)
    want = quickstart.run(cfg, device="cpu", max_iters=20, check_every=5)
    got = quickstart.run(cfg, device="cpu", max_iters=20, check_every=5, march_axis=march,
                         guard=True)
    assert got.step.march_axis == march
    assert torch.equal(got.T, want.T) and torch.equal(got.T_explicit, want.T_explicit)
    assert (got.solve.iters, got.solve.err) == (want.solve.iters, want.solve.err)
    assert float(got.solve.reds["bad"]) == 0.0 and float(got.solve.reds["nbad"]) == 0.0
