"""Sub-f32 storage in the port (bf16 and f16 fields, f32 compute) against the
JAX package, on the CPU: the parity cases of ``tests/test_mixed.py``.

The port's ``torch`` backend at bf16 and f16 is held against the
reference's ``jnp`` backend and its interpret-mode Pallas kernel, on the
same inputs rounded to storage once. Tolerances, as the reference states
them for its own low-precision paths:

* the Fig. 1 step: bitwise (both cast each field to f32, run the f32 update
  and round once on store; 0 of 3840 cells differ at either dtype);
* coupled porosity and GP steps, and ``run_steps(k)``: within
  ``4 k eps max|x|`` (storage rounding re-enters the stencil every step);
* ``solve_until`` (FIG1, porosity, GP): the same iterations, the error
  within ``eps max|x|``;
* the hand ``diffusion3d_step``, which computes at the storage dtype as
  the reference's hand kernel does: within ``eps max|T|`` per step (XLA
  keeps some excess precision inside its fusion; PyTorch rounds each
  operation);
* reductions accumulate in f32: the port's within 1e-5 relative of an f64
  host fold (PyTorch folds pairwise), the reference's within its own 1e-3
  (a bf16 running sum would be off by more than half); maxima exact.

Within the port everything is bitwise: ``run_steps(k)`` against k single
steps, and the generated kernel's torch form against the ``torch`` backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import porosity_waves as r_pw
from repro.core import fd2d as r_fd2d, fd3d as r_fd3d, init_parallel_stencil as r_init
from repro.core import iterate as r_iterate, teff as r_teff
from repro.kernels import diffusion3d as r_diffusion3d, stencil as r_stencil
from repro_torch import interop
from repro_torch.core import fd2d, fd3d, init_parallel_stencil, iterate, teff
from repro_torch.examples import porosity_waves as pw
from repro_torch.ir import BoundaryCondition
from repro_torch.kernels import ref, stencil

from test_torch_coupled import _gp, _stag

SHAPE = (16, 12, 20)
SC = dict(lam=1.0, dt=1e-3, _dx=1.0, _dy=1.0, _dz=1.0)
LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _eps(name) -> float:
    return float(torch.finfo(LOW[name]).eps)


def _fig1(ps, fd, reductions=None):
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, reductions=reductions)
    def kern(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx ** 2 + fd.d2_yi(T) * _dy ** 2 + fd.d2_zi(T) * _dz ** 2))}
    return kern


def _port(name, define=_fig1, ndims=3, **kw):
    return define(init_parallel_stencil(backend="torch", device="cpu", dtype=LOW[name],
                                        ndims=ndims), fd3d if ndims == 3 else fd2d, **kw)


def _ref(name, define=_fig1, ndims=3, backend="jnp", **kw):
    return define(r_init(backend=backend, dtype=name, ndims=ndims),
                  r_fd3d if ndims == 3 else r_fd2d, **kw)


def _both(arrays, name):
    """The f32 arrays rounded to storage once, as port tensors and as
    reference arrays."""
    port = interop.fields_from_numpy(arrays, device="cpu", dtype=LOW[name])
    return port, {n: jnp.asarray(a).astype(name) for n, a in arrays.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _fig1_arrays(rng, shape=SHAPE):
    T = rng.rand(*shape).astype(np.float32)
    return {"T2": T.copy(), "T": T, "Ci": (rng.rand(*shape) + 0.5).astype(np.float32)}


# -- the storage/compute rule ---------------------------------------------
def test_compute_and_accumulation_dtypes_match_reference():
    for name, dt in {**LOW, "float32": torch.float32}.items():
        want = r_stencil.default_compute_dtype(jnp.dtype(name))
        assert stencil.default_compute_dtype(dt) == getattr(torch, want.name)
        want_acc = r_stencil.accum_dtype(want)
        assert stencil.accum_dtype(stencil.default_compute_dtype(dt)) == \
            getattr(torch, want_acc.name)
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=torch.bfloat16)
    assert (ps.dtype, ps.compute_dtype, ps.acc_dtype) == \
        (torch.bfloat16, torch.float32, torch.float32)


# -- parity: one step, coupled, k steps -------------------------------------
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name", list(LOW))
def test_fig1_step_bitwise_to_reference(backend, name, rng):
    f, rf = _both(_fig1_arrays(rng), name)
    got = _port(name)(**f, **SC)
    want = _ref(name, backend=backend)(**rf, **SC)
    assert got.dtype == LOW[name] and want.dtype == jnp.dtype(name)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the untouched boundary is a pure storage copy
    np.testing.assert_array_equal(_np(got[0]), _np(f["T"][0]))


def _porosity_fused(ps, fd):
    @ps.parallel(outputs=("phi2", "Pe2"), rotations={"phi2": "phi", "Pe2": "Pe"},
                 bc={"phi2": "neumann0", "Pe2": "neumann0"})
    def update(phi2, Pe2, phi, Pe, dtau):
        k = (phi / 0.01) ** 3.0
        qx = -fd.av_xa(k) * fd.d_xa(Pe) / 0.5
        qy = -fd.av_ya(k) * (fd.d_ya(Pe) / 0.25 - 30.0 * (fd.av_ya(phi) - 0.01))
        div_q = fd.d_xa(qx[:, 1:-1]) / 0.5 + fd.d_ya(qy[1:-1, :]) / 0.25
        Pe_new = fd.inn(Pe) + dtau * (-(div_q + fd.inn(Pe) / 1.0))
        phi_new = fd.inn(phi) + dtau * (-(1.0 - fd.inn(phi)) * Pe_new / 1.0)
        return {"phi2": phi_new, "Pe2": Pe_new}
    return update


def _gp_fused(ps, fd):
    return ps.parallel(outputs=("re2", "im2"), rotations={"re2": "re", "im2": "im"})(_gp(fd))


def _stag_rot(ps, fd):
    return ps.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})(_stag(fd))


def _coupled_case(case, rng):
    """``(define, ndims, arrays, scalars)`` of a coupled case at small shapes;
    outputs start as copies of their rotation targets."""
    if case == "porosity":
        phi = (0.01 + 0.002 * rng.rand(20, 24)).astype(np.float32)
        Pe = ((rng.rand(20, 24) - 0.5) * 0.01).astype(np.float32)
        return _porosity_fused, 2, {"phi2": phi.copy(), "Pe2": Pe.copy(), "phi": phi,
                                    "Pe": Pe}, {"dtau": 1e-4}
    if case == "gp":
        re, im, V = (rng.rand(9, 10, 12).astype(np.float32) for _ in range(3))
        return _gp_fused, 3, {"re2": re.copy(), "im2": im.copy(), "re": re, "im": im,
                              "V": V}, dict(g=0.5, dt=1e-3, a=3.0, b=2.0, c=5.0)
    T = rng.rand(20, 24).astype(np.float32)
    q = rng.rand(19, 24).astype(np.float32)
    return _stag_rot, 2, {"T2": T.copy(), "q2": q.copy(), "T": T, "q": q}, {"dt": 1e-3}


def _bound(name, arrays, outs, k=1):
    return 4 * k * _eps(name) * max(float(np.abs(arrays[t]).max()) for t in outs)


@pytest.mark.parametrize("case", ["porosity", "gp", "staggered"])
@pytest.mark.parametrize("name", list(LOW))
def test_coupled_step_matches_reference(case, name, rng):
    define, nd, arrays, sc = _coupled_case(case, rng)
    f, rf = _both(arrays, name)
    port, refk = _port(name, define, nd), _ref(name, define, nd)
    got, want = port(**f, **sc), refk(**rf, **sc)
    atol = _bound(name, arrays, port.outputs)
    for o in port.outputs:
        assert got[o].dtype == LOW[name]
        np.testing.assert_allclose(_np(got[o]), _np(want[o]), rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["fig1", "porosity", "gp", "staggered"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", list(LOW))
def test_run_steps_matches_reference(case, k, name, rng):
    """k steps on the ``torch`` backend: bitwise to k rotated single steps
    of the port (each rounds its outputs to storage), within ``4 k eps
    max|x|`` of the reference's ``run_steps(k)``; the generated k-step
    kernel's torch form bitwise to them."""
    if case == "fig1":
        define, nd, arrays, sc = _fig1, 3, _fig1_arrays(rng), SC
    else:
        define, nd, arrays, sc = _coupled_case(case, rng)
    f, rf = _both(arrays, name)
    port, refk = _port(name, define, nd), _ref(name, define, nd)
    got = port.run_steps(k, **f, **sc)
    got = {port.outputs[0]: got} if len(port.outputs) == 1 else got
    cur = dict(f)
    for _ in range(k):
        res = port(**cur, **sc)
        res = {port.outputs[0]: res} if len(port.outputs) == 1 else res
        for o, t in port.rotations.items():
            cur[o], cur[t] = cur[t], res[o]
    call = port.compiled(nsteps=k, **f, **sc)
    steps, _ = call.run(f, sc)      # CPU tensors: the k-step kernel's torch form
    want = refk.run_steps(k, **rf, **sc)
    want = {port.outputs[0]: want} if len(port.outputs) == 1 else want
    atol = _bound(name, arrays, port.outputs, k)
    for o, t in port.rotations.items():
        assert got[o].dtype == LOW[name]
        assert torch.equal(got[o], cur[t]), o
        assert torch.equal(steps[o], got[o]), o
        np.testing.assert_allclose(_np(got[o]), _np(want[o]), rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(LOW))
def test_generated_torch_form_equals_torch_backend(name, rng):
    """The tap program's torch form (what the generated kernel computes: f32
    from widened loads, rounded on store, reductions of the stored values)
    equals the ``torch`` backend bitwise at storage dtype."""
    reds = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}
    port = _port(name, reductions=reds)
    f, _ = _both(_fig1_arrays(rng), name)
    (want, want_reds), call = port(**f, **SC), port.compiled(**f, **SC)
    assert call.label == f"kern[err,mx,s,m2]:{stencil.dtype_tag(LOW[name])}"
    got, got_reds = call.run(f, SC)
    assert torch.equal(got["T2"], want)
    for n, r in port.reductions.items():
        assert got_reds[n].dtype == torch.float32
        if r.combine == "max":
            assert float(got_reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(got_reds[n]), float(want_reds[n]), rtol=1e-5)


# -- convergence and reductions ---------------------------------------------
@pytest.mark.parametrize("name", list(LOW))
def test_solve_until_matches_reference(name, rng):
    arrays = _fig1_arrays(rng)
    reds = {"err": "max_abs_diff(T2, T)"}
    # a bf16 or f16 solve cannot resolve below one storage ulp of the field:
    # the tolerance sits above it
    tol = 1e-2
    assert tol > _eps(name) * float(np.abs(arrays["T"]).max())
    f, rf = _both(arrays, name)
    got = iterate.solve_until(_port(name, reductions=reds), f, SC, tol=tol, max_iters=200,
                              check_every=4)
    want = r_iterate.solve_until(_ref(name, reductions=reds), rf, SC, tol=tol,
                                 max_iters=200, check_every=4)
    assert got.iters == want.iters and got.err <= tol
    assert all(t.dtype == LOW[name] for t in got.fields.values())
    assert abs(got.err - float(want.err)) <= _eps(name) * float(np.abs(arrays["T"]).max())
    np.testing.assert_allclose(_np(got.fields["T"]), _np(want.fields["T"]), rtol=0,
                               atol=_bound(name, arrays, ("T",), got.iters))


@pytest.mark.parametrize("case,tol", [("porosity", 3e-5), ("gp", 1e-2)])
@pytest.mark.parametrize("name", list(LOW))
def test_coupled_solve_until_matches_reference(case, tol, name, rng):
    """The coupled kernels iterated to ``tol`` on their own residual:
    the same iterations, the error within ``eps max|x|``, the fields within
    ``4 k eps max|x|`` after k steps, carried at the storage dtype."""
    define, nd, arrays, sc = _coupled_case(case, rng)
    out, tgt = ("Pe2", "Pe") if case == "porosity" else ("re2", "re")
    reds = {"err": f"max_abs_diff({out}, {tgt})"}
    f, rf = _both(arrays, name)
    got = iterate.solve_until(_port(name, define, nd).with_reductions(reds), f, sc, tol=tol,
                              max_iters=100, check_every=4)
    want = r_iterate.solve_until(_ref(name, define, nd).with_reductions(reds), rf, sc,
                                 tol=tol, max_iters=100, check_every=4)
    scale = float(np.abs(arrays[tgt]).max())
    assert got.iters == int(want.iters)
    assert abs(got.err - float(want.err)) <= _eps(name) * scale
    for n in arrays:
        assert got.fields[n].dtype == LOW[name]
        np.testing.assert_allclose(_np(got.fields[n]), _np(want.fields[n]), rtol=0,
                                   atol=4 * got.iters * _eps(name) *
                                   float(np.abs(arrays[n]).max()))


def test_reductions_accumulate_f32(rng):
    # 32^3 summands: a bf16 running sum stalls once it reaches about 256
    # (one ulp is 2 there); an f32 one tracks the f64 host fold
    arrays = _fig1_arrays(rng, (32, 32, 32))
    reds = {"s": "sum(T2)", "m2": "sum_sq(T2)", "mx": "max_abs(T2)"}
    f, rf = _both(arrays, "bfloat16")
    out, got = _port("bfloat16", reductions=reds)(**f, **SC)
    _, want = _ref("bfloat16", reductions=reds)(**rf, **SC)
    host = out.double().numpy()
    exact = {"s": host.sum(), "m2": (host * host).sum(), "mx": np.abs(host).max()}
    for n, w in exact.items():
        assert got[n].dtype == torch.float32, n
        # PyTorch folds an f32 sum pairwise: within 1e-5 of the f64 fold;
        # the reference's f32 fold within its own test's 1e-3
        assert abs(float(got[n]) - w) / abs(w) < 1e-5, n
        assert abs(float(want[n]) - w) / abs(w) < 1e-3, n
    assert float(got["mx"]) == float(want["mx"])
    # the fold is of the stored values: a value rounded to storage gives the
    # maximum exactly
    assert float(got["mx"]) == float(out.float().abs().max())


# -- the hand kernel's plain version -----------------------------------------
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", list(LOW))
def test_hand_plain_step_matches_reference_kernel(k, name, rng):
    """``ref.diffusion3d_steps`` at storage dtype (scalars rounded to it,
    each operation rounding to it) within ``eps max|T|`` per step of the
    reference's interpret-mode hand kernel."""
    arrays = _fig1_arrays(rng)
    f, rf = _both(arrays, name)
    args = (0.7, 1e-2, 1.3, 1.1, 0.9)      # every product rounds
    got = ref.diffusion3d_steps(f["T2"], f["T"], f["Ci"], *args, nsteps=k)
    want = r_diffusion3d.diffusion3d_step(rf["T2"], rf["T"], rf["Ci"], *args, nsteps=k)
    assert got.dtype == LOW[name]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=k * _eps(name) * float(np.abs(arrays["T"]).max()))


def test_hand_plain_step_takes_scalars_rounded_to_storage():
    """PyTorch multiplies a bf16 tensor by a Python float in f32 without
    rounding the float: the plain version rounds its scalars first, as the
    reference's kernel holds them at the fields' dtype."""
    lam, dt, h = 1.0, 0.3, 1.0 / 3.0
    sc = ref.stored_scalars(torch.bfloat16, lam, dt, h, h, h)
    want = jnp.array([lam, dt, h ** 2, h ** 2, h ** 2], dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(sc, np.float32), np.asarray(want, np.float32))
    assert sc[1] != dt


# -- bytes, interop, the porosity CLI ----------------------------------------
def test_io_bytes_count_storage_width():
    shapes = {n: SHAPE for n in ("T2", "T", "Ci")}
    port = _port("bfloat16").stencil_ir(**shapes, **SC)
    refk = _ref("bfloat16").stencil_ir(**shapes, **SC)
    isz = {f: 2 for f in port.field_shapes}
    assert port.io_bytes(2, field_itemsizes=isz) == refk.io_bytes(2, field_itemsizes=isz) \
        == port.io_bytes(4) // 2
    assert teff.a_eff_from_ir(port, 2, field_itemsizes=isz) == \
        r_teff.a_eff_from_ir(refk, 2, field_itemsizes=isz)
    # a mixed set: Ci kept at f32
    mixed = {"T2": 2, "T": 2, "Ci": 4}
    assert port.io_bytes(2, field_itemsizes=mixed) == refk.io_bytes(2, field_itemsizes=mixed)


@pytest.mark.parametrize("name", list(LOW))
def test_interop_round_trip(name, rng):
    a = {"T": rng.rand(5, 6, 7).astype(np.float32)}
    t = interop.fields_from_numpy(a, device="cpu", dtype=LOW[name])["T"]
    assert t.dtype == LOW[name]
    assert torch.equal(t, torch.tensor(a["T"]).to(LOW[name]))     # rounded once
    back = interop.fields_to_numpy({"T": t})["T"]
    assert back.dtype == (np.float32 if name == "bfloat16" else np.float16)
    # back to the port bitwise; the reference's own storage array as it is
    assert torch.equal(interop.fields_from_numpy({"T": back}, device="cpu",
                                                 dtype=LOW[name])["T"], t)
    r = np.asarray(jnp.asarray(a["T"]).astype(name))
    assert torch.equal(interop.fields_from_numpy({"T": r}, device="cpu", dtype=LOW[name])["T"],
                       t)
    np.testing.assert_array_equal(back.astype(np.float32), r.astype(np.float32))


@pytest.mark.parametrize("name", list(LOW))
def test_porosity_dtype_matches_reference(name):
    got = pw.solve(pw.PorosityConfig(n=24, nt=8, device="cpu", dtype=name))
    want = r_pw.solve(r_pw.PorosityConfig(n=24, nt=8, dtype=name))
    assert got["phi"].dtype == LOW[name]
    bound = 4 * 8 * _eps(name)
    for n in ("phi", "Pe"):
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), rtol=0,
                                   atol=bound * max(float(np.abs(_np(want[n])).max()), 0.01))
    assert (got["peak0_y"], got["peak_y"]) == (want["peak0_y"], want["peak_y"])


def test_porosity_dtype_cli(capsys):
    pw.main(["--device", "cpu", "--n", "24", "--nt", "8", "--dtype", "bfloat16"])
    pw.main(["--device", "cpu", "--n", "24", "--nt", "8", "--dtype", "float16",
             "--flux-split"])
    out = capsys.readouterr().out
    assert "[torch/bc=neumann/bfloat16 on cpu]" in out
    assert "[torch/flux-split/bc=neumann/float16 on cpu]" in out


def test_dirichlet_value_is_stored_rounded(rng):
    """A dirichlet face holds its value rounded to storage, in the torch
    backend and in the generated kernel's torch form alike."""
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2, dtype=torch.bfloat16)

    @ps.parallel(outputs=("U2",), bc={"U2": BoundaryCondition("dirichlet", value=0.1)})
    def diffuse(U2, U, dt):
        return {"U2": fd2d.inn(U) + dt * (fd2d.d2_xi(U) + fd2d.d2_yi(U))}

    U = torch.tensor(rng.rand(9, 40).astype(np.float32)).to(torch.bfloat16)
    got = diffuse(U2=U, U=U, dt=0.1)
    assert float(got[0, 3]) == ref.stored_value(0.1, torch.bfloat16) != 0.1
    assert torch.equal(diffuse.compiled(U2=U, U=U, dt=0.1).run({"U2": U, "U": U},
                                                               {"dt": 0.1})[0]["U2"], got)
