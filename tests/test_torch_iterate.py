"""The port's ``solve_until`` against the JAX package's, and the Fig. 1 slice
end to end (the quickstart's main path) on the CPU.

Tolerances: the port and the reference must take the same number of steps;
fields agree to atol 1e-5 after hundreds of steps in two frameworks (as
the reference's own cross-backend test holds them) and the error value to
rtol 1e-5. The host loop reads the error once per check, so ``host_syncs``
is exactly ``iters // check_every``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_parallel_stencil as r_init, iterate as r_iterate
from repro_torch.configs import Diffusion3DConfig
from repro_torch.core import fd3d, init_parallel_stencil, iterate
from repro_torch.examples import quickstart
from repro_torch.interop import fields_from_numpy, fields_to_numpy


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def _kernels(reds):
    port = init_parallel_stencil(backend="torch", device="cpu").parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=reds)(fig1)
    ref = r_init(backend="jnp").parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=reds)(fig1)
    return port, ref


def _setup(rng, shape=(12, 12, 12)):
    T = rng.rand(*shape).astype(np.float32)
    Ci = (rng.rand(*shape) + 0.5).astype(np.float32)
    return {"T2": T, "T": T, "Ci": Ci}, dict(lam=1.0, dt=0.05, _dx=1.0, _dy=1.0, _dz=1.0)


@pytest.mark.parametrize("check_every", [5, 10])
def test_solve_until_matches_reference(check_every, rng):
    arrays, sc = _setup(rng)
    port, ref = _kernels({"err": "max_abs_diff(T2, T)"})
    res = iterate.solve_until(port, fields_from_numpy(arrays, device="cpu"), sc, tol=2e-5,
                              max_iters=400, check_every=check_every)
    want = r_iterate.solve_until(ref, {n: jnp.asarray(a) for n, a in arrays.items()}, sc,
                                 tol=2e-5, max_iters=400, check_every=check_every)
    assert 0 < res.iters < 400, "should converge before the cap"
    assert res.iters == int(want.iters)
    assert res.host_syncs == res.iters // check_every
    np.testing.assert_allclose(res.err, float(want.err), rtol=1e-5)
    got = fields_to_numpy(res.fields)
    for n in ("T", "T2"):
        np.testing.assert_allclose(got[n], np.asarray(want.fields[n]), atol=1e-5)
    assert res.output(port) is res.fields["T"]


def test_solve_until_matches_host_loop(rng):
    arrays, sc = _setup(rng)
    port, _ = _kernels({"err": "max_abs_diff(T2, T)"})
    f = fields_from_numpy(arrays, device="cpu")
    res = iterate.solve_until(port, f, sc, tol=2e-5, max_iters=400, check_every=5)
    plain = port.with_reductions(None)
    cur, it, err = dict(T2=f["T2"], T=f["T"]), 0, np.inf
    while err > 2e-5 and it < 400:
        for _ in range(5):
            out = plain(T2=cur["T2"], T=cur["T"], Ci=f["Ci"], **sc)
            cur["T2"], cur["T"] = cur["T"], out
            it += 1
        err = float((cur["T"] - cur["T2"]).abs().max())
    assert res.iters == it and res.err == err
    assert torch.equal(res.fields["T"], cur["T"])


def test_solve_until_cap_and_until_above(rng):
    arrays, sc = _setup(rng, (10, 10, 10))
    port, ref = _kernels({"m": "sum_sq(T2)"})
    f = fields_from_numpy(arrays, device="cpu")
    m0 = float((f["T"] ** 2).sum())
    res = iterate.solve_until(port, f, dict(sc, dt=1e-3), tol=1e-12, max_iters=50,
                              check_every=5, error=lambda r: abs(r["m"] - m0) / m0,
                              until="above")
    assert res.iters == 5 and res.err > 1e-12 and res.host_syncs == 1
    capped = iterate.solve_until(port.with_reductions({"e": "max_abs_diff(T2, T)"}), f, sc,
                                 tol=0.0, max_iters=12, check_every=5)
    assert capped.iters == 15 and capped.host_syncs == 3   # overshoot < check_every


@pytest.mark.parametrize("checkpointed", [False, True])
def test_stop_rule_compares_the_error_at_f32(checkpointed, rng, tmp_path):
    """A callable ``error=`` that computes in f64 and lands between ``tol``
    and the f32 value above it. Both packages round the error to f32
    before the comparison, so both stop at the check whose reduction
    reaches ``tol`` (each package's own f32 value of the reduction there)."""
    arrays, sc = _setup(rng)
    port, ref = _kernels({"err": "max_abs_diff(T2, T)"})
    k, c = 20, 1.0 + 2.0 ** -30          # c is 1.0 at f32, above 1 at f64
    f = fields_from_numpy(arrays, device="cpu")
    jf = {n: jnp.asarray(a) for n, a in arrays.items()}
    tol_port = iterate.solve_until(port, f, sc, tol=0.0, max_iters=k, check_every=5).err
    tol_ref = float(r_iterate.solve_until(ref, jf, sc, tol=0.0, max_iters=k,
                                          check_every=5).err)
    assert tol_port * c > tol_port       # the f64 error lies above tol ...
    assert np.float32(tol_port * c) == np.float32(tol_port)   # ... its f32 value on it
    ckpt = iterate.Checkpointing(str(tmp_path / "ck"), save_every=1) if checkpointed else None
    res = iterate.solve_until(port, f, sc, tol=tol_port, max_iters=400, check_every=5,
                              error=lambda reds: float(reds["err"]) * c, checkpoint=ckpt)
    want = r_iterate.solve_until(ref, jf, sc, tol=tol_ref, max_iters=400, check_every=5,
                                 error=lambda reds: reds["err"] * c)
    assert res.iters == int(want.iters) == k
    assert res.err == tol_port


def test_solve_until_argument_errors(rng):
    port, _ = _kernels(None)
    arrays, sc = _setup(rng, (6, 6, 6))
    f = fields_from_numpy(arrays, device="cpu")
    with pytest.raises(ValueError, match="fused reductions"):
        iterate.solve_until(port, f, sc, tol=1e-3, max_iters=5)
    two = port.with_reductions({"a": "max_abs(T2)", "b": "sum(T2)"})
    with pytest.raises(ValueError, match="pass error="):
        iterate.solve_until(two, f, sc, tol=1e-3, max_iters=5)
    with pytest.raises(ValueError, match="not a declared reduction"):
        iterate.solve_until(two, f, sc, tol=1e-3, max_iters=5, error="c")
    with pytest.raises(ValueError, match="check_every"):
        iterate.solve_until(two, f, sc, tol=1e-3, max_iters=5, error="a", check_every=0)
    with pytest.raises(ValueError, match="until"):
        iterate.solve_until(two, f, sc, tol=1e-3, max_iters=5, error="a", until="never")
    norot = init_parallel_stencil(backend="torch", device="cpu").parallel(
        outputs=("T2",), reductions={"e": "max_abs(T2)"})(fig1)
    with pytest.raises(ValueError, match="rotations"):
        iterate.solve_until(norot, f, sc, tol=1e-3, max_iters=5)


def test_quickstart_main_path_on_cpu():
    """The slice end to end at a small size: @parallel time loop, the
    explicit kernel from the same state (bitwise equal), solve_until, and
    the maximum principle of the Fig. 1 initial state."""
    cfg = Diffusion3DConfig(nx=17, ny=12, nz=20, nt=10)
    r = quickstart.run(cfg, device="cpu", tol=1e-7, max_iters=100, check_every=10)
    assert r.step.ps.backend == "torch"
    assert torch.equal(r.T, r.T_explicit)
    T = r.solve.output(r.step)
    for t in (r.T, T):
        assert bool(torch.isfinite(t).all())
        assert 1.7 - 1e-6 <= float(t.min()) and float(t.max()) <= 2.7 + 1e-6
    assert r.solve.iters == 100 and r.solve.host_syncs == 10
    with pytest.raises(SystemExit):
        quickstart.main(["--device", "tpu"])
