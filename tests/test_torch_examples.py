"""The port's twins of the paper's two coupled solvers against the JAX
package's (``examples/porosity_waves.py``, ``examples/gross_pitaevskii.py``),
on the CPU with the ``torch`` backend.

Porosity starts bitwise equal in both packages (``Grid.meshgrid`` and
``torch.exp`` give the reference's values here); GP's ``init_state``
normalizes by a sum taken in another order, so its cases start both
packages from the reference's numpy state. Tolerances: the fixed-step runs
atol 2e-6 (the reference's own jnp-vs-pallas bound for these solvers; f32
steps in two frameworks), the flux-split scheme against the fused one atol
1e-7 (the reference's bound), ``POROSITY_GOLDEN`` within the tolerances of
``tests/test_examples.py``, GP's mass drift under 0.05 as there. The
reference's interpret-mode Pallas path appears in one case per solver, at
n <= 12.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import gross_pitaevskii as r_gp
from examples import porosity_waves as r_pw
from repro_torch.examples import gross_pitaevskii as gp
from repro_torch.examples import porosity_waves as pw
from test_examples import POROSITY_GOLDEN


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_porosity_golden_regression():
    r = pw.solve(pw.PorosityConfig(n=32, nt=40, device="cpu"))
    assert np.isclose(r["phi_min"], POROSITY_GOLDEN["phi_min"], rtol=1e-4)
    assert np.isclose(r["phi_max"], POROSITY_GOLDEN["phi_max"], rtol=1e-4)
    assert np.isclose(r["pe_absmax"], POROSITY_GOLDEN["pe_absmax"], rtol=5e-4)
    assert np.isclose(float(r["phi"].sum()), POROSITY_GOLDEN["phi_sum"], rtol=1e-5)


def test_porosity_initial_state_is_the_reference_bitwise():
    _, phi, Pe = pw.init_state(pw.PorosityConfig(n=24, device="cpu"))
    _, r_phi, r_Pe = r_pw.init_state(r_pw.PorosityConfig(n=24))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(r_phi))
    np.testing.assert_array_equal(Pe.numpy(), np.asarray(r_Pe))


@pytest.mark.parametrize("bc", ["neumann", "dirichlet", "periodic", "none"])
@pytest.mark.parametrize("flux_split", [False, True])
def test_porosity_matches_reference(bc, flux_split):
    got = pw.solve(pw.PorosityConfig(n=24, nt=8, device="cpu", bc=bc, flux_split=flux_split))
    want = r_pw.solve(r_pw.PorosityConfig(n=24, nt=8, bc=bc, flux_split=flux_split))
    for n in ("phi", "Pe"):
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), atol=2e-6)
    assert (got["peak0_y"], got["peak_y"]) == (want["peak0_y"], want["peak_y"])


@pytest.mark.parametrize("bc", ["neumann", "dirichlet", "periodic"])
def test_porosity_flux_split_matches_fused(bc):
    fused = pw.solve(pw.PorosityConfig(n=24, nt=8, device="cpu", bc=bc))
    split = pw.solve(pw.PorosityConfig(n=24, nt=8, device="cpu", bc=bc, flux_split=True))
    for n in ("phi", "Pe"):
        np.testing.assert_allclose(_np(fused[n]), _np(split[n]), atol=1e-7)


def test_porosity_matches_reference_pallas_interpret():
    got = pw.solve(pw.PorosityConfig(n=12, nt=4, device="cpu"))
    want = r_pw.solve(r_pw.PorosityConfig(n=12, nt=4, backend="pallas"))
    for n in ("phi", "Pe"):
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), atol=2e-6)


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_porosity_steady_state_matches_reference(bc):
    """``--tol``: the fused ``max_abs_diff(Pe2, Pe)`` epilogue drives
    ``solve_until``; the reference's device loop and the port's host loop
    take the same number of steps here (the residual is far from tol at
    each check but the last), and their residuals agree to 1e-6 relative."""
    kw = dict(n=24, nt=400, bc=bc, tol=2e-4, check_every=10)
    got = pw.solve(pw.PorosityConfig(device="cpu", **kw))
    want = r_pw.solve(r_pw.PorosityConfig(**kw))
    assert got["iters"] == want["iters"] < 400
    assert got["host_syncs"] == got["iters"] // 10
    np.testing.assert_allclose(got["residual"], want["residual"], rtol=1e-6)
    for n in ("phi", "Pe"):
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), atol=2e-6)


def test_porosity_refusals(tmp_path):
    # --dtype bfloat16/float16 are ported (tests/test_torch_mixed.py); f64
    # storage is not
    with pytest.raises(NotImplementedError, match="f64 storage"):
        pw.solve(pw.PorosityConfig(n=12, nt=1, device="cpu", dtype="float64"))
    # --checkpoint-dir is ported (tests/test_torch_checkpoint.py): the
    # checkpointed --tol solve equals the plain one
    kw = dict(n=12, nt=20, device="cpu", tol=1e-3, check_every=5)
    ck = pw.solve(pw.PorosityConfig(**kw, checkpoint_dir=str(tmp_path), save_every=2))
    plain = pw.solve(pw.PorosityConfig(**kw))
    assert ck["iters"] == plain["iters"] and torch.equal(ck["Pe"], plain["Pe"])
    assert os.path.isfile(tmp_path / "LATEST")
    with pytest.raises(SystemExit):
        pw.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path)])   # needs --tol
    with pytest.raises(ValueError, match="flux-split"):
        pw.solve(pw.PorosityConfig(n=12, nt=1, device="cpu", tol=1e-3, flux_split=True))
    with pytest.raises(ValueError, match="periodic"):
        pw.solve(pw.PorosityConfig(n=12, nt=1, device="cpu", tol=1e-3, bc="periodic"))
    with pytest.raises(ValueError, match="backend='cuda' runs"):
        pw.solve(pw.PorosityConfig(n=12, nt=1, device="cpu", backend="cuda"))


def _gp_state(n):
    """The reference's initial state, as numpy arrays and as CPU tensors."""
    _, re, im, V = r_gp.init_state(r_gp.GPConfig(n=n))
    arrays = tuple(np.asarray(a) for a in (re, im, V))
    return arrays, tuple(torch.tensor(a) for a in arrays)


def _r_gp_solve(cfg, arrays):
    """The reference's ``solve`` loop from a given state (its ``solve``
    makes its own)."""
    grid = r_gp.make_grid(cfg)
    re, im, V = (jnp.asarray(a) for a in arrays)
    step = r_gp.make_step(grid, cfg)
    for _ in range(cfg.nt):
        re, im = step(re, im, r_gp.timestep(grid), V)
    return re, im


def test_gp_initial_state_within_a_few_ulp_of_the_reference():
    arrays, _ = _gp_state(12)
    _, re, im, V = gp.init_state(gp.GPConfig(n=12, device="cpu"))
    np.testing.assert_array_equal(V.numpy(), arrays[2])
    # the normalizing sums differ in their last bit: each value by a few ulp
    np.testing.assert_allclose(re.numpy(), arrays[0], rtol=3 * 2.0 ** -23, atol=0)


def test_gp_mass_conservation():
    r = gp.solve(gp.GPConfig(n=16, nt=40, device="cpu"))
    assert np.isfinite(r["mass"]) and r["drift"] < 0.05
    assert float(r["re"][0].abs().max()) < 0.05


@pytest.mark.parametrize("bc", ["none", "neumann", "dirichlet", "periodic"])
@pytest.mark.parametrize("fused", [True, False])
def test_gp_matches_reference(bc, fused):
    arrays, state = _gp_state(12)
    got = gp.solve(gp.GPConfig(n=12, nt=6, device="cpu", bc=bc, fused=fused), state=state)
    want = _r_gp_solve(r_gp.GPConfig(n=12, nt=6, bc=bc, fused=fused), arrays)
    np.testing.assert_allclose(got["re"].numpy(), np.asarray(want[0]), atol=2e-6)
    np.testing.assert_allclose(got["im"].numpy(), np.asarray(want[1]), atol=2e-6)


def test_gp_matches_reference_pallas_interpret():
    arrays, state = _gp_state(12)
    got = gp.solve(gp.GPConfig(n=12, nt=3, device="cpu"), state=state)
    want = _r_gp_solve(r_gp.GPConfig(n=12, nt=3, backend="pallas"), arrays)
    np.testing.assert_allclose(got["re"].numpy(), np.asarray(want[0]), atol=2e-6)
    np.testing.assert_allclose(got["im"].numpy(), np.asarray(want[1]), atol=2e-6)


@pytest.mark.parametrize("tol", [0.05, 1e-3])
def test_gp_drift_guard_matches_reference(tol):
    """``sum_sq`` epilogues and ``solve_until(until="above")``: a loose tol
    runs to the cap, a tight one trips at a check; both packages stop at
    the same step with drifts within 1e-5 (the reference's own
    jnp-vs-pallas bound for GP's drift)."""
    arrays, state = _gp_state(12)
    got = gp.solve(gp.GPConfig(n=12, nt=20, device="cpu", tol=tol, check_every=5),
                   state=state)
    want = r_gp.solve(r_gp.GPConfig(n=12, nt=20, tol=tol, check_every=5))
    assert got["iters"] == want["iters"] and got["tripped"] == want["tripped"]
    assert got["tripped"] == (tol < 0.01)
    assert got["host_syncs"] == got["iters"] // 5
    assert abs(got["drift"] - want["drift"]) < 1e-5


def test_gp_refusals(tmp_path):
    # --checkpoint-dir is ported: the checkpointed guarded run equals the plain one
    kw = dict(n=12, nt=10, device="cpu", tol=1e-3, check_every=5)
    ck = gp.solve(gp.GPConfig(**kw, checkpoint_dir=str(tmp_path), save_every=1))
    plain = gp.solve(gp.GPConfig(**kw))
    assert ck["iters"] == plain["iters"] and torch.equal(ck["re"], plain["re"])
    assert ck["drift"] == plain["drift"] and os.path.isfile(tmp_path / "LATEST")
    with pytest.raises(SystemExit):
        gp.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path)])   # needs --tol
    with pytest.raises(ValueError, match="two-launch"):
        gp.solve(gp.GPConfig(n=12, nt=1, device="cpu", tol=1e-3, fused=False))
    with pytest.raises(ValueError, match="periodic"):
        gp.solve(gp.GPConfig(n=12, nt=1, device="cpu", tol=1e-3, bc="periodic"))


def test_clis_on_the_cpu(capsys):
    pw.main(["--device", "cpu", "--n", "24", "--nt", "8"])
    gp.main(["--device", "cpu", "--n", "12", "--nt", "4", "--bc", "neumann"])
    gp.main(["--device", "cpu", "--n", "12", "--nt", "20", "--tol", "0.05"])
    out = capsys.readouterr().out
    assert "porosity wave: 8 steps on (24, 24) [torch/bc=neumann on cpu]" in out
    assert "GP: 4 steps on (12, 12, 12) [torch/fused/bc=neumann on cpu]" in out
    assert "drift stayed under tol after 20 steps" in out
