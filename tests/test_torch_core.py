"""The port's numerics substrate against the JAX package: fd operators,
Grid, gaussian_hotspot, FieldSet and the T_eff formulas.

Tolerance: the fd operators are the same slices and the same f32 operations
in the same order, so they agree to within 1 ulp of the largest value (in
practice bitwise). Grid coordinates are computed as jnp.linspace computes
them and agree bitwise; gaussian_hotspot agrees to 1 ulp of its largest
value (the two packages' exp differ in the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Grid as RGrid, teff as rteff
from repro.core.fd import fd1d as rfd1d, fd2d as rfd2d, fd3d as rfd3d
from repro.data.physics import gaussian_hotspot as r_hotspot
from repro_torch.core import FieldSet, Grid, fd1d, fd2d, fd3d, teff
from repro_torch.data.physics import gaussian_hotspot

SHAPES = {1: (17,), 2: (17, 12), 3: (17, 12, 20)}
PAIRS = [(fd1d, rfd1d, 1), (fd2d, rfd2d, 2), (fd3d, rfd3d, 3)]


def ulp(a) -> float:
    return float(np.spacing(np.float32(np.max(np.abs(a)))))


def assert_within_ulp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp(want))


def _op_names(nd):
    names = ["inn", "av", "maxloc"]
    for ax in "xyz"[:nd]:
        names += [f"{k}_{ax}{s}" for k in ("d", "d2", "av") for s in "ai"]
    return names


@pytest.mark.parametrize("fd,rfd,nd", PAIRS, ids=["1d", "2d", "3d"])
def test_fd_operators_match_reference(fd, rfd, nd, rng):
    a = rng.rand(*SHAPES[nd]).astype(np.float32)
    for name in _op_names(nd):
        got = getattr(fd, name)(torch.from_numpy(a))
        want = getattr(rfd, name)(jnp.asarray(a))
        assert_within_ulp(got, want)


@pytest.mark.parametrize("fd,rfd,nd", PAIRS, ids=["1d", "2d", "3d"])
def test_fd_laplacian_matches_reference(fd, rfd, nd, rng):
    a = rng.rand(*SHAPES[nd]).astype(np.float32)
    inv = tuple(float(s - 1) for s in SHAPES[nd])
    assert_within_ulp(fd.laplacian(torch.from_numpy(a), inv),
                      rfd.laplacian(jnp.asarray(a), inv))


def test_fd_quadratic_field_has_constant_laplacian():
    g = Grid((16, 16, 16))
    x, _, _ = g.meshgrid(device="cpu")
    lap = fd3d.laplacian(x ** 2, g.inv_spacing)
    np.testing.assert_allclose(lap.numpy(), 2.0, rtol=1e-3)


@pytest.mark.parametrize("shape,length", [((17, 12, 20), (1.0, 2.0, 0.5)),
                                          ((16, 16, 16), ())])
def test_grid_matches_reference(shape, length):
    g, r = Grid(shape, length), RGrid(shape, length)
    assert g.spacing == r.spacing
    assert g.inv_spacing == r.inv_spacing
    assert g.n_points == r.n_points
    assert g.interior_shape == r.interior_shape
    assert g.stable_diffusion_dt(0.5) == r.stable_diffusion_dt(0.5)
    for got, want in zip(g.coords(device="cpu"), r.coords()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(g.meshgrid(device="cpu"), r.meshgrid()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,length,radius,factors", [
    ((18, 34, 10), (1.0, 2.0, 0.5), 1, (2, 4, 1)), ((512, 512, 512), (), 1, (2, 2, 1)),
    ((20, 12, 9), (), 2, (2, 1, 1))])
def test_grid_decomposition_matches_reference(shape, length, radius, factors):
    from repro.core.grid import human_bytes as r_human, volume_bytes as r_volume
    from repro_torch.core.grid import human_bytes, volume_bytes

    g, r = Grid(shape, length, radius), RGrid(shape, length, radius)
    assert g.interior_slice == r.interior_slice
    sub, rsub = g.subgrid(factors), r.subgrid(factors)
    assert (sub.shape, sub.length, sub.radius) == (rsub.shape, rsub.length, rsub.radius)
    with pytest.raises(ValueError, match="not divisible"):
        g.subgrid((7, 1, 1))
    with pytest.raises(ValueError, match="one decomposition factor"):
        g.subgrid((2, 2))
    assert volume_bytes(shape, torch.float32) == r_volume(shape, jnp.float32)
    assert volume_bytes(shape, torch.bfloat16) == r_volume(shape, jnp.bfloat16)
    for n in (0, 1023, 1024, 3 * 2 ** 20 + 5, 2 ** 45, 2 ** 52):
        assert human_bytes(n) == r_human(n)


def test_grid_validation():
    with pytest.raises(ValueError, match="too small"):
        Grid((2, 8))
    with pytest.raises(ValueError, match="incompatible"):
        Grid((8, 8), (1.0,))


@pytest.mark.parametrize("shape", [(17, 12, 20), (16, 16, 16)])
def test_gaussian_hotspot_matches_reference(shape):
    got = gaussian_hotspot(Grid(shape), amplitude=1.0, width=0.1, device="cpu")
    want = r_hotspot(RGrid(shape), amplitude=1.0, width=0.1)
    assert_within_ulp(got, want)


def test_fieldset_alloc_and_registry():
    fs = FieldSet(Grid((5, 6, 7)), device="cpu")
    z, o, f = fs.zeros("z"), fs.ones("o"), fs.full(2.5, "f")
    assert z.shape == (5, 6, 7) and z.dtype == torch.float32
    assert float(o.sum()) == 5 * 6 * 7 and float(f.max()) == 2.5
    x = fs.from_fn(lambda x, y, z: x + 10 * y, "x")
    assert float(x[-1, 0, 0]) == 1.0 and float(x[0, -1, 0]) == 10.0
    assert fs.names() == ["z", "o", "f", "x"] and fs["f"] is f
    assert fs.nbytes() == 4 * 5 * 6 * 7 * 4


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="is_available"):
        FieldSet(Grid((5, 5, 5)))
    with pytest.raises(RuntimeError, match="is_available"):
        Grid((5, 5, 5)).coords()
    with pytest.raises(RuntimeError, match="needs the card"):
        teff.measure(lambda: None)
    with pytest.raises(RuntimeError, match="needs the card"):
        teff.measure_device_bandwidth(1 << 20)


def test_teff_formulas_match_reference():
    assert teff.a_eff(512 ** 3, 2, 1, 4) == rteff.a_eff(512 ** 3, 2, 1, 4) == 3 * 512 ** 3 * 4
    assert teff.a_eff_blocked(1000, 2, 1, 4, 4) == rteff.a_eff_blocked(1000, 2, 1, 4, 4)
    for fused in (True, False):
        assert teff.a_eff_checked(1e9, 4e8, 10, fused) == rteff.a_eff_checked(1e9, 4e8, 10, fused)
    assert teff.t_eff(1e9, 0.5) == rteff.t_eff(1e9, 0.5)
    hw = teff.HardwareSpec("card", "700.00 W", peak_bw=2e12)
    assert teff.fraction(1e12, hw) == 0.5
    m = teff.Measurement(0.002, (0.001, 0.003), [0.002])
    assert m.t_eff(1e9) == 5e11
