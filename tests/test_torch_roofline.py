"""The port's stencil roofline record (``repro_torch.launch.roofline``) and
the leftovers of the core API (``teff.io_counts_from_ir``,
``HardwareSpec.ridge_intensity``, ``Measurement``'s percentiles,
``VectorField``/``FieldSet.vector``/``FieldSet.rand``, ``random_porosity``,
``vortex_wavefunction``) on the CPU, against the reference on identical
inputs.

Tolerances: the roofline records, the IO counts and the percentiles are
equal (the same cost model, the same numbers); ``vortex_wavefunction``
within 1e-6 (complex64: ``atan2`` and ``exp`` of two libraries); the
porosity smoothing of the reference's own uniform draw within 1e-6 (f32,
the same operations in the same order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import porosity_waves as r_pw
from repro.core import FieldSet as RFieldSet, Grid as RGrid
from repro.core import teff as r_teff
from repro.data import physics as r_physics
from repro.launch import roofline as r_roofline
from repro_torch.core import FieldSet, Grid, VectorField, teff
from repro_torch.data import physics
from repro_torch.launch import roofline

from test_torch_coupled import _solver_kernel
from test_torch_streaming import SC3, SHAPE3, _port, _ref

H100 = dict(peak_bw=3.35e12, peak_flops=67e12)


def _hw():
    return (teff.HardwareSpec("H100 data sheet", "700.00 W", **H100),
            r_teff.HardwareSpec("H100 data sheet", **H100))


def _fig1_costs():
    shapes = {n: SHAPE3 for n in ("T2", "T", "Ci")}
    port = _port().cost_model(**shapes, **SC3)
    ref = _ref("jnp").cost_model(**shapes, **SC3)
    tiles = [(4, 4, 8), _port().compiled(**shapes, **SC3).cost_tile(),
             _port().marched(0).compiled(**shapes, **SC3).cost_tile()]
    return port, ref, tiles, 3


def _porosity_costs():
    n = 12
    cfg = r_pw.PorosityConfig(n=n)
    ref = r_pw.make_step(r_pw.make_grid(cfg), cfg).kernels[0]
    shapes, sc = {x: (n, n) for x in ("phi2", "Pe2", "phi", "Pe")}, {"dtau": 1.0}
    port = _solver_kernel("porosity", n)
    tiles = [(4, 8), port.compiled(**shapes, **sc).cost_tile(),
             port.marched(1).compiled(**shapes, **sc).cost_tile()]
    return port.cost_model(**shapes, **sc), ref.cost_model(**shapes, **sc), tiles, 2


def _numeric(rec):
    return {k: v for k, v in rec.items() if k != "hw"}


@pytest.mark.parametrize("costs", [_fig1_costs, _porosity_costs], ids=["fig1", "porosity"])
@pytest.mark.parametrize("nsteps", [1, 2, 4])
def test_stencil_roofline_equals_the_reference(costs, nsteps):
    port_cost, ref_cost, tiles, nd = costs()
    port_hw, ref_hw = _hw()
    for tile in (None, *tiles):
        for march in ((None,) if tile is None else (None, *range(nd))):
            for measured in (None, 1e-3, 3.7e-5):
                kw = dict(nsteps=nsteps, measured_s=measured, tile=tile, march_axis=march)
                got = roofline.stencil_roofline(port_cost, hw=port_hw, **kw)
                want = r_roofline.stencil_roofline(ref_cost, hw=ref_hw, **kw)
                assert got["hw"] == "H100 data sheet"
                assert _numeric(got) == want, (tile, march, measured)
    assert "streamed_bytes_per_step" in got and "frac_of_roofline" in got


def test_roofline_records_streamed_traffic():
    cost = _port().cost_model(**{n: SHAPE3 for n in ("T2", "T", "Ci")}, **SC3)
    rec = roofline.stencil_roofline(cost, nsteps=2, tile=(4, 4, 8), march_axis=0)
    assert rec["streamed_bytes_per_step"] < rec["refetched_bytes_per_step"]
    assert rec["march_axis"] == 0


def test_cost_model_roofline_position_on_the_data_sheet():
    cost = _port().cost_model(**{n: SHAPE3 for n in ("T2", "T", "Ci")}, **SC3)
    rec = roofline.stencil_roofline(cost, nsteps=1)
    assert rec["hw"] == roofline.DATA_SHEET
    assert rec["dominant"] == "memory"    # stencils sit far left of the ridge
    assert rec["ridge_flop_per_byte"] == teff.H100_F32_FLOPS / teff.H100_BYTES_PER_S
    assert rec["intensity_flop_per_byte"] < rec["ridge_flop_per_byte"]
    assert rec["bytes_per_step"] == cost.read_bytes + cost.write_bytes
    assert rec["t_memory_s"] == rec["bytes_per_step"] / teff.H100_BYTES_PER_S
    rec4 = roofline.stencil_roofline(cost, nsteps=4)
    assert rec4["bytes_per_step"] == rec["bytes_per_step"] / 4
    # a card with no compute peak: the bytes term alone
    mem_only = teff.HardwareSpec("card", "? W", peak_bw=2e12)
    rec = roofline.stencil_roofline(cost, hw=mem_only, measured_s=1.0)
    assert rec["t_compute_s"] == 0.0 and rec["frac_of_roofline"] == rec["t_memory_s"]
    assert mem_only.ridge_intensity == math.inf


def test_ridge_intensity_equals_the_reference():
    port_hw, ref_hw = _hw()
    assert port_hw.ridge_intensity == ref_hw.ridge_intensity == 67e12 / 3.35e12


def test_io_counts_from_ir_match_the_reference():
    shapes = {n: SHAPE3 for n in ("T2", "T", "Ci")}
    ir = _port().stencil_ir(**shapes, **SC3)
    r_ir = _ref("jnp").stencil_ir(**shapes, **SC3)
    n = int(np.prod(SHAPE3))
    assert teff.io_counts_from_ir(ir) == r_teff.io_counts_from_ir(r_ir) == (2, 1)
    assert teff.a_eff_from_ir(ir, itemsize=4) == teff.a_eff(n, 2, 1, 4)
    n = 12
    pw_shapes = {x: (n, n) for x in ("phi2", "Pe2", "phi", "Pe")}
    cfg = r_pw.PorosityConfig(n=n)
    r_k = r_pw.make_step(r_pw.make_grid(cfg), cfg).kernels[0]
    assert teff.io_counts_from_ir(_solver_kernel("porosity", n).stencil_ir(**pw_shapes, dtau=1.0)) \
        == r_teff.io_counts_from_ir(r_k.stencil_ir(**pw_shapes, dtau=1.0))


@pytest.mark.parametrize("samples", [[0.1, 0.2, 0.3, 0.4, 1.0], [2.5e-4, 2.4e-4, 9e-4, 2.6e-4],
                                     [1e-3]])
def test_measurement_percentiles_equal_the_reference(samples):
    med = float(np.median(samples))
    m = teff.Measurement(median_s=med, ci95_s=(min(samples), max(samples)), samples_s=samples)
    r = r_teff.Measurement(median_s=med, ci95_s=(min(samples), max(samples)), samples_s=samples)
    assert m.percentiles() == r.percentiles()
    assert set(m.percentiles()) == {"mean_s", "p50_s", "p90_s", "max_s"}
    assert m.p50_s <= m.p90_s <= m.max_s and m.max_s == max(samples)
    assert (m.mean_s, m.p50_s, m.p90_s, m.max_s) == (r.mean_s, r.p50_s, r.p90_s, r.max_s)


def test_vector_field_layouts_match_the_reference():
    port_fs = FieldSet(Grid((6, 6)), layout="soa", device="cpu")
    ref_fs = RFieldSet(RGrid((6, 6)), layout="soa")
    for layout in ("soa", "aos"):
        v = port_fs.vector(3, init=1.0, name="V" + layout, layout=layout)
        r = ref_fs.vector(3, init=1.0, name="V" + layout, layout=layout)
        assert v.layout == r.layout == layout and v.ncomp == r.ncomp == 3
        assert tuple(v[0].shape) == tuple(r[0].shape) == (6, 6)
        aos, r_aos = v.as_aos(), r.as_aos()
        assert tuple(aos.components.shape) == tuple(r_aos.components.shape) == (6, 6, 3)
        np.testing.assert_array_equal(aos.components.numpy(), np.asarray(r_aos.components))
        back = aos.as_soa()
        assert back.layout == "soa" and len(back.components) == 3
        assert all(c.is_contiguous() for c in back.components)
        for i in range(3):
            np.testing.assert_array_equal(back[i].numpy(), np.asarray(r_aos.as_soa()[i]))
        doubled, r_doubled = v.map(lambda c: c * 2), r.map(lambda c: c * 2)
        assert float(doubled[2][0, 0]) == float(r_doubled[2][0, 0]) == 2.0
    assert port_fs.nbytes() == ref_fs.nbytes() == 2 * 3 * 36 * 4
    assert set(port_fs.names()) == set(ref_fs.names())
    assert isinstance(port_fs["Vaos"], VectorField)
    with pytest.raises(ValueError, match="layout"):
        FieldSet(Grid((4,)), layout="csr", device="cpu")
    assert FieldSet(Grid((4, 4)), layout="aos", device="cpu").vector(2).components.shape == (4, 4, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fieldset_rand_shape_dtype_range_and_reproducible(dtype):
    fs = FieldSet(Grid((9, 7, 5)), dtype=dtype, device="cpu")
    a = fs.rand(torch.Generator().manual_seed(11), name="A")
    b = fs.rand(torch.Generator().manual_seed(11))
    c = fs.rand(torch.Generator().manual_seed(12))
    assert a.shape == (9, 7, 5) and a.dtype == dtype and a.device.type == "cpu"
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert fs["A"] is a
    assert float(a.float().std()) > 0.2     # uniform on [0, 1): std 0.289


@pytest.mark.parametrize("shape", [(17, 12), (9, 8, 11), (30,)])
def test_random_porosity_smoothing_matches_the_reference(shape):
    grid, r_grid = Grid(shape), RGrid(shape)
    key = jax.random.PRNGKey(7)
    want = r_physics.random_porosity(key, r_grid, mean=0.1, contrast=2.0)
    draw = np.asarray(jax.random.uniform(key, shape, jnp.float32))   # the reference's own draw
    got = physics.smooth_porosity(torch.tensor(draw), mean=0.1, contrast=2.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    phi = physics.random_porosity(torch.Generator().manual_seed(3), grid, device="cpu")
    again = physics.random_porosity(torch.Generator().manual_seed(3), grid, device="cpu")
    assert torch.equal(phi, again) and abs(float(phi.mean()) - 0.1) < 1e-6
    assert float(phi.min()) > 0.0


@pytest.mark.parametrize("shape,n", [((16, 12, 4), 2), ((9, 9), 3), ((10, 14, 3), 1)])
def test_vortex_wavefunction_matches_the_reference(shape, n):
    length = tuple(1.0 + 0.5 * a for a in range(len(shape)))
    got = physics.vortex_wavefunction(Grid(shape, length), n_vortices=n, device="cpu")
    want = np.asarray(r_physics.vortex_wavefunction(RGrid(shape, length), n_vortices=n))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.abs().numpy(), 1.0, atol=1e-6)

