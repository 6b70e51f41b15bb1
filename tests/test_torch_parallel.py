"""The port's ``@parallel`` against the JAX package's: one Fig. 1 step, the
four reduction kinds, a one-sided and a two-output kernel, and the errors
for every feature not ported yet.

Tolerances: the port's ``torch`` backend against the reference's ``jnp``
backend, rtol = atol = 1e-6 (two frameworks' f32 kernels; XLA may fuse).
Against the reference's Pallas kernel in interpret mode, 1e-5: it squares
the scalars in f32 (``stencil.py:1066-1069``) where both plain paths square
them in Python double. Reductions against the reference's fused values,
rtol 1e-5 (sums fold in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_parallel_stencil as r_init
from repro_torch.core import fd2d, fd3d, init_parallel_stencil
from repro_torch.interop import fields_from_numpy

ALL_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}
SHAPES = [(17, 12, 20), (16, 16, 16)]


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def _state(rng, shape):
    T = rng.rand(*shape).astype(np.float32)
    arrays = {"T2": rng.rand(*shape).astype(np.float32), "T": T,
              "Ci": (rng.rand(*shape) + 0.5).astype(np.float32)}
    sc = dict(lam=1.0, dt=1e-3, _dx=float(shape[0] - 1), _dy=float(shape[1] - 1),
              _dz=float(shape[2] - 1))
    return arrays, sc


def _port(reductions=None, **kw):
    ps = init_parallel_stencil(backend="torch", device="cpu", **kw)
    return ps.parallel(outputs=("T2",), rotations={"T2": "T"}, reductions=reductions)(fig1)


def _ref(backend, reductions=None):
    ps = r_init(backend=backend)
    return ps.parallel(outputs=("T2",), rotations={"T2": "T"}, reductions=reductions)(fig1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("backend,tol", [("jnp", 1e-6), ("pallas", 1e-5)])
def test_fig1_step_matches_reference(shape, backend, tol, rng):
    arrays, sc = _state(rng, shape)
    got = _port()(**fields_from_numpy(arrays, device="cpu"), **sc)
    want = _ref(backend)(**{n: jnp.asarray(a) for n, a in arrays.items()}, **sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    # the ring keeps T2's values exactly
    np.testing.assert_array_equal(got.numpy()[0], arrays["T2"][0])
    np.testing.assert_array_equal(got.numpy()[:, :, -1], arrays["T2"][:, :, -1])


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_reductions_match_reference_fused_values(backend, rng):
    arrays, sc = _state(rng, (17, 12, 20))
    outs, reds = _port(ALL_REDS)(**fields_from_numpy(arrays, device="cpu"), **sc)
    r_outs, r_reds = _ref(backend, ALL_REDS)(**{n: jnp.asarray(a) for n, a in arrays.items()},
                                             **sc)
    assert set(reds) == set(ALL_REDS)
    for n in ALL_REDS:
        assert reds[n].shape == () and reds[n].dtype == torch.float32
        np.testing.assert_allclose(float(reds[n]), float(r_reds[n]), rtol=1e-5, err_msg=n)


def test_reductions_fold_new_outputs_and_current_inputs(rng):
    arrays, sc = _state(rng, (9, 10, 11))
    f = fields_from_numpy(arrays, device="cpu")
    kern = _port(ALL_REDS)
    out, reds = kern(**f, **sc)
    assert float(reds["err"]) == float((out - f["T"]).abs().max())
    assert float(reds["mx"]) == float(out.abs().max())
    assert torch.equal(reds["s"], out.sum()) and torch.equal(reds["m2"], (out * out).sum())
    assert kern.apply_reductions({"T2": out}, f).keys() == reds.keys()


def test_two_output_and_upwind_kernels_match_reference(rng):
    def coupled(U2, V2, U, V, dt):
        return {"U2": fd2d.inn(U) + dt * fd2d.d2_xi(V),
                "V2": fd2d.inn(V) - dt * fd2d.d2_yi(U)}

    def upwind(T2, T, dt):
        return {"T2": fd2d.inn(T) + dt * (T[:-2, 1:-1] - T[1:-1, 1:-1])}

    shape = (17, 12)
    arrays = {n: rng.rand(*shape).astype(np.float32) for n in ("U2", "V2", "U", "V")}
    port = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    ref = r_init(backend="jnp", ndims=2)
    got = port.parallel(outputs=("U2", "V2"))(coupled)(
        **fields_from_numpy(arrays, device="cpu"), dt=0.1)
    want = ref.parallel(outputs=("U2", "V2"))(coupled)(
        **{n: jnp.asarray(a) for n, a in arrays.items()}, dt=0.1)
    for n in ("U2", "V2"):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=1e-6, atol=1e-6)
    a = {"T2": arrays["U2"], "T": arrays["U"]}
    got = port.parallel(outputs=("T2",))(upwind)(**fields_from_numpy(a, device="cpu"), dt=0.1)
    want = ref.parallel(outputs=("T2",))(upwind)(**{n: jnp.asarray(v) for n, v in a.items()},
                                                 dt=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_unported_features_raise_not_implemented(rng):
    ps = init_parallel_stencil(backend="torch", device="cpu")
    with pytest.raises(NotImplementedError, match="bc"):
        ps.parallel(outputs=("T2",), bc={"T2": "dirichlet"})
    with pytest.raises(NotImplementedError, match="march_axis"):
        ps.parallel(outputs=("T2",), march_axis=0)
    for kind in ("finite", "nan_count"):
        with pytest.raises(NotImplementedError, match="finite/nan_count"):
            ps.parallel(outputs=("T2",), reductions={"g": f"{kind}(T2)"})(fig1)
    with pytest.raises(NotImplementedError, match="sub-f32"):
        init_parallel_stencil(backend="torch", device="cpu", dtype=torch.bfloat16)
    arrays, sc = _state(rng, (9, 10, 11))
    f = fields_from_numpy(arrays, device="cpu")
    with pytest.raises(NotImplementedError, match="run_steps"):
        _port().run_steps(2, **f, **sc)
    assert torch.equal(_port().run_steps(1, **f, **sc), _port()(**f, **sc))

    @ps.parallel(outputs=("qx",))
    def flux(qx, P):
        return {"qx": P[1:] - P[:-1]}

    with pytest.raises(NotImplementedError, match="staggered"):
        flux(qx=torch.zeros(8, 9, 10), P=torch.zeros(9, 9, 10))


def test_cuda_backend_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="is_available"):
        init_parallel_stencil()
    with pytest.raises(RuntimeError, match="is_available"):
        init_parallel_stencil(backend="cuda", device="cuda")


def test_argument_checks(rng):
    with pytest.raises(ValueError, match="backend='cuda' runs"):
        init_parallel_stencil(backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="backend must be"):
        init_parallel_stencil(backend="pallas", device="cpu")
    arrays, sc = _state(rng, (9, 10, 11))
    kern = _port()
    with pytest.raises(TypeError, match="torch tensors"):
        kern(**arrays, **sc)
    with pytest.raises(ValueError, match="not a field"):
        kern(T=torch.zeros(9, 10, 11), Ci=torch.zeros(9, 10, 11), **sc)
    # dtype may be cast at the rim; the result is float32
    f = fields_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert kern(**f, **sc).dtype == torch.float32


def test_variants_ir_and_launch_info(rng):
    kern = _port(ALL_REDS)
    plain = kern.with_reductions(None)
    assert plain.reductions == {} and kern.with_reductions(None) is plain
    assert kern.with_reductions(ALL_REDS) is kern
    assert plain.with_reductions({"err": "max_abs_diff(T2, T)"}).label == "fig1[err]"
    ir = kern.stencil_ir(T2=(9, 10, 11), T=(9, 10, 11), Ci=(9, 10, 11), lam=1.0, dt=1.0,
                         _dx=1.0, _dy=1.0, _dz=1.0)
    assert ir.io_counts() == (2, 1) and set(ir.reductions) == set(ALL_REDS)
    assert kern.launch_info == {}
    arrays, sc = _state(rng, (9, 10, 11))
    out = plain(**fields_from_numpy(arrays, device="cpu"), **sc)
    assert isinstance(out, torch.Tensor) and out.shape == (9, 10, 11)
