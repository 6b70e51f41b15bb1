"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one. This file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: each kernel must equal its plain version bitwise (the build
passes --fmad=false, so every multiply and add rounds on its own as
PyTorch's operators do). Max reductions are bitwise too; sums fold in
another order and are held to rtol 1e-5. (A ``pow`` with an exponent other
than 2, 3 or 0.5 compiles to ``powf``, documented within 4 ulp; no kernel
here uses one.)
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import Diffusion3DConfig
from repro_torch.core import fd2d, fd3d, init_parallel_stencil, teff
from repro_torch.examples import quickstart
from repro_torch.kernels import diffusion3d, ref, stencil

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def upwind(T2, T, dt):
    return {"T2": fd2d.inn(T) + dt * (T[:-2, 1:-1] - T[1:-1, 1:-1])}


def two_out(A2, B2, A, B, c, h):
    return {
        "A2": A[2:-2, 2:-2, 2:-2] + c * (A[4:, 2:-2, 2:-2] - A[:-4, 2:-2, 2:-2])
        - (1.0 - B[2:-2, 2:-2, 1:-3]) * h,
        "B2": B[1:-1, 1:-1, 1:-1] / (2.0 + abs(A[1:-1, :-2, 1:-1])) - h ** 2 * B[1:-1, 1:-1, 2:],
    }


CASES = {
    "fig1": (fig1, ("T2",), 3, ("T2", "T", "Ci"), (33, 20, 130),
             dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0),
             {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
              "m2": "sum_sq(T2)"}),
    "upwind": (upwind, ("T2",), 2, ("T2", "T"), (33, 130), dict(dt=1e-3),
               {"e": "max_abs_diff(T2, T)"}),
    "two_out": (two_out, ("A2", "B2"), 3, ("A2", "B2", "A", "B"), (33, 20, 130),
                dict(c=0.3, h=0.7), {"d": "max_abs_diff(A2, A)", "s": "sum_sq(B2)"}),
}


def _rand(rng, shape, card):
    return torch.tensor(rng.rand(*shape).astype(np.float32) + 0.5, device=card)


@pytest.mark.parametrize("shape", [(33, 20, 130), (16, 16, 16)])
def test_diffusion3d_equals_plain_bitwise(card, shape, rng):
    T, T2, Ci = (_rand(rng, shape, card) for _ in range(3))
    args = (1.0, 1e-4, 32.0, 19.0, 129.0)
    before = diffusion3d.launches
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *args)
    torch.cuda.synchronize()
    assert diffusion3d.launches == before + 1
    assert torch.equal(got, ref.diffusion3d_step(T2, T, Ci, *args))
    with pytest.raises(ValueError, match="several devices"):
        diffusion3d.diffusion3d_step(T2.cpu(), T, Ci, *args)
    with pytest.raises(TypeError, match="float32"):
        diffusion3d.diffusion3d_step(T2.double(), T.double(), Ci.double(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        diffusion3d.diffusion3d_step(T2, T.transpose(0, 1).contiguous().transpose(0, 1), Ci,
                                     *args)


@pytest.mark.parametrize("case", list(CASES))
def test_generated_kernel_equals_torch_backend(card, case, rng):
    fn, outs, nd, names, shape, sc, reds = CASES[case]
    f = {n: _rand(rng, shape, card) for n in names}
    k = init_parallel_stencil(ndims=nd).parallel(outputs=outs, reductions=reds)(fn)
    p = init_parallel_stencil(backend="torch", device="cuda", ndims=nd) \
        .parallel(outputs=outs, reductions=reds)(fn)
    before = stencil.launches[k.label]
    (got, got_reds), (want, want_reds) = k(**f, **sc), p(**f, **sc)
    assert stencil.launches[k.label] == before + 1
    got = {outs[0]: got} if len(outs) == 1 else got
    want = {outs[0]: want} if len(outs) == 1 else want
    for o in outs:
        assert torch.equal(got[o], want[o]), o
    for n, r in k.reductions.items():
        if r.combine == "max":
            assert float(got_reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(got_reds[n]), float(want_reds[n]), rtol=1e-5)
    assert k.launch_info


def test_quickstart_backends_agree_on_the_card(card):
    cfg = Diffusion3DConfig(nx=32, ny=24, nz=40, nt=20)
    rc = quickstart.run(cfg, device="cuda", backend="cuda", max_iters=50, check_every=10)
    rt = quickstart.run(cfg, device="cuda", backend="torch", max_iters=50, check_every=10)
    assert torch.equal(rc.T, rt.T) and torch.equal(rc.T, rc.T_explicit)
    assert rc.solve.iters == rt.solve.iters and rc.solve.err == rt.solve.err
    assert torch.equal(rc.solve.output(rc.step), rt.solve.output(rt.step))


def test_measure_times_on_the_card(card):
    x = torch.ones(1 << 20, device=card)
    m = teff.measure(lambda: x.mul_(1.0), iters=5, warmup=1)
    assert m.median_s > 0 and len(m.samples_s) == 5
    assert teff.measure_device_bandwidth(1 << 24, iters=3) > 0
