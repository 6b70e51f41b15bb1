"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one. This file
imports neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: each stencil kernel must equal its plain version bitwise (the
build passes them --fmad=false, so every multiply and add rounds on its own
as PyTorch's operators do, and a division by a scalar is emitted as
PyTorch's CUDA product with the scalar's f32 reciprocal). That includes
the coupled solvers' kernels: staggered fields and boundary conditions,
and bf16 and f16 storage (f32 compute, rounded on store), where the hand
kernel computes at the storage dtype as its plain version does. Max reductions are bitwise too; sums fold in
another order and are held to rtol 1e-5. (A ``pow`` with an exponent other
than 2, 3 or 0.5 compiles to ``powf``, documented within 4 ulp; no kernel
here uses one.) The LM kernels: conv1d rtol 1e-5 / atol 1e-6 (its taps sum
in the plain version's order; SiLU's exponential differs by a few ulp),
attention rtol 1e-5 / atol 1e-5 (3xTF32 products on the tensor cores, about
2^-21 relative each, and an online softmax over key tiles against one
softmax per row), SSD rtol 1e-4 / atol 1e-4 (3xTF32 products summed in
another order, and the state carries rounding across chunks).
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import Diffusion3DConfig
from repro_torch.core import fd2d, fd3d, init_parallel_stencil, iterate, teff
from repro_torch.examples import gross_pitaevskii as gp, porosity_waves as pw, quickstart
from repro_torch.kernels import attention, conv1d, diffusion3d, ops, ref, ssd, stencil
from repro_torch.launch import serve as lm_serve
from repro_torch.models import RunConfig

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
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, alias=False)
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


@pytest.mark.parametrize("shape", [(33, 20, 130), (9, 10, 33), (70, 20, 40)])
def test_fig1_variants_equal_torch_backend(card, shape, rng):
    """The Fig. 1 step and its reduction variants at tile edges and at a
    march that neither the chunk nor the planes per step divide."""
    ps = init_parallel_stencil()
    pp = init_parallel_stencil(backend="torch", device="cuda")
    f = {n: _rand(rng, shape, card) for n in ("T2", "T", "Ci")}
    sc = dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0)
    for reds in (None, {"err": "max_abs_diff(T2, T)"}, CASES["fig1"][6]):
        k = quickstart.make_step(ps).with_reductions(reds)
        p = quickstart.make_step(pp).with_reductions(reds)
        _assert_same(k(**f, **sc), p(**f, **sc), k)


def _assert_same(got, want, kern):
    (got, got_reds), (want, want_reds) = (got, want) if kern.reductions else \
        ((got, {}), (want, {}))
    got = {kern.outputs[0]: got} if len(kern.outputs) == 1 else got
    want = {kern.outputs[0]: want} if len(kern.outputs) == 1 else want
    for o in kern.outputs:
        assert torch.equal(got[o], want[o]), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert float(got_reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(got_reds[n]), float(want_reds[n]), rtol=1e-5)


COUPLED_BCS = ["none", "neumann", "dirichlet", "periodic"]


@pytest.mark.parametrize("bc", COUPLED_BCS)
# tile edges, a 2-D tile (256 wide) and a march of 1001 rows that neither the
# chunk nor the planes per step divide
@pytest.mark.parametrize("shape", [(33, 20), (9, 12), (37, 300), (1001, 40)])
def test_porosity_kernels_equal_torch_backend(card, bc, shape, rng):
    """Fused (with and without its residual epilogue) and flux-split:
    staggered `all` writes and every bc kind in the generated kernel."""
    grid = pw.Grid(shape, (10.0, 10.0))
    phi = torch.tensor((rng.rand(*shape) * 0.01 + 0.005).astype(np.float32), device=card)
    Pe = torch.tensor(((rng.rand(*shape) - 0.5) * 0.01).astype(np.float32), device=card)
    f = dict(phi2=phi.flip(0).contiguous(), Pe2=Pe.flip(1).contiguous(), phi=phi, Pe=Pe)
    for split in (False, True):
        cfgs = [pw.PorosityConfig(n=shape[0], device="cuda", backend=b, bc=bc,
                                  flux_split=split) for b in ("cuda", "torch")]
        (k, *rest), (p, *prest) = (pw.make_step(grid, c).kernels for c in cfgs)
        if split:
            q = dict(qx=torch.rand(shape[0] - 1, shape[1], device=card),
                     qy=torch.rand(shape[0], shape[1] - 1, device=card))
            before = stencil.launches[k.label]
            _assert_same(k(**q, phi=phi, Pe=Pe), p(**q, phi=phi, Pe=Pe), k)
            assert stencil.launches[k.label] == before + 1
            k, p = rest[0], prest[0]
            f = dict(f, **q)
        _assert_same(k(**f, dtau=1e-3), p(**f, dtau=1e-3), k)
        if not split and bc != "periodic":
            err = {"err": "max_abs_diff(Pe2, Pe)"}
            kr, pr = k.with_reductions(err), p.with_reductions(err)
            _assert_same(kr(**f, dtau=1e-3), pr(**f, dtau=1e-3), kr)


@pytest.mark.parametrize("bc", COUPLED_BCS)
# tile edges, and a march of 70 planes that neither the chunk nor the planes
# per step divide
@pytest.mark.parametrize("shape", [(13, 17, 130), (7, 8, 9), (11, 19, 41), (70, 20, 40)])
def test_gp_kernels_equal_torch_backend(card, bc, shape, rng):
    """The fused radius-2 update (with and without its mass epilogues) and
    the two-launch scheme."""
    grid = gp.Grid(shape, (8.0, 8.0, 8.0))
    re, im, V = (torch.tensor(rng.rand(*shape).astype(np.float32), device=card)
                 for _ in range(3))
    sc = dict(g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0)
    f = dict(re2=im.clone(), im2=re.clone(), re=re, im=im, V=V)
    for fused in (True, False):
        ks, ps_ = (gp.make_step(grid, gp.GPConfig(n=shape[0], device="cuda", backend=b,
                                                  bc=bc, fused=fused)).kernels
                   for b in ("cuda", "torch"))
        for k, p in zip(ks, ps_):
            args = {n: f[n] for n in inspect.signature(k.fn).parameters if n in f}
            _assert_same(k(**args, **sc), p(**args, **sc), k)
            if fused and bc != "periodic":
                mass = {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}
                kr, pr = k.with_reductions(mass), p.with_reductions(mass)
                _assert_same(kr(**args, **sc), pr(**args, **sc), kr)


@pytest.mark.parametrize("shape", [(33, 20, 130), (13, 17, 130), (9, 10, 33)])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 9])
def test_diffusion3d_nsteps_equals_k_launches(card, shape, k, rng):
    """k steps in one launch (above MAX_STEPS, in launches of at most
    MAX_STEPS: ``diffusion3d.chunks``) equal k rotated single-step launches
    bitwise (T2 and T agree on the ring), in place and not; the plain
    version's k-step rule (T2 apart on the ring) too."""
    T, Ci = _rand(rng, shape, card), _rand(rng, shape, card)
    args = (1.0, 1e-4, 32.0, 19.0, 129.0)
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = diffusion3d.diffusion3d_step(a, b, Ci, *args, alias=False)
        a, b = b, a
    before = diffusion3d.launches
    got = diffusion3d.diffusion3d_step(T.clone(), T, Ci, *args, nsteps=k, alias=False)
    assert diffusion3d.launches == before + len(diffusion3d.chunks(k)) and torch.equal(got, b)
    T2 = T.clone()
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=True)
    torch.cuda.synchronize()
    assert got.data_ptr() == T2.data_ptr() and torch.equal(got, b)
    T2 = _rand(rng, shape, card)
    assert torch.equal(diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=False),
                       ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k))
    with pytest.raises(ValueError, match="storage"):
        diffusion3d.diffusion3d_step(T, T, Ci, *args, nsteps=k, alias=True)


def _sequential_launches(kern, f, sc, k):
    """k single-step launches of ``kern`` with the double-buffer rotation."""
    cur = dict(f)
    for _ in range(k):
        res = kern(**cur, **sc)
        res = res[0] if kern.reductions else res
        outs = {kern.outputs[0]: res} if len(kern.outputs) == 1 else res
        for o, t in kern.rotations.items():
            cur[o], cur[t] = cur[t], outs[o]
    return {o: cur[t] for o, t in kern.rotations.items()}


def _k_step_kernels(card):
    """``name: (kernel, fields for a base shape, scalars)`` of the k-step
    cases: FIG1 with and without its reductions, porosity's and GP's fused
    kernels for every in-launch bc, a staggered rotation."""
    def porosity(bc, reds=None):
        cfg = pw.PorosityConfig(n=64, device="cuda", bc=bc)
        k = pw.make_step(pw.make_grid(cfg), cfg).kernels[0]
        return k.with_reductions(reds), ("phi", "Pe"), {"dtau": 1e-3}

    def gp_(bc, reds=None):
        cfg = gp.GPConfig(n=16, device="cuda", bc=bc)
        k = gp.make_step(gp.make_grid(cfg), cfg).kernels[0]
        return k.with_reductions(reds), ("re", "im", "V"), dict(g=0.5, dt=1e-3, _dx2=3.0,
                                                                 _dy2=2.0, _dz2=5.0)

    ps2 = init_parallel_stencil(ndims=2)

    @ps2.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})
    def stag(T2, q2, T, q, dt):
        return {"T2": fd2d.inn(T) + dt * fd2d.d_xi(q), "q2": 0.7 * q + 0.3 * fd2d.av_xa(T)}

    fig = quickstart.make_step(init_parallel_stencil())
    out = {"fig1": (fig, ("T", "Ci"), dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0)),
           "fig1+4red": (fig.with_reductions(CASES["fig1"][6]), ("T", "Ci"),
                         dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0)),
           "staggered": (stag, ("T", "q"), {"dt": 1e-3})}
    for bc in ("none", "neumann", "dirichlet"):
        out[f"porosity[{bc}]"] = porosity(bc)
        out[f"gp[{bc}]"] = gp_(bc)
    out["porosity[neumann]+err"] = porosity("neumann", {"err": "max_abs_diff(Pe2, Pe)"})
    out["gp[none]+mass"] = gp_("none", {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"})
    return out


K_STEP_SHAPES = {"fig1": (33, 20, 130), "gp": (13, 17, 130), "porosity": (37, 300),
                 "staggered": (33, 20)}


@pytest.mark.parametrize("name", ["fig1", "fig1+4red", "staggered"]
                         + [f"{s}[{bc}]" for s in ("porosity", "gp")
                            for bc in ("none", "neumann", "dirichlet")]
                         + ["porosity[neumann]+err", "gp[none]+mass"])
@pytest.mark.parametrize("k", [2, 3])
def test_generated_k_step_kernel_equals_k_launches(card, name, k, rng):
    """One launch of the generated k-step kernel equals k single-step
    launches of the same program bitwise, outputs starting as copies of
    their targets; its reductions are the last step's."""
    kern, names, sc = _k_step_kernels(card)[name]
    base = K_STEP_SHAPES[name.split("[")[0].split("+")[0]]
    f = {}
    for n in names:
        shape = (base[0] - 1, base[1]) if n == "q" else base
        f[n] = _rand(rng, shape, card) * (0.01 if name.startswith("porosity") else 1.0)
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    want = _sequential_launches(kern, f, sc, k)
    label = f"{kern.label}/k{k}"
    before = stencil.launches[label]
    got = kern.run_steps(k, **f, **sc)
    torch.cuda.synchronize()
    assert stencil.launches[label] == before + 1
    got, reds = got if kern.reductions else (got, {})
    got = {kern.outputs[0]: got} if len(kern.outputs) == 1 else got
    for o in kern.outputs:
        assert torch.equal(got[o], want[o]), o
    if kern.reductions:
        cur = dict(f)
        plain = init_parallel_stencil(backend="torch", device="cuda", ndims=kern.ps.ndims)
        twin = plain.parallel(outputs=kern.outputs, rotations=kern.rotations,
                              reductions=kern.reductions, bc=kern.bc)(kern.fn)
        _, want_reds = twin.run_steps(k, **cur, **sc)
        for n, r in kern.reductions.items():
            if r.combine == "max":
                assert float(reds[n]) == float(want_reds[n]), n
            else:
                np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


def test_periodic_run_steps_makes_k_launches(card, rng):
    cfg = pw.PorosityConfig(n=33, device="cuda", bc="periodic")
    kern = pw.make_step(pw.make_grid(cfg), cfg).kernels[0]
    phi = _rand(rng, (33, 33), card) * 0.01
    Pe = _rand(rng, (33, 33), card) * 0.01
    f = dict(phi2=phi.clone(), Pe2=Pe.clone(), phi=phi, Pe=Pe)
    want = _sequential_launches(kern, f, {"dtau": 1e-3}, 3)
    before = stencil.launches[kern.label]
    got = kern.run_steps(3, **f, dtau=1e-3)
    assert stencil.launches[kern.label] == before + 3
    assert all(torch.equal(got[o], want[o]) for o in kern.outputs)


def test_division_by_a_host_scalar_on_the_card(card, rng):
    """What the generated kernel emits for ``tensor / scalar``: PyTorch on
    the card multiplies by the scalar's reciprocal, taken in double and
    rounded once to f32."""
    x = torch.tensor(rng.rand(1 << 16).astype(np.float32) + 0.5, device=card)
    for s in (0.01, 10.0 / 23.0, 3.0, 10.0 / 8191.0):
        inv = np.float32(1.0 / s)
        got, want = (x / s).cpu().numpy(), x.cpu().numpy() * inv
        assert want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"x / {s}")

    @init_parallel_stencil(ndims=2).parallel(outputs=("T2",))
    def divisions(T2, T, h):
        return {"T2": 2.0 / fd2d.inn(T) + fd2d.inn(T) / h + fd2d.inn(T) / (10.0 / 23.0)
                + fd2d.inn(T) / (1.5 + fd2d.d2_xi(T))}

    plain = init_parallel_stencil(backend="torch", device="cuda", ndims=2).parallel(
        outputs=("T2",))(divisions.fn)
    f = {n: _rand(rng, (33, 130), card) for n in ("T2", "T")}
    for h in (10.0 / 23.0, 3.0, 10.0 / 8191.0):
        assert torch.equal(divisions(**f, h=h), plain(**f, h=h)), h


def test_coupled_solvers_backends_agree_on_the_card(card):
    for kw in (dict(n=64, nt=20), dict(n=64, nt=20, flux_split=True),
               dict(n=64, nt=200, tol=1e-5, bc="dirichlet")):
        rc, rt = (pw.solve(pw.PorosityConfig(device="cuda", backend=b, **kw))
                  for b in ("cuda", "torch"))
        assert torch.equal(rc["phi"], rt["phi"]) and torch.equal(rc["Pe"], rt["Pe"]), kw
        assert rc["iters"] == rt["iters"] and rc["residual"] == rt["residual"], kw
    for kw in (dict(n=24, nt=10, bc="neumann"), dict(n=24, nt=40, tol=1e-3)):
        rc, rt = (gp.solve(gp.GPConfig(device="cuda", backend=b, **kw))
                  for b in ("cuda", "torch"))
        assert torch.equal(rc["re"], rt["re"]) and torch.equal(rc["im"], rt["im"]), kw
        assert rc["iters"] == rt["iters"], kw


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


# -- bf16 and f16 storage (f32 compute) ------------------------------------
LOW = {"bf16": torch.bfloat16, "f16": torch.float16}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tag", list(LOW))
def test_mixed_generated_kernel_equals_torch_backend(card, case, tag, rng):
    """bf16 and f16 fields: widened on load, computed in f32, rounded on
    store; each output bitwise, reductions of the stored values (max
    bitwise, sums rtol 1e-5)."""
    fn, outs, nd, names, shape, sc, reds = CASES[case]
    dt = LOW[tag]
    f = {n: _rand(rng, shape, card).to(dt) for n in names}
    k = init_parallel_stencil(ndims=nd, dtype=dt).parallel(outputs=outs, reductions=reds)(fn)
    p = init_parallel_stencil(backend="torch", device="cuda", ndims=nd, dtype=dt) \
        .parallel(outputs=outs, reductions=reds)(fn)
    before = stencil.launches[f"{k.label}:{tag}"]
    got, want = k(**f, **sc), p(**f, **sc)
    assert stencil.launches[f"{k.label}:{tag}"] == before + 1
    assert all(t.dtype == dt for t in ((got[0],) if len(outs) == 1 else got[0].values()))
    _assert_same(got, want, k)
    call = k.compiled(**f, **sc)
    with pytest.raises(TypeError, match="takes"):
        call.run({n: t.float() for n, t in f.items()}, sc)


# each bc at one storage dtype (chip_smoke.py holds every variant at both)
@pytest.mark.parametrize("tag,bc", [("bf16", "none"), ("f16", "neumann"), ("bf16", "dirichlet"),
                                    ("f16", "periodic")])
def test_mixed_coupled_kernels_equal_torch_backend(card, bc, tag, rng):
    """Porosity's fused and flux-split kernels and GP's fused and two-launch
    kernels, every bc, at bf16 and f16 storage."""
    dt = LOW[tag]
    shape = (37, 300)
    grid = pw.Grid(shape, (10.0, 10.0))
    phi = torch.tensor((rng.rand(*shape) * 0.01 + 0.005).astype(np.float32), device=card)
    Pe = torch.tensor(((rng.rand(*shape) - 0.5) * 0.01).astype(np.float32), device=card)
    f = {n: t.to(dt) for n, t in dict(phi2=phi.flip(0).contiguous(), Pe2=Pe.flip(1).contiguous(),
                                      phi=phi, Pe=Pe).items()}
    for split in (False, True):
        cfgs = [pw.PorosityConfig(n=shape[0], device="cuda", backend=b, bc=bc,
                                  dtype=str(dt).removeprefix("torch."), flux_split=split)
                for b in ("cuda", "torch")]
        (k, *rest), (p, *prest) = (pw.make_step(grid, c).kernels for c in cfgs)
        if split:
            q = dict(qx=torch.rand(shape[0] - 1, shape[1], device=card).to(dt),
                     qy=torch.rand(shape[0], shape[1] - 1, device=card).to(dt))
            _assert_same(k(**q, phi=f["phi"], Pe=f["Pe"]), p(**q, phi=f["phi"], Pe=f["Pe"]), k)
            k, p = rest[0], prest[0]
            f = dict(f, **q)
        _assert_same(k(**f, dtau=1e-3), p(**f, dtau=1e-3), k)
    gshape = (13, 17, 130)
    ggrid = gp.Grid(gshape, (8.0, 8.0, 8.0))
    re, im, V = (torch.tensor(rng.rand(*gshape).astype(np.float32), device=card).to(dt)
                 for _ in range(3))
    sc = dict(g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0)
    gf = dict(re2=im.clone(), im2=re.clone(), re=re, im=im, V=V)
    for fused in (True, False):
        ks, ps_ = (gp.make_step(ggrid, gp.GPConfig(n=gshape[0], device="cuda", backend=b,
                                                   bc=bc, fused=fused)).kernels
                   for b in ("cuda", "torch"))
        for k, p in zip(ks, ps_):
            k, p = k.with_dtype(dt), p.with_dtype(dt)
            args = {n: gf[n] for n in inspect.signature(k.fn).parameters if n in gf}
            _assert_same(k(**args, **sc), p(**args, **sc), k)


# -- the pair layout at 2 bytes (kernels/codegen_pairs.py) -----------------------
def _pair_kernels(bc, dt):
    """Porosity's and GP's fused kernels (GP with its mass epilogue, which a
    periodic bc refuses) and their torch twins, at storage ``dt``."""
    reds = {"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"}
    out = []
    for b in ("cuda", "torch"):
        cfg = pw.PorosityConfig(n=64, device="cuda", backend=b, bc=bc,
                                dtype=str(dt).removeprefix("torch."))
        k = pw.make_step(pw.Grid((64, 300), (10.0, 10.0)), cfg).kernels[0]
        g = gp.make_step(gp.Grid((13, 17, 130), (8.0, 8.0, 8.0)),
                         gp.GPConfig(n=13, device="cuda", backend=b, bc=bc)).kernels[0]
        g = g.with_dtype(dt)
        out.append((k, g if bc == "periodic" else g.with_reductions(reds)))
    return out


def _pair_fields(rng, card, dt):
    por = {n: torch.tensor((rng.rand(64, 300) * 0.01 + 0.005).astype(np.float32), device=card)
           .to(dt) for n in ("phi2", "Pe2", "phi", "Pe")}
    gpf = {n: torch.tensor(rng.rand(13, 17, 130).astype(np.float32), device=card).to(dt)
           for n in ("re2", "im2", "re", "im", "V")}
    return por, gpf


@pytest.mark.parametrize("tag,bc", [("bf16", "neumann"), ("f16", "periodic"), ("bf16", "dirichlet")])
def test_pair_layout_equals_torch_backend_and_one_cell_layout(card, tag, bc, rng):
    """Porosity's and GP's fused kernels take the pair layout at even
    contiguous extents: bitwise to the torch backend (sums rtol 1e-5), and
    with NaN, inf and -inf in the fields to the one-cell layout launched
    with the same chunks, bit for bit (NaN payloads and sums too)."""
    from repro_torch.kernels import codegen

    dt = LOW[tag]
    (kp, kg), (pp, pg) = _pair_kernels(bc, dt)
    por, gpf = _pair_fields(rng, card, dt)
    for k, p, f, sc in ((kp, pp, por, dict(dtau=1e-3)),
                        (kg, pg, gpf, dict(g=0.5, dt=1e-3, _dx2=3.0, _dy2=2.0, _dz2=5.0))):
        _assert_same(k(**f, **sc), p(**f, **sc), k)
        call = k.compiled(**f, **sc)
        assert call.shape.vec > 1 and "/v" in next(iter(k.launch_info.values()))["layout"]
        for t in f.values():
            flat = t.view(-1)
            flat[7], flat[1000], flat[2001] = float("nan"), float("inf"), float("-inf")
        one = stencil.StencilCall(call.ir, k.label, k.bc, codegen.kernel_shape(call.program),
                                  dtype=dt)
        xc = call.derive(torch.cuda.get_device_properties(card).multi_processor_count).xc
        res = []
        for c in (call, one):
            c_, outs, parts, args = c.prepare(f, sc, torch.cuda.get_device_properties(
                card).multi_processor_count, xc)
            c_._library().launch(*args, stencil.stream_of(card))
            res.append(c.finish(outs, parts))
        for o in k.outputs:
            assert torch.equal(res[0][0][o].view(torch.int16), res[1][0][o].view(torch.int16)), o
        for n in res[0][1] or {}:
            assert torch.equal(res[0][1][n].reshape(1).view(torch.int32),
                               res[1][1][n].reshape(1).view(torch.int32)), n


@pytest.mark.parametrize("tag", list(LOW))
def test_pair_layout_refuses_odd_extents_and_offsets(card, tag, rng):
    """An odd contiguous extent, and fields at an odd offset of their
    storage, launch the one-cell layout, bitwise to the torch backend, and
    ``launch_info`` says so."""
    dt = LOW[tag]
    (kp, _), (pp, _) = _pair_kernels("neumann", dt)
    odd = {n: torch.tensor((rng.rand(33, 21) * 0.01 + 0.005).astype(np.float32), device=card)
           .to(dt) for n in ("phi2", "Pe2", "phi", "Pe")}
    _assert_same(kp(**odd, dtau=1e-3), pp(**odd, dtau=1e-3), kp)
    assert "/v" not in kp.launch_info[(33, 21)]["layout"]
    f, _ = _pair_fields(rng, card, dt)
    views = {}
    for n, t in f.items():
        views[n] = torch.empty(t.numel() + 1, dtype=dt, device=card)[1:].view(t.shape)
        views[n].copy_(t)
    _assert_same(kp(**views, dtau=1e-3), pp(**f, dtau=1e-3), kp)
    assert "/v" not in kp.launch_info[(64, 300)]["layout"]
    _assert_same(kp(**f, dtau=1e-3), pp(**f, dtau=1e-3), kp)
    assert "/v" in kp.launch_info[(64, 300)]["layout"]


@pytest.mark.parametrize("name", ["fig1+4red", "staggered", "porosity[neumann]+err",
                                  "porosity[dirichlet]", "gp[neumann]", "gp[none]+mass"])
@pytest.mark.parametrize("tag,k", [("bf16", 3), ("f16", 2)])
def test_mixed_k_step_kernel_equals_k_launches(card, name, k, tag, rng):
    """Each sweep rounds its outputs through storage before the next, so one
    launch equals k single bf16 or f16 launches bitwise."""
    kern, names, sc = _k_step_kernels(card)[name]
    kern = kern.with_dtype(LOW[tag])
    base = K_STEP_SHAPES[name.split("[")[0].split("+")[0]]
    f = {}
    for n in names:
        shape = (base[0] - 1, base[1]) if n == "q" else base
        f[n] = (_rand(rng, shape, card) * (0.01 if name.startswith("porosity") else 1.0)) \
            .to(LOW[tag])
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    want = _sequential_launches(kern, f, sc, k)
    label = f"{kern.label}:{tag}/k{k}"
    before = stencil.launches[label]
    got = kern.run_steps(k, **f, **sc)
    torch.cuda.synchronize()
    assert stencil.launches[label] == before + 1
    got = got[0] if kern.reductions else got
    got = {kern.outputs[0]: got} if len(kern.outputs) == 1 else got
    for o in kern.outputs:
        assert got[o].dtype == LOW[tag] and torch.equal(got[o], want[o]), o


@pytest.mark.parametrize("shape", [(33, 20, 130), (13, 17, 130)])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("tag", list(LOW))
def test_mixed_diffusion3d_equals_plain(card, shape, k, tag, rng):
    """The hand kernel at bf16 and f16 computes at the storage dtype, as its
    plain version: bitwise, in place and not, and k steps equal k launches."""
    dt = LOW[tag]
    T, Ci = _rand(rng, shape, card).to(dt), _rand(rng, shape, card).to(dt)
    # every product rounds, and the steps stay stable and inside f16's range
    # (steeper scalars overflow f16 within three steps, and NaN != NaN)
    args = (0.7, 1e-3, 8.3, 9.1, 10.7)
    want = ref.diffusion3d_steps(T.clone(), T, Ci, *args, nsteps=k)
    before = diffusion3d.launches
    got = diffusion3d.diffusion3d_step(T.clone(), T, Ci, *args, nsteps=k, alias=False)
    assert diffusion3d.launches == before + 1
    assert got.dtype == dt and torch.equal(got, want)
    T2 = T.clone()
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *args, nsteps=k, alias=True)
    torch.cuda.synchronize()
    assert got.data_ptr() == T2.data_ptr() and torch.equal(got, want)
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = diffusion3d.diffusion3d_step(a, b, Ci, *args, alias=False)
        a, b = b, a
    assert torch.equal(b, want)
    with pytest.raises(TypeError, match="takes"):
        diffusion3d.diffusion3d_step(T.float(), T, Ci, *args, nsteps=k)


@pytest.mark.parametrize("shape", [(33, 20, 130), (33, 20, 131), (512, 64, 130)])
@pytest.mark.parametrize("tag", list(LOW))
def test_mixed_diffusion3d_both_layouts(card, shape, tag, rng):
    """The 2-byte single step in its pair layout (nz even, fields on 4-byte
    words) and its one-cell layout (nz odd, or the same values two bytes off
    a word), each bitwise to the plain version, in place and not, and named
    in ``diffusion3d.last_layout``."""
    dt = LOW[tag]
    T, Ci, T2 = (_rand(rng, shape, card).to(dt) for _ in range(3))
    args = (0.7, 1e-3, 8.3, 9.1, 10.7)
    want = ref.diffusion3d_step(T2, T, Ci, *args)
    pairs = shape[2] % 2 == 0
    for alias in (False, True):
        got = diffusion3d.diffusion3d_step(T2.clone(), T, Ci, *args, alias=alias)
        assert diffusion3d.last_layout == ("pairs" if pairs else "cells")
        assert torch.equal(got, want)
        off = []
        for t in (T2, T, Ci):
            buf = torch.empty(t.numel() + 1, dtype=dt, device=card)
            off.append(buf[1:].view(shape).copy_(t))
        got = diffusion3d.diffusion3d_step(*off, *args, alias=alias)
        assert diffusion3d.last_layout == "cells" and torch.equal(got, want)
        assert (got.data_ptr() == off[0].data_ptr()) == alias


def test_mixed_solve_until_on_the_card(card):
    """FIG1 at bf16 through solve_until on both backends: the same steps,
    error and fields; porosity --dtype bfloat16 alike."""
    cfg = Diffusion3DConfig(nx=32, ny=24, nz=40, nt=20)
    _, f, sc = quickstart.initial_state(cfg, "cuda")
    res = []
    for backend in ("cuda", "torch"):
        ps = init_parallel_stencil(backend=backend, device="cuda", dtype=torch.bfloat16)
        kern = quickstart.make_step(ps).with_reductions({"err": "max_abs_diff(T2, T)"})
        res.append(iterate.solve_until(kern, f, sc, tol=1e-2, max_iters=200, check_every=10))
    assert res[0].iters == res[1].iters and res[0].err == res[1].err
    assert all(torch.equal(res[0].fields[n], res[1].fields[n]) for n in f)
    assert res[0].fields["T"].dtype == torch.bfloat16
    rc, rt = (pw.solve(pw.PorosityConfig(n=64, nt=100, tol=1e-6, device="cuda", backend=b,
                                         dtype="bfloat16")) for b in ("cuda", "torch"))
    assert torch.equal(rc["phi"], rt["phi"]) and torch.equal(rc["Pe"], rt["Pe"])
    assert rc["iters"] == rt["iters"] and rc["residual"] == rt["residual"]


def _randn(rng, shape, card, scale=1.0):
    return torch.tensor((rng.randn(*shape) * scale).astype(np.float32), device=card)


@pytest.mark.parametrize("B,L,C,K", [(2, 3, 40, 4), (2, 70, 300, 4), (1, 33, 17, 3),
                                     (1, 20, 5, 9)])
@pytest.mark.parametrize("silu", [False, True])
def test_conv1d_equals_plain(card, B, L, C, K, silu, rng):
    x, w, b = _randn(rng, (B, L, C), card), _randn(rng, (K, C), card), _randn(rng, (C,), card)
    before = conv1d.launches
    got = conv1d.conv1d_causal(x, w, b, silu=silu)
    torch.cuda.synchronize()
    assert conv1d.launches == before + 1
    torch.testing.assert_close(got, conv1d.plain(x, w, b, silu=silu), rtol=1e-5, atol=1e-6)
    if not silu:   # the taps sum in the plain version's order
        assert torch.equal(got, conv1d.plain(x, w, b))
    with pytest.raises(TypeError, match="float32"):
        conv1d.conv1d_causal(x.double(), w.double(), b.double())


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,with_h0", [
    (1, 32, 2, 4, 1, 8, 8, False),
    (2, 64, 4, 8, 2, 16, 16, True),
    (1, 80, 4, 8, 4, 8, 32, True),
    (2, 100, 8, 64, 1, 64, 64, False),
    (1, 1000, 4, 64, 2, 64, 64, True),     # L = 1000: pick_chunk halves to 8, the
                                           # kernels run 64 steps, the last chunk 40
    (1, 1023, 64, 64, 1, 64, 64, True),    # odd L at Zamba2's H, P, N: pick_chunk 1
    (1, 1000, 2, 64, 1, 64, 64, False),
    (2, 256, 4, 64, 2, 64, 16, False),     # chunk 16, G = 2
    (1, 256, 4, 64, 2, 64, 32, True),      # chunk 32, G = 2, h0
    (1, 40, 2, 6, 1, 10, 16, True),        # P, N not multiples of 4: 4-byte copies
    (1, 96, 2, 8, 1, 8, 96, True),         # chunk 96: 64-step chunks, the last short
    (1, 70, 2, 72, 1, 128, 64, True),      # two p tiles, two n tiles, N = 128
])
def test_ssd_equals_plain(card, B, L, H, P, G, N, chunk, with_h0, rng):
    x = _randn(rng, (B, L, H, P), card, 0.5)
    dt = torch.tensor((np.abs(rng.randn(B, L, H)) * 0.1 + 0.01).astype(np.float32),
                      device=card)
    A = torch.tensor((-np.abs(rng.rand(H)) - 0.1).astype(np.float32), device=card)
    Bm, Cm = _randn(rng, (B, L, G, N), card, 0.3), _randn(rng, (B, L, G, N), card, 0.3)
    D = _randn(rng, (H,), card)
    h0 = _randn(rng, (B, H, P, N), card, 0.2) if with_h0 else None
    before = ssd.launches
    y, h = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1      # one call, two device launches
    cs = ssd.pick_chunk(L, chunk)
    yw, hw = ref.ssd(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=cs)
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hw, rtol=1e-4, atol=1e-4)
    ys, hs = ref.ssd_scan(x, dt, A, Bm, Cm, D=D, h0=h0)
    torch.testing.assert_close(y, ys, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,Hq,Hkv,L,D", [(1, 4, 4, 64, 16), (2, 4, 2, 97, 32),
                                          (1, 2, 1, 130, 64), (1, 2, 2, 33, 128),
                                          # the tile edges (64 query rows, 32 keys),
                                          # GQA rep 2 and 4
                                          (1, 4, 2, 1, 64), (1, 8, 2, 63, 64),
                                          (2, 4, 2, 65, 48), (1, 8, 2, 1000, 80),
                                          (1, 2, 2, 1024, 16), (1, 4, 2, 1024, 128),
                                          # 4096 keys: O sums over 128 key tiles
                                          (1, 2, 1, 4096, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37), (False, None),
                                           (False, 9), (True, 0)])
def test_attention_equals_plain(card, B, Hq, Hkv, L, D, causal, window, rng):
    q, k, v = (_randn(rng, (B, h, L, D), card) for h in (Hq, Hkv, Hkv))
    before = attention.launches
    got = attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if window == 0:
        assert torch.all(got == 0)


def test_lm_serve_backends_agree_on_the_card(card):
    scfg = lm_serve.ServeConfig(batch=2, prompt_len=40, gen_len=6)
    counts = (conv1d.launches, ssd.launches, attention.launches)
    got, info = lm_serve.serve("zamba2-1.2b", scfg, smoke=True, device="cuda",
                               log_fn=lambda *a: None)
    # the smoke config: 2 Mamba2 layers and one application of the shared block
    assert (conv1d.launches - counts[0], ssd.launches - counts[1],
            attention.launches - counts[2]) == (2, 2, 1)
    rc = RunConfig(param_dtype="float32", attn_impl="ref", ssd_impl="ref", conv_impl="ref")
    want, winfo = lm_serve.serve("zamba2-1.2b", scfg, rc=rc, smoke=True, device="cuda",
                                 log_fn=lambda *a: None)
    torch.testing.assert_close(info["prefill_logits"], winfo["prefill_logits"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, want)
    assert ops.conv1d_causal(torch.zeros(1, 2, 3, device=card), torch.ones(2, 3, device=card),
                             impl="cuda").abs().max() == 0


# the other LM families' prefill shapes (stablelm, qwen3's GQA rep 8, phi-3,
# the enc-dec's non-causal encoder; mamba2-130m's conv1d and SSD)
@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal", [(4, 32, 32, 1024, 80, True),
                                                 (4, 64, 8, 1024, 128, True),
                                                 (4, 32, 32, 1024, 96, True),
                                                 (4, 16, 16, 1024, 64, False)])
def test_attention_at_family_shapes(card, B, Hq, Hkv, L, D, causal, rng):
    q, k, v = (_randn(rng, (B, h, L, D), card) for h in (Hq, Hkv, Hkv))
    before = attention.launches
    got = attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    torch.testing.assert_close(got, ref.attention(q, k, v, causal=causal), rtol=1e-5, atol=1e-5)


def test_conv1d_and_ssd_at_mamba2_shapes(card, rng):
    B, L, H, P, N = 4, 1024, 24, 64, 128
    C = 2 * H * P + 2 * N                     # d_conv_in = 1792
    x, w, b = _randn(rng, (B, L, C), card), _randn(rng, (4, C), card, 0.5), \
        _randn(rng, (C,), card, 0.1)
    got = conv1d.conv1d_causal(x, w, b, silu=True)
    torch.testing.assert_close(got, conv1d.plain(x, w, b, silu=True), rtol=1e-5, atol=1e-6)
    xs = _randn(rng, (B, L, H, P), card, 0.5)
    dt = torch.tensor((np.abs(rng.randn(B, L, H)) * 0.05 + 0.001).astype(np.float32),
                      device=card)
    A = torch.tensor((-rng.rand(H) * 15 - 1).astype(np.float32), device=card)
    Bm, Cm = _randn(rng, (B, L, 1, N), card, 0.3), _randn(rng, (B, L, 1, N), card, 0.3)
    D = torch.ones(H, device=card)
    before = ssd.launches
    y, h = ssd.ssd_chunk_scan(xs, dt, A, Bm, Cm, D=D, chunk=64)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    yw, hw = ref.ssd(xs, dt, A, Bm, Cm, D=D, chunk=ssd.pick_chunk(L, 64))
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hw, rtol=1e-4, atol=1e-4)


# each family's smoke config: (kernel launches a request: conv1d, ssd, attention)
FAMILY_LAUNCHES = {"stablelm-3b": (0, 0, 2), "moonshot-v1-16b-a3b": (0, 0, 2),
                   "mamba2-130m": (2, 2, 0), "phi-3-vision-4.2b": (0, 0, 2),
                   "seamless-m4t-medium": (0, 0, 4)}


@pytest.mark.parametrize("arch", FAMILY_LAUNCHES)
def test_family_serve_backends_agree_on_the_card(card, arch):
    scfg = lm_serve.ServeConfig(batch=2, prompt_len=40, gen_len=6)
    counts = (conv1d.launches, ssd.launches, attention.launches)
    got, info = lm_serve.serve(arch, scfg, smoke=True, device="cuda", log_fn=lambda *a: None)
    assert (conv1d.launches - counts[0], ssd.launches - counts[1],
            attention.launches - counts[2]) == FAMILY_LAUNCHES[arch]
    rc = RunConfig(param_dtype="float32", attn_impl="ref", ssd_impl="ref", conv_impl="ref")
    want, winfo = lm_serve.serve(arch, scfg, rc=rc, smoke=True, device="cuda",
                                 log_fn=lambda *a: None)
    torch.testing.assert_close(info["prefill_logits"], winfo["prefill_logits"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# march_axis streaming and the finite/nan_count reductions
# ---------------------------------------------------------------------------
MARCH_CASES = [("fig1", a) for a in (0, 1, 2)] + [("fig1+4red", a) for a in (0, 1, 2)] \
    + [("staggered", 1)] + [(f"porosity[{bc}]", a) for bc in ("neumann", "dirichlet")
                            for a in (0, 1)] \
    + [(f"gp[{bc}]", a) for bc in ("none", "neumann") for a in (0, 1, 2)]


@pytest.mark.parametrize("name,axis", MARCH_CASES)
def test_marched_kernel_equals_torch_backend_and_k_launches(card, name, axis, rng):
    """A marched kernel is bitwise equal to its all-parallel twin (and so to
    the torch backend); its ``run_steps(2)`` is one launch, bitwise equal to
    two marched launches; ``launch_info`` names the axis and its queue."""
    kern, names, sc = _k_step_kernels(card)[name]
    km = kern.marched(axis)
    base = K_STEP_SHAPES[name.split("[")[0].split("+")[0]]
    base = tuple(max(b, 21) for b in base)        # every axis fills the plane queue
    f = {}
    for n in names:
        shape = (base[0] - 1, base[1]) if n == "q" else base
        f[n] = _rand(rng, shape, card) * (0.01 if name.startswith("porosity") else 1.0)
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    _assert_same(km(**f, **sc), kern(**f, **sc), km)
    info = km.launch_info[base]
    assert info["march_axis"] == axis and not info["march_fallback"] and info["queue_planes"] > 0
    want = _sequential_launches(km, f, sc, 2)
    label = f"{km.label}@m{axis}/k2"
    before = stencil.launches[label]
    got = km.run_steps(2, **f, **sc)
    torch.cuda.synchronize()
    assert stencil.launches[label] == before + 1
    got = got[0] if km.reductions else got
    got = {km.outputs[0]: got} if len(km.outputs) == 1 else got
    for o in km.outputs:
        assert torch.equal(got[o], want[o]), o


@pytest.mark.parametrize("tag", list(LOW))
@pytest.mark.parametrize("axis", [0, 2])
def test_mixed_marched_kernel_equals_torch_backend(card, tag, axis, rng):
    ps = init_parallel_stencil(dtype=LOW[tag])
    pp = init_parallel_stencil(backend="torch", device="cuda", dtype=LOW[tag])
    f = {n: _rand(rng, (33, 20, 130), card).to(LOW[tag]) for n in ("T2", "T", "Ci")}
    sc = dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0)
    reds = CASES["fig1"][6]
    k = quickstart.make_step(ps).with_reductions(reds).marched(axis)
    _assert_same(k(**f, **sc), quickstart.make_step(pp).with_reductions(reds)(**f, **sc), k)


def test_march_fallback_and_staggered_refusal_on_the_card(card, rng):
    """A march extent shorter than the queue launches the all-parallel
    kernel and says so; a field staggered along the march axis raises."""
    k = quickstart.make_step(init_parallel_stencil()).marched(0)
    f = {n: _rand(rng, (3, 20, 130), card) for n in ("T2", "T", "Ci")}
    sc = dict(lam=1.0, dt=1e-4, _dx=2.0, _dy=19.0, _dz=129.0)
    got = k(**f, **sc)
    info = k.launch_info[(3, 20, 130)]
    assert info["march_fallback"] and info["march_axis"] is None
    assert torch.equal(got, quickstart.make_step(init_parallel_stencil())(**f, **sc))
    stag, names, sc = _k_step_kernels(card)["staggered"]
    f = {"T2": _rand(rng, (33, 20), card), "T": _rand(rng, (33, 20), card),
         "q2": _rand(rng, (32, 20), card), "q": _rand(rng, (32, 20), card)}
    with pytest.raises(ValueError, match="staggered"):
        stag.marched(0)(**f, **sc)


def health(T2, T):
    return {"T2": fd3d.inn(T) * 2.0}


HEALTH = {"bad": "finite(T2)", "nbad": "nan_count(T2)", "nin": "nan_count(T)"}


@pytest.mark.parametrize("tag", ["f32", *LOW])
@pytest.mark.parametrize("axis", [None, 2])
def test_finite_and_nan_count_on_the_card(card, tag, axis, rng):
    """``finite`` and ``nan_count`` fold the stored output (an f16 value
    that rounds to inf on store counts) and the input: counts exact and
    equal to the torch backend's, single step and k = 2."""
    dt = LOW.get(tag, torch.float32)
    T = torch.tensor(rng.rand(33, 20, 130).astype(np.float32))
    T[torch.tensor(rng.rand(33, 20, 130) < 0.01)] = float("nan")
    T[5, 5, 5], T[1, 1, 1], T[7, 7, 7] = float("inf"), -float("inf"), 40000.0
    f = {"T2": T.to(dt).to(card), "T": T.to(dt).to(card)}
    kern = init_parallel_stencil(dtype=dt).parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=HEALTH, march_axis=axis)(health)
    plain = init_parallel_stencil(backend="torch", device="cuda", dtype=dt).parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=HEALTH)(health)
    for k in (1, 2):
        (got, reds), (want, want_reds) = kern.run_steps(k, **f), plain.run_steps(k, **f)
        assert bool(((got == want) | (got.isnan() & want.isnan())).all())
        assert {n: float(r) for n, r in reds.items()} == \
            {n: float(r) for n, r in want_reds.items()}
        assert float(reds["nin"]) == float((~torch.isfinite(f["T"])).sum())
        assert float(reds["bad"]) == 1.0
    assert bool(torch.isinf(plain(**f)[0][7, 7, 7])) == (dt == torch.float16)


def test_checkpointed_porosity_resumes_bitwise_on_the_card(card, tmp_path):
    """Porosity's fused kernel at 64^2 through the twin's checkpointed --tol
    solve: a run stopped at step 40 and resumed equals the uninterrupted
    run bitwise, and both equal the plain solve."""
    kw = dict(n=64, device="cuda", tol=1e-12, check_every=5, save_every=2)
    full = pw.solve(pw.PorosityConfig(nt=80, **kw))
    ck = str(tmp_path / "ck")
    part = pw.solve(pw.PorosityConfig(nt=40, checkpoint_dir=ck, **kw))
    assert part["iters"] == 40 and part["resumed_from"] is None
    resumed = pw.solve(pw.PorosityConfig(nt=80, checkpoint_dir=ck, **kw))
    assert resumed["resumed_from"] == 40 and resumed["iters"] == full["iters"] == 80
    assert resumed["residual"] == full["residual"]
    for n in ("phi", "Pe"):
        assert resumed[n].is_cuda and torch.equal(resumed[n], full[n])


def test_bf16_checkpoint_of_card_tensors_restores_bitwise(card, tmp_path):
    """A bf16 card tensor goes through the pinned snapshot, is written as
    2-byte records under '<V2', and comes back on the card bitwise."""
    from repro_torch.checkpoint import CheckpointManager

    gen = torch.Generator(device=card).manual_seed(7)
    tree = {"fields": {"T": torch.randn(33, 130, generator=gen, device=card).bfloat16(),
                       "h": torch.randn(5, generator=gen, device=card).half()},
            "err": torch.tensor(0.5)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree, blocking=False)
    mgr.wait()
    with open(tmp_path / "step_000000004" / "t_000001.npy", "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    like = {"fields": {n: torch.zeros_like(t) for n, t in tree["fields"].items()},
            "err": torch.zeros(())}
    got, extra = mgr.restore(like)
    assert extra["step"] == 4 and float(got["err"]) == 0.5
    for n, t in tree["fields"].items():
        assert got["fields"][n].is_cuda and got["fields"][n].dtype == t.dtype
        assert torch.equal(got["fields"][n].view(torch.int16), t.view(torch.int16))


# ---------------------------------------------------------------------------
# the launch autotuner and parallel(tile=) on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotune_diffusion3d_on_the_card(card, dtype, tmp_path):
    """The real timer at 64^3: every candidate timed is held bitwise to k
    single steps of the table layout; the memory and the disk hit return
    the winner and launch nothing; the winner's tile serves
    ``parallel(tile=)``, bitwise to the table layout."""
    from repro_torch import telemetry
    from repro_torch.kernels import autotune, codegen

    autotune._CACHE.clear()
    cache = str(tmp_path / "tune.json")
    kw = dict(nsteps_candidates=(1, 2), march_candidates=(None, 0), iters=3,
              cache_path=cache, max_candidates=2, device="cuda")
    col = telemetry.configure(None)
    try:
        report = []
        win = autotune.autotune_diffusion3d((64, 64, 64), dtype, report=report, **kw)
        torch.cuda.synchronize()
        before = sum(stencil.launches.values())
        assert autotune.autotune_diffusion3d((64, 64, 64), dtype, **kw) == win
        autotune._CACHE.clear()
        assert autotune.autotune_diffusion3d((64, 64, 64), dtype, **kw) == win
        assert sum(stencil.launches.values()) == before
        decisions = [r["attrs"]["cache"] for r in col.records
                     if r["kind"] == "event" and r["name"] == "autotune.decision"]
    finally:
        telemetry.reset()
        autotune._CACHE.clear()
    assert decisions == ["miss", "memory_hit", "disk_hit"]
    assert len(report) == win.candidates_tried >= 4
    assert all(r["bitwise"] and r["measured_s"] > 0 for r in report)
    assert isinstance(win.tile, codegen.KernelShape) and win.per_step_s > 0
    dt = getattr(torch, dtype)
    ps = init_parallel_stencil(dtype=dt)
    kern = autotune.diffusion3d_kernel(ps, win.tile).marched(win.march_axis)
    table = autotune.diffusion3d_kernel(ps)
    g = torch.Generator(device="cuda").manual_seed(1)
    T = torch.rand((64, 64, 64), generator=g, device="cuda").to(dt)
    f = {"T2": T.clone(), "T": T, "Ci": (torch.rand((64, 64, 64), generator=g,
                                                    device="cuda") + 0.5).to(dt)}
    sc = dict(lam=1.0, dt=1e-5, _dx=63.0, _dy=63.0, _dz=63.0)
    assert torch.equal(kern.run_steps(win.nsteps, **f, **sc),
                       _sequential_launches(table, f, sc, win.nsteps)["T2"])


def test_parallel_tile_launches_the_layout_asked_for(card, rng):
    from repro_torch.kernels import autotune, codegen

    ps = init_parallel_stencil()
    f = {n: _rand(rng, (33, 20, 130), card) for n in ("T2", "T", "Ci")}
    f["T2"] = f["T"].clone()
    sc = dict(lam=1.0, dt=1e-4, _dx=32.0, _dy=19.0, _dz=129.0)
    table = autotune.diffusion3d_kernel(ps)
    for tile, k, march in ((codegen.KernelShape((32, 8), 1, 8), 1, None),
                           (codegen.KernelShape((32, 8), 4, 6), 1, 0),
                           (codegen.KernelShape((32, 16), 1, 2, block=256), 2, None),
                           (codegen.KernelShape((32, 16), 1, 4), 2, 1)):
        kern = autotune.diffusion3d_kernel(ps, tile).marched(march)
        counted = (kern.compiled(nsteps=k, **f, **sc).label, codegen.layout_name(tile))
        before = stencil.layout_launches[counted]
        got = kern.run_steps(k, **f, **sc)
        torch.cuda.synchronize()
        assert kern.launch_info[(33, 20, 130)]["layout"] == codegen.layout_name(tile)
        assert stencil.layout_launches[counted] == before + 1
        assert torch.equal(got, _sequential_launches(table, f, sc, k)["T2"])
    with pytest.raises(ValueError, match="cannot serve"):
        autotune.diffusion3d_kernel(ps, codegen.KernelShape((32, 16), 1, 2, block=256))(
            **f, **sc)


# --------------------------------------------------------------------------
# training: the backward kernels, their autograd Functions, a smoke train
# --------------------------------------------------------------------------
# Tolerances of the backward kernels against autograd.grad of the plain
# version (rtol, atol x the case's largest gradient), chip_smoke.TRAIN_TOL's.
TRAIN_TOL = {"conv1d": (1e-4, 1e-5), "ssd": (1e-3, 1e-4), "attention": (1e-3, 1e-4)}


def _close_grads(got, want, tol):
    scale = max(float(w.abs().max()) for w in want if w is not None and w.numel())
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=tol[0], atol=tol[1] * scale)


@pytest.mark.parametrize("B,L,C,K,silu", [(2, 70, 300, 3, True), (4, 1024, 4224, 4, False)])
def test_conv1d_bwd_equals_plain(card, B, L, C, K, silu):
    gen = torch.Generator().manual_seed(0)
    x, w, b, g = (torch.randn(s, generator=gen).to(card)
                  for s in ((B, L, C), (K, C), (C,), (B, L, C)))
    before = conv1d.launches_bwd
    got = conv1d.conv1d_causal_bwd(g, x, w, b, silu)
    assert conv1d.launches_bwd == before + 1
    _close_grads(got, ref.conv1d_bwd(g, x, w, b, silu), TRAIN_TOL["conv1d"])
    assert all(torch.equal(a, c) for a, c in zip(got, conv1d.conv1d_causal_bwd(g, x, w, b, silu)))


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,h0,dhf", [(1, 100, 4, 6, 2, 10, 16, True, True),
                                                      (2, 130, 4, 64, 1, 128, 64, False, False)])
def test_ssd_bwd_equals_plain(card, B, L, H, P, G, N, chunk, h0, dhf):
    gen = torch.Generator().manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=gen) * scale).to(card)

    x, Bm, Cm = r(B, L, H, P, scale=0.5), r(B, L, G, N, scale=0.3), r(B, L, G, N, scale=0.3)
    dt = (torch.rand((B, L, H), generator=gen) * 0.09 + 0.01).to(card)
    A, D = -(torch.rand(H, generator=gen) * 8 + 1).to(card), r(H)
    h0t = r(B, H, P, N, scale=0.2) if h0 else None
    dy, dhft = r(B, L, H, P), (r(B, H, P, N) if dhf else None)
    _, hf, states = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0t, chunk=chunk,
                                       return_states=True)
    got = ssd.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, D=D, h0=h0t, dh_final=dhft,
                                 states=states, h_final=hf, chunk=chunk)
    want = ref.ssd_bwd(x, dt, A, Bm, Cm, dy, D=D, h0=h0t, dh_final=dhft,
                       chunk=ssd.pick_chunk(L, chunk))
    _close_grads([got[k] for k in want], list(want.values()), TRAIN_TOL["ssd"])


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [(1, 8, 2, 63, 128, True, 37),
                                                        (2, 4, 4, 65, 16, False, None),
                                                        (1, 2, 2, 65, 64, True, 0)])
def test_attention_bwd_and_lse_equal_plain(card, B, Hq, Hkv, L, D, causal, window):
    gen = torch.Generator().manual_seed(2)
    q, g = (torch.randn((B, Hq, L, D), generator=gen).to(card) for _ in range(2))
    k, v = (torch.randn((B, Hkv, L, D), generator=gen).to(card) for _ in range(2))
    out, lse = attention.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    plain_lse = ref.attention_lse(q, k, causal=causal, window=window)
    fin = torch.isfinite(plain_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    torch.testing.assert_close(lse[fin], plain_lse[fin], rtol=1e-5, atol=1e-5)
    got = attention.flash_attention_bwd(q, k, v, out, g, lse, causal=causal, window=window)
    _close_grads(got, ref.attention_bwd(q, k, v, g, causal=causal, window=window),
                 TRAIN_TOL["attention"])


def test_ops_route_gradients_through_the_backward_kernels(card):
    """A grad-enabled call of ops on CUDA tensors runs the Functions: one
    backward launch each, the gradients the plain version's."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 40, 16), generator=gen).to(card).requires_grad_(True)
    before = (attention.launches_bwd, conv1d.launches_bwd)
    out = ops.attention(q, q, q, causal=True)
    x = torch.randn((1, 40, 8), generator=gen).to(card).requires_grad_(True)
    y = ops.conv1d_causal(x, torch.randn((4, 8), generator=gen).to(card), silu=True)
    (out.sum() + y.sum()).backward()
    assert (attention.launches_bwd, conv1d.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(q.grad).all()) and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-130m", "stablelm-3b",
                                  "seamless-m4t-medium"])
def test_smoke_train_on_the_card_matches_the_plain_run(card, arch):
    """Four steps of each arch's smoke config on the kernels and on the
    plain versions: the losses within 1e-3 (chip_smoke.TRAIN_LATER_RTOL)."""
    from repro_torch.launch import train as lm_train

    loop = lm_train.TrainLoopConfig(steps=4, seq_len=64, global_batch=2, log_every=100)
    quiet = dict(smoke=True, device=card, log_fn=lambda *a: None)
    _, _, hist = lm_train.train(arch, loop, **quiet)
    rc = dataclasses.replace(lm_train.default_run_config(loop), attn_impl="ref",
                             ssd_impl="ref", conv_impl="ref")
    _, _, plain = lm_train.train(arch, loop, rc=rc, **quiet)
    np.testing.assert_allclose(hist, plain, rtol=1e-3)


# --------------------------------------------------------------------------
# bf16 storage in the LM kernels: each bf16 instance is its f32 instance on
# the upcast inputs, rounded, bit for bit (forward and backward); float16 and
# mixed storage dtypes are refused, and nothing falls back.
# --------------------------------------------------------------------------
def _bf16(gen, card, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(card).to(torch.bfloat16)


def _rounded(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("B,L,C,K,silu", [(2, 70, 264, 4, True),    # vec 4: 8-byte copies
                                          (2, 37, 301, 3, False),   # C % 4 != 0: vec 1
                                          (4, 1024, 4224, 4, True)])
def test_conv1d_bf16_is_f32_rounded(card, B, L, C, K, silu):
    gen = torch.Generator().manual_seed(4)
    x, g = _bf16(gen, card, B, L, C), _bf16(gen, card, B, L, C)
    w, b = _bf16(gen, card, K, C, scale=K ** -0.5), _bf16(gen, card, C, scale=0.1)
    up = [t.float() for t in (x, w, b, g)]
    before = (conv1d.launches, conv1d.launches_bwd)
    out = conv1d.conv1d_causal(x, w, b, silu=silu)
    grads = conv1d.conv1d_causal_bwd(g, x, w, b, silu)
    assert (conv1d.launches, conv1d.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert conv1d.last_layout[0] == (4 if C % 4 == 0 else 1)
    _rounded(out, conv1d.conv1d_causal(*up[:3], silu=silu))
    assert torch.equal(out, conv1d.plain(x, w, b, silu=silu))
    for a, f in zip(grads, conv1d.conv1d_causal_bwd(up[3], *up[:3], silu)):
        _rounded(a, f)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,h0", [(1, 100, 4, 6, 2, 10, 16, True),
                                                  (4, 1024, 64, 64, 1, 64, 64, False)])
def test_ssd_bf16_is_f32_rounded(card, B, L, H, P, G, N, chunk, h0):
    gen = torch.Generator().manual_seed(5)
    x, dy = _bf16(gen, card, B, L, H, P, scale=0.5), _bf16(gen, card, B, L, H, P)
    Bm, Cm = _bf16(gen, card, B, L, G, N, scale=0.3), _bf16(gen, card, B, L, G, N, scale=0.3)
    dt = (torch.rand((B, L, H), generator=gen) * 0.09 + 0.01).to(card)
    A, D = -(torch.rand(H, generator=gen) * 8 + 1).to(card), torch.ones(H, device=card)
    h0t = (torch.randn((B, H, P, N), generator=gen) * 0.2).to(card) if h0 else None
    y, hf, st = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0t, chunk=chunk,
                                   return_states=True)
    y32, hf32, st32 = ssd.ssd_chunk_scan(x.float(), dt, A, Bm.float(), Cm.float(), D=D, h0=h0t,
                                         chunk=chunk, return_states=True)
    _rounded(y, y32)
    assert torch.equal(hf, hf32) and torch.equal(st, st32)
    kw = dict(D=D, h0=h0t, states=st, h_final=hf, chunk=chunk)
    got = ssd.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, **kw)
    want = ssd.ssd_chunk_scan_bwd(x.float(), dt, A, Bm.float(), Cm.float(), dy.float(), **kw)
    for n in ("dx", "dB", "dC"):
        _rounded(got[n], want[n])
    for n in ("ddt", "dA", "dD", "dh0"):
        assert (got[n] is None and want[n] is None) or torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [(1, 8, 2, 63, 128, True, 37),
                                                        (2, 4, 4, 65, 16, False, None),
                                                        (4, 32, 32, 1024, 64, True, None)])
def test_attention_bf16_is_f32_rounded(card, B, Hq, Hkv, L, D, causal, window):
    gen = torch.Generator().manual_seed(6)
    q, g = _bf16(gen, card, B, Hq, L, D), _bf16(gen, card, B, Hq, L, D)
    k, v = _bf16(gen, card, B, Hkv, L, D), _bf16(gen, card, B, Hkv, L, D)
    kw = dict(causal=causal, window=window)
    out, lse, o32 = attention.flash_attention(q, k, v, return_lse=True, return_out32=True, **kw)
    out32, lse32 = attention.flash_attention(q.float(), k.float(), v.float(), return_lse=True,
                                             **kw)
    _rounded(out, out32)
    assert torch.equal(lse, lse32) and torch.equal(o32, out32)
    got = attention.flash_attention_bwd(q, k, v, o32, g, lse, **kw)
    want = attention.flash_attention_bwd(q.float(), k.float(), v.float(), o32, g.float(), lse,
                                         **kw)
    for a, f in zip(got, want):
        _rounded(a, f)


def test_lm_kernels_refuse_float16_and_mixed_storage(card):
    h, f = torch.float16, torch.float32
    x = torch.zeros((1, 8, 16), device=card)
    with pytest.raises(TypeError, match="float16"):
        conv1d.conv1d_causal(x.to(h), torch.zeros((4, 16), device=card, dtype=h))
    with pytest.raises(TypeError, match="share one dtype"):
        conv1d.conv1d_causal(x.to(torch.bfloat16), torch.zeros((4, 16), device=card))
    q = torch.zeros((1, 2, 8, 16), device=card)
    with pytest.raises(TypeError, match="share one dtype"):
        attention.flash_attention(q.to(torch.bfloat16), q, q)
    qb = q.to(torch.bfloat16)     # the backward reads the forward's f32 output
    with pytest.raises(TypeError, match="'out' is torch.bfloat16"):
        attention.flash_attention_bwd(qb, qb, qb, qb, qb, torch.zeros((1, 2, 8), device=card))
    with pytest.raises(TypeError, match="'dt'.*float32"):
        ssd.ssd_chunk_scan(*(torch.zeros(s, device=card, dtype=torch.bfloat16)
                             for s in ((1, 8, 2, 4), (1, 8, 2))),
                           torch.zeros(2, device=card, dtype=f),
                           *(torch.zeros((1, 8, 1, 8), device=card, dtype=torch.bfloat16)
                             for _ in range(2)))


def test_smoke_train_and_serve_bf16_on_the_card(card):
    """Zamba2's smoke config at bf16 (RunConfig(param_dtype="bfloat16")):
    training's losses and serving's tokens on the kernels and on the plain
    versions."""
    from repro_torch.launch import train as lm_train

    loop = lm_train.TrainLoopConfig(steps=4, seq_len=64, global_batch=2, log_every=100)
    rc = dataclasses.replace(lm_train.default_run_config(loop), param_dtype="bfloat16")
    quiet = dict(smoke=True, device=card, log_fn=lambda *a: None)
    before = conv1d.launches_bwd
    _, _, hist = lm_train.train("zamba2-1.2b", loop, rc=rc, **quiet)
    assert conv1d.launches_bwd == before + 2 * 4
    plain = dataclasses.replace(rc, attn_impl="ref", ssd_impl="ref", conv_impl="ref")
    _, _, want = lm_train.train("zamba2-1.2b", loop, rc=plain, **quiet)
    np.testing.assert_allclose(hist, want, rtol=1e-2)
    scfg = lm_serve.ServeConfig(batch=2, prompt_len=40, gen_len=6)
    got, info = lm_serve.serve("zamba2-1.2b", scfg, rc=RunConfig(), **quiet)
    wtok, winfo = lm_serve.serve("zamba2-1.2b", scfg, rc=RunConfig(attn_impl="ref",
                                                                 ssd_impl="ref",
                                                                 conv_impl="ref"), **quiet)
    assert info["prefill_logits"].dtype == winfo["prefill_logits"].dtype
    torch.testing.assert_close(info["prefill_logits"].float(), winfo["prefill_logits"].float(),
                               rtol=0, atol=0.1)
