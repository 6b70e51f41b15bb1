"""The generated k-step kernels' printed CUDA C++, run on the CPU.

``repro_torch.kernels.rehearse`` compiles a kernel's source with ``g++
-ffp-contract=off`` and runs each block's threads as fibers on one core,
barrier by barrier (``tests/test_torch_rehearse.py`` holds the single-step
kernels). Each k-step kernel here must equal the ``torch`` backend's
``run_steps`` bitwise, outputs starting equal to their rotation targets on
the ring as in the solvers: the phases' plane queues, the shrinking halo
cone, the lead of each chunk, rotated loads from the previous sweep,
stages per sweep, boundary faces between sweeps, a staggered rotation and
the last sweep's reductions (max kinds bitwise, sums within 1e-5), and at
extents with interior blocks the phases' unrolled branch-free path. With
outputs apart from their targets on the ring, the kernel must equal its
plain version (``codegen.evaluate_steps_torch``), the reference's in-launch
ring rule. Chunks of 3 planes and a whole-grid chunk put the lead and a
chunk's end at different places. The hand kernel's source
(``csrc/diffusion3d.cu``) is rehearsed the same way against its plain
version. The rehearsal fills dynamic shared memory with NaN before each
block, so a read of a queue element no phase wrote shows.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fd2d, init_parallel_stencil
from repro_torch.kernels import ref, rehearse

from test_torch_coupled import _variant, _variant_args

ALL_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}


def _diffuse2(bc):
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("U2",), rotations={"U2": "U"}, bc={"U2": bc})
    def diffuse(U2, U, dt):
        return {"U2": fd2d.inn(U) + dt * (fd2d.d2_xi(U) + fd2d.d2_yi(U))}
    return diffuse


def _staggered():
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)

    @ps.parallel(outputs=("T2", "q2"), rotations={"T2": "T", "q2": "q"})
    def stag(T2, q2, T, q, dt):
        return {"T2": fd2d.inn(T) + dt * fd2d.d_xi(q), "q2": 0.7 * q + 0.3 * fd2d.av_xa(T)}
    return stag


# extents with blocks whose whole halo cone lies inside the core, where a
# phase runs its unrolled, branch-free path
INTERIOR = {"fig1": (16, 40, 100), "porosity": (20, 600), "gp": (12, 26, 100)}


def _case(name, rng):
    """``(kernel, fields, scalars)`` of a case (``@interior``: at an extent
    of :data:`INTERIOR`); the fields' outputs start as copies of their
    rotation targets."""
    name, _, where = name.partition("@")
    if name.startswith("diffuse2d"):
        kern = _diffuse2("neumann0" if "neumann0" in name else "dirichlet")
        U = torch.tensor(rng.rand(33, 20).astype(np.float32))
        return kern, {"U2": U.clone(), "U": U}, {"dt": 1e-3}
    if name == "staggered":
        T = torch.tensor(rng.rand(21, 24).astype(np.float32))
        q = torch.tensor(rng.rand(20, 24).astype(np.float32))
        return _staggered(), {"T2": T.clone(), "q2": q.clone(), "T": T, "q": q}, {"dt": 1e-3}
    variant, base = {"fig1": ("fig1_step", (9, 10, 33)),
                     "fig1+4red": ("fig1_step+4red", (9, 10, 33)),
                     "porosity_fused[neumann]": ("porosity_fused[neumann]", (33, 20)),
                     "porosity_fused[dirichlet]+err": ("porosity_fused[dirichlet]", (13, 20)),
                     "gp_fused[none]": ("gp_fused[none]", (7, 11, 37)),
                     "gp_fused[neumann]": ("gp_fused[neumann]", (13, 10, 35))}[name]
    if where:
        base = INTERIOR[name.split("_")[0].split("+")[0]]
    kern = _variant(variant, base)
    if name == "fig1+4red":
        kern = kern.with_reductions(ALL_REDS)
    if name.endswith("+err"):
        kern = kern.with_reductions({"err": "max_abs_diff(Pe2, Pe)"})
    f, sc = _variant_args(kern, base, rng)
    for o, t in kern.rotations.items():
        f[o] = f[t].clone()
    return kern, f, sc


CASES = [("fig1", 2), ("fig1", 3), ("fig1+4red", 2), ("diffuse2d[neumann0]", 3),
         ("diffuse2d[dirichlet]", 3), ("porosity_fused[neumann]", 2),
         ("porosity_fused[dirichlet]+err", 2), ("gp_fused[none]", 2),
         ("gp_fused[neumann]", 2), ("staggered", 3), ("fig1+4red@interior", 3),
         ("porosity_fused[dirichlet]+err@interior", 2), ("gp_fused[neumann]@interior", 2)]


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _outs(kern, res):
    res, reds = res if kern.reductions else (res, {})
    return ({kern.outputs[0]: res} if len(kern.outputs) == 1 else res), reds


def _assert_same(kern, got, reds, want, want_reds):
    for o in kern.outputs:
        assert torch.equal(got[o], want[o]), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert float(reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


@pytest.mark.parametrize("name,k", CASES)
@pytest.mark.parametrize("xc", [3, None])
def test_printed_k_step_kernel_equals_run_steps(cxx, name, k, xc, rng):
    kern, f, sc = _case(name, rng)
    want, want_reds = _outs(kern, kern.run_steps(k, **f, **sc))
    got, reds = rehearse.run(kern.compiled(nsteps=k, **f, **sc), f, sc, xc=xc)
    _assert_same(kern, got, reds, want, want_reds)


@pytest.mark.parametrize("name", ["fig1+4red@interior", "porosity_fused[neumann]",
                                  "gp_fused[neumann]", "staggered"])
def test_k_step_printer_single_sweep_equals_single_step(cxx, name, rng):
    """The k-step printer at k = 1 (a ``StencilCall`` with rotations and
    one sweep, which ``tune_stencil --steps --ks 1`` times against the
    single-step kernel) equals the single step bitwise."""
    from repro_torch.kernels import stencil

    kern, f, sc = _case(name, rng)
    want, want_reds = _outs(kern, kern(**f, **sc))
    call = stencil.StencilCall(kern.compiled(**f, **sc).ir, kern.label, kern.bc, nsteps=1,
                               rotations=kern.rotations)
    assert call.label == f"{kern.label}/k1"
    got, reds = rehearse.run(call, f, sc, xc=3)
    _assert_same(kern, got, reds, want, want_reds)


@pytest.mark.parametrize("name,k", [("fig1+4red", 3), ("porosity_fused[neumann]", 2),
                                    ("gp_fused[neumann]", 2)])
def test_printed_k_step_kernel_keeps_the_reference_ring_rule(cxx, name, k, rng):
    """Outputs apart from their targets on the ring: an intermediate sweep
    carries the target's ring, the last the output's own."""
    kern, f, sc = _case(name, rng)
    for o in kern.outputs:
        f[o] = f[o] + 0.25
    call = kern.compiled(nsteps=k, **f, **sc)
    want, want_reds = call.run(f, sc)
    got, reds = rehearse.run(call, f, sc, xc=5)
    _assert_same(kern, got, reds, want, want_reds)


@pytest.mark.parametrize("shape", [(9, 10, 33), INTERIOR["fig1"]])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_hand_diffusion3d_source_equals_plain(cxx, shape, k, rng):
    """The hand kernel ``csrc/diffusion3d.cu`` on one core: k steps in one
    launch equal k rotated plain steps when T2 and T agree on the ring, and
    the plain version's k-step ring rule when they do not."""
    T = torch.tensor(rng.rand(*shape).astype(np.float32))
    Ci = torch.tensor(rng.rand(*shape).astype(np.float32) + 0.5)
    args = (1.0, 1e-4, 8.0, 9.0, 10.0)
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = ref.diffusion3d_step(a, b, Ci, *args)
        a, b = b, a
    assert torch.equal(rehearse.diffusion3d_step(T.clone(), T, Ci, *args, nsteps=k, xc=3), b)
    T2 = torch.tensor(rng.rand(*shape).astype(np.float32))
    assert torch.equal(rehearse.diffusion3d_step(T2, T, Ci, *args, nsteps=k),
                       ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k))
