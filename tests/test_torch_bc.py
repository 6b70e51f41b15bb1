"""Boundary conditions in the port against the JAX package.

The post-pass twins (``repro_torch.core.boundary``) must equal
``repro.core.boundary`` bitwise: both copy values, nothing is rounded. The
engine's bc on the ``torch`` backend must equal the raw step followed by the
post-pass bitwise (the reference's ``test_porosity_fused_bc_matches_postpass``
shape), and the generated kernel's torch form, which takes each face value
from its source cell as the CUDA kernel does, must equal the ``torch``
backend bitwise. Across packages the updates are held to rtol/atol 1e-6
(f32 arithmetic in two frameworks; the post-pass itself adds no rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as r_boundary, fd2d as r_fd2d, init_parallel_stencil as r_init
from repro.ir import BoundaryCondition as RBC
from repro_torch.core import boundary, fd2d, fd3d, init_parallel_stencil
from repro_torch.ir import BoundaryCondition, normalize_bcs
from repro_torch.kernels import codegen

KINDS = ("dirichlet", "neumann0", "periodic")


def _apply_both(kind, a, axes, depth):
    t = torch.tensor(a)
    if kind == "dirichlet":
        return (boundary.dirichlet(t, 0.375, axes=axes, depth=depth),
                r_boundary.dirichlet(jnp.asarray(a), 0.375, axes=axes, depth=depth))
    fn, rfn = getattr(boundary, kind), getattr(r_boundary, kind)
    return fn(t, axes=axes, depth=depth), rfn(jnp.asarray(a), axes=axes, depth=depth)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,axes,depth", [((7, 9), None, 1), ((9, 11, 6), None, 2),
                                              ((8, 10, 12), (2, 0), 1), ((6,), None, 2)])
def test_post_pass_equals_reference_bitwise(kind, shape, axes, depth, rng):
    a = rng.rand(*shape).astype(np.float32)
    got, want = _apply_both(kind, a, axes, depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), a)      # the faces did change
    # a new tensor: the input is untouched
    assert np.array_equal(torch.tensor(a).numpy(), a)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,axes,depth", [((7, 9), None, 1), ((9, 11, 6), None, 2),
                                              ((8, 10, 12), (2, 0), 1), ((9, 6), (1,), 2)])
def test_source_cell_form_equals_post_pass_bitwise(kind, shape, axes, depth, rng):
    """The kernel's design: each face cell takes its source cell's value,
    each axis mapped on its own, equals the sequential post-pass, corners
    included."""
    a = torch.tensor(rng.rand(*shape).astype(np.float32))
    bc = BoundaryCondition(kind, value=0.375, axes=axes, depth=depth)
    assert torch.equal(codegen.apply_bc(a, bc), bc.apply(a))


def test_bc_source_map():
    assert codegen.bc_source("neumann0", 6, 1) == [1, 1, 2, 3, 4, 4]
    assert codegen.bc_source("periodic", 6, 1) == [4, 1, 2, 3, 4, 1]
    assert codegen.bc_source("neumann0", 6, 2) == [2, 3, 2, 3, 2, 3]
    assert codegen.bc_source("periodic", 7, 2) == [3, 4, 2, 3, 4, 2, 3]


@pytest.mark.parametrize("kind,n", [("dirichlet", 1), ("neumann0", 2), ("periodic", 2)])
def test_check_depth_refuses_what_the_reference_refuses(kind, n):
    for mod in (boundary, r_boundary):
        with pytest.raises(ValueError, match="smaller than"):
            mod.check_depth((n, 8), kind, (0,), 1)
        with pytest.raises(ValueError, match="depth must be"):
            mod.check_depth((8, 8), kind, (0,), 0)
    boundary.check_depth((n + 1, 8), kind, (0,), 1)


def test_boundary_condition_and_normalize():
    assert BoundaryCondition("periodic", axes=[1]).axes == (1,)
    assert BoundaryCondition("neumann0").resolved_axes(3) == (0, 1, 2)
    with pytest.raises(ValueError, match="must be one of"):
        BoundaryCondition("reflect")
    with pytest.raises(ValueError, match="depth"):
        BoundaryCondition("neumann0", depth=0)
    bcs = normalize_bcs({"T2": "neumann0"}, ("T2",), 3)
    assert bcs == {"T2": BoundaryCondition("neumann0")}
    for bad, err in [({"T": "neumann0"}, "not an output"), ({"T2": 3}, "must be a"),
                     ({"T2": BoundaryCondition("dirichlet", axes=(3,))}, "out of range")]:
        with pytest.raises(ValueError, match=err):
            normalize_bcs(bad, ("T2",), 3)
    with pytest.raises(ValueError, match="smaller than"):
        normalize_bcs({"T2": "periodic"}, ("T2",), 3, field_shapes={"T2": (2, 9, 9)})
    assert normalize_bcs(None, ("T2",), 3) == {}


def _diffuse(fd):
    def kern(A2, A, c):
        return {"A2": fd.inn(A) + c * (fd.d2_xi(A) + fd.d2_yi(A))}
    return kern


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_bc_equals_raw_step_plus_post_pass_bitwise(kind, depth, rng):
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    bc = BoundaryCondition(kind, value=0.25, depth=depth)
    fused = ps.parallel(outputs=("A2",), bc={"A2": bc})(_diffuse(fd2d))
    raw = ps.parallel(outputs=("A2",))(_diffuse(fd2d))
    f = {n: torch.tensor(rng.rand(13, 10).astype(np.float32)) for n in ("A2", "A")}
    assert torch.equal(fused(**f, c=0.1), bc.apply(raw(**f, c=0.1)))


@pytest.mark.parametrize("kind", KINDS)
def test_engine_bc_matches_reference(kind, rng):
    a = {n: rng.rand(13, 10).astype(np.float32) for n in ("A2", "A")}
    bc = {"A2": BoundaryCondition(kind, value=0.25)}
    got = init_parallel_stencil(backend="torch", device="cpu", ndims=2).parallel(
        outputs=("A2",), bc=bc)(_diffuse(fd2d))(**{n: torch.tensor(v) for n, v in a.items()},
                                                c=0.1)
    want = r_init(ndims=2).parallel(outputs=("A2",), bc={"A2": RBC(kind, value=0.25)})(
        _diffuse(r_fd2d))(**{n: jnp.asarray(v) for n, v in a.items()}, c=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _radius2_two_out(A2, B2, A, B, c):
    """Ring 2 for A2 (a depth-1 neumann0 face takes a kept ring value) and
    ring 1 for B2."""
    return {"A2": fd3d.inn(fd3d.inn(A)) + c * fd3d.d2_xi(fd3d.d2_yi(A)),
            "B2": fd3d.inn(B) - c * fd3d.d2_zi(A)}


@pytest.mark.parametrize("kind", KINDS)
def test_torch_form_of_bc_kernel_equals_torch_backend_bitwise(kind, rng):
    ps = init_parallel_stencil(backend="torch", device="cpu")
    bc = {"A2": BoundaryCondition(kind, value=-0.5, axes=(0, 2)),
          "B2": BoundaryCondition(kind, value=0.5, depth=2)}
    kern = ps.parallel(outputs=("A2", "B2"), bc=bc,
                       reductions=None if kind == "periodic" else {"m": "max_abs(A2)"}
                       )(_radius2_two_out)
    f = {n: torch.tensor(rng.rand(9, 8, 11).astype(np.float32)) for n in ("A2", "B2", "A", "B")}
    want = kern(**f, c=0.3)
    want, want_reds = (want, None) if kind == "periodic" else want
    got, got_reds = codegen.evaluate_torch(codegen.lower(kern.stencil_ir(**f, c=0.3), kern.bc),
                                           f, {"c": 0.3})
    for o in ("A2", "B2"):
        assert torch.equal(got[o], want[o]), o
    if want_reds:
        assert torch.equal(got_reds["m"], want_reds["m"])


def test_periodic_next_to_reductions_is_refused_as_in_the_reference():
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    with pytest.raises(ValueError, match="periodic"):
        ps.parallel(outputs=("A2",), bc={"A2": "periodic"},
                    reductions={"e": "max_abs_diff(A2, A)"})(_diffuse(fd2d))
    kern = ps.parallel(outputs=("A2",), bc={"A2": "periodic"})(_diffuse(fd2d))
    with pytest.raises(ValueError, match="periodic"):
        kern.with_reductions({"e": "max_abs_diff(A2, A)"})
    # neumann0 and dirichlet carry reductions, folded after the bc
    nk = ps.parallel(outputs=("A2",), bc={"A2": BoundaryCondition("dirichlet", value=7.0)},
                     reductions={"m": "max_abs(A2)"})(_diffuse(fd2d))
    _, reds = nk(A2=torch.zeros(6, 7), A=torch.zeros(6, 7), c=0.1)
    assert float(reds["m"]) == 7.0


def test_bc_depth_is_checked_against_the_field_shape():
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=2)
    kern = ps.parallel(outputs=("A2",), bc={"A2": BoundaryCondition("neumann0", depth=2)})(
        _diffuse(fd2d))
    with pytest.raises(ValueError, match="smaller than"):
        kern(A2=torch.zeros(5, 9), A=torch.zeros(5, 9), c=0.1)
