"""The generated kernel's printed CUDA C++, run on the CPU.

``repro_torch.kernels.rehearse`` compiles a kernel's source with ``g++
-ffp-contract=off`` behind stand-ins for CUDA's names and runs each block's
threads as fibers on one core, phase by phase between its barriers. Each variant
must equal the ``torch`` backend bitwise (max reductions bitwise, sums
within 1e-5): the staging of intermediates, the rolling plane queue, the
march in steps of planes, the core/direct split, boundary faces, staggered
extents and the shuffled reduction fold. Chunks of 1 and 3 planes and a
whole-grid chunk put the queue's lead and a partial step at every place a
chunk can end.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rehearse

from test_torch_coupled import VARIANTS, _variant, _variant_args

CASES = [
    ("porosity_fused[neumann]", (9, 12)), ("porosity_fused[periodic]", (37, 300)),
    ("porosity_fused[dirichlet]", (33, 20)), ("porosity_fused[neumann]+err", (13, 20)),
    ("porosity_fluxes", (9, 12)), ("porosity_update[neumann]", (9, 12)),
    ("gp_fused[none]", (7, 8, 9)), ("gp_fused[periodic]", (7, 8, 9)),
    ("gp_fused[none]+mass", (11, 10, 35)), ("gp_step_im", (7, 8, 9)),
    ("fig1_step+4red", (9, 10, 33)),
]


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


@pytest.mark.parametrize("name,base", CASES)
@pytest.mark.parametrize("xc", [1, 3, None])
def test_printed_kernel_equals_torch_backend(cxx, name, base, xc, rng):
    assert name in VARIANTS
    kern = _variant(name, base)
    f, sc = _variant_args(kern, base, rng)
    want = kern(**f, **sc)
    want, want_reds = want if kern.reductions else (want, {})
    want = {kern.outputs[0]: want} if len(kern.outputs) == 1 else want
    got, reds = rehearse.run(kern.compiled(**f, **sc), f, sc, xc=xc)
    for o in kern.outputs:
        assert torch.equal(got[o], want[o]), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert float(reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


def test_printed_division_by_a_scalar_argument(cxx, rng):
    """A tensor divided by a scalar argument reads the divisor's argument
    after the parameters (on the card its reciprocal), beside a literal
    divisor and a scalar over a tensor."""
    from repro_torch.core import fd2d, init_parallel_stencil

    @init_parallel_stencil(backend="torch", device="cpu", ndims=2).parallel(outputs=("T2",))
    def divisions(T2, T, h):
        return {"T2": 2.0 / fd2d.inn(T) + fd2d.inn(T) / h + fd2d.inn(T) / (10.0 / 23.0)}

    f = {n: torch.tensor(rng.rand(33, 130).astype(np.float32) + 0.5) for n in ("T2", "T")}
    for h in (10.0 / 23.0, 3.0):
        got, _ = rehearse.run(divisions.compiled(**f, h=h), f, {"h": h}, xc=3)
        assert torch.equal(got["T2"], divisions(**f, h=h)), h
