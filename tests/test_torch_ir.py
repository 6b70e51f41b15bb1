"""The port's stencil IR against the JAX package's: footprints, halos, write
rings, read intervals and I/O counts must be equal for the Fig. 1 kernel, a
one-sided upwind kernel, a radius-2 kernel and a two-output kernel. Beyond
the reference, the port's tracer keeps scalar names, literal constants and
operand order, which the code generator needs."""
import numpy as np
import pytest
import struct
import torch

from repro.core import init_parallel_stencil as r_init
from repro_torch.core import fd2d, fd3d, init_parallel_stencil
from repro_torch.ir import Reduction, SymScalar, TraceError, normalize_reductions, trace_stencil
from repro_torch.kernels import codegen


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def upwind(T2, T, dt):
    return {"T2": fd2d.inn(T) + dt * (T[:-2, 1:-1] - T[1:-1, 1:-1])}


def radius2(U2, U, c):
    return {"U2": U[2:-2, 2:-2] + c * (-U[4:, 2:-2] + 16.0 * U[3:-1, 2:-2]
                                       - 30.0 * U[2:-2, 2:-2] + 16.0 * U[1:-3, 2:-2]
                                       - U[:-4, 2:-2] + U[2:-2, 3:-1] - U[2:-2, 1:-3])}


def two_out(A2, B2, A, B, c, h):
    return {
        "A2": A[2:-2, 2:-2, 2:-2] + c * (A[4:, 2:-2, 2:-2] - A[:-4, 2:-2, 2:-2])
        - (1.0 - B[2:-2, 2:-2, 1:-3]) * h,
        "B2": B[1:-1, 1:-1, 1:-1] / (2.0 + abs(A[1:-1, :-2, 1:-1])) - h ** 2 * B[1:-1, 1:-1, 2:],
    }


S3, S2 = (17, 12, 20), (17, 12)
CASES = {
    "fig1": (fig1, ("T2",), 3, dict(T2=S3, T=S3, Ci=S3),
             dict(lam=1.0, dt=1e-4, _dx=1.0, _dy=1.0, _dz=1.0)),
    "upwind": (upwind, ("T2",), 2, dict(T2=S2, T=S2), dict(dt=1e-3)),
    "radius2": (radius2, ("U2",), 2, dict(U2=S2, U=S2), dict(c=0.1)),
    "two_out": (two_out, ("A2", "B2"), 3, dict(A2=S3, B2=S3, A=S3, B=S3), dict(c=0.3, h=0.7)),
}


def _irs(case):
    fn, outs, nd, shapes, sc = CASES[case]
    ref = r_init(ndims=nd).parallel(outputs=outs)(fn).stencil_ir(**shapes, **sc)
    port = init_parallel_stencil(backend="torch", device="cpu", ndims=nd) \
        .parallel(outputs=outs)(fn).stencil_ir(**shapes, **sc)
    return ref, port


@pytest.mark.parametrize("case", list(CASES))
def test_footprints_equal_reference(case):
    ref, port = _irs(case)
    assert port.base_shape == ref.base_shape
    assert port.offsets == ref.offsets
    assert port.out_shapes == ref.out_shapes
    assert port.write_modes == ref.write_modes
    assert port.write_rings == ref.write_rings
    assert port.reads_rel == ref.reads_rel
    assert port.field_halo == ref.field_halo
    assert port.halo == ref.halo
    assert port.inferred_radius == ref.inferred_radius
    assert port.read_fields == ref.read_fields
    assert port.io_counts() == ref.io_counts()
    assert port.io_bytes(4) == ref.io_bytes(4)


def test_expected_footprints_by_hand():
    _, fig = _irs("fig1")
    assert fig.halo == ((1, 1),) * 3 and fig.write_rings["T2"] == (1, 1, 1)
    assert fig.io_counts() == (2, 1)
    _, up = _irs("upwind")
    assert up.halo == ((1, 0), (0, 0))
    _, r2 = _irs("radius2")
    assert r2.inferred_radius == 2 and r2.write_rings["U2"] == (2, 2)
    _, two = _irs("two_out")
    assert two.write_rings == {"A2": (2, 2, 2), "B2": (1, 1, 1)}
    assert two.reads_rel["B2"]["A"] == ((0, 0), (-1, -1), (0, 0))


def test_reversed_subtraction_lowers_differently():
    """Regression: the reference's tracer drops operand order for scalar
    operands, so ``1 - x`` and ``x - 1`` trace the same; the port's must
    not."""
    def lhs(T2, T):
        return {"T2": 1.0 - fd2d.inn(T)}

    def rhs(T2, T):
        return {"T2": fd2d.inn(T) - 1.0}

    progs = [codegen.lower(trace_stencil(lambda f, s, fn=fn: fn(**f, **s),
                                         {"T2": S2, "T": S2}, ("T2",)))
             for fn in (lhs, rhs)]
    assert progs[0].outputs[0].ops == (("sub", (("const", 1.0), ("load", 0))),)
    assert progs[1].outputs[0].ops == (("sub", (("load", 0), ("const", 1.0))),)
    T = torch.rand(S2, dtype=torch.float32)
    outs = [codegen.evaluate_torch(p, {"T2": T, "T": T}, {})[0]["T2"] for p in progs]
    torch.testing.assert_close(outs[0][1:-1, 1:-1], 1.0 - T[1:-1, 1:-1], rtol=0, atol=0)
    torch.testing.assert_close(outs[1][1:-1, 1:-1], T[1:-1, 1:-1] - 1.0, rtol=0, atol=0)


def test_scalars_stay_named_and_constants_keep_values():
    _, ir = _irs("fig1")
    prog = codegen.lower(ir)
    assert [p.key() for p in prog.params] == ["dt", "lam", "(_dx ** 2)", "(_dy ** 2)",
                                              "(_dz ** 2)"]
    assert ("const", 2.0) in {a for _, args in prog.outputs[0].ops for a in args}
    sc = dict(lam=1.5, dt=3e-5, _dx=31.0, _dy=19.0, _dz=7.0)
    assert prog.host_values(sc) == [3e-5, 1.5, 31.0 ** 2, 19.0 ** 2, 7.0 ** 2]
    # loads are relative to the written cell: the 7-point star of T plus Ci
    assert set(prog.outputs[0].loads) == {
        ("T", (0, 0, 0)), ("Ci", (0, 0, 0)), ("T", (1, 0, 0)), ("T", (-1, 0, 0)),
        ("T", (0, 1, 0)), ("T", (0, -1, 0)), ("T", (0, 0, 1)), ("T", (0, 0, -1))}


def test_host_expressions_evaluate_as_python():
    lam, dt = SymScalar("sym", value="lam"), SymScalar("sym", value="dt")
    e = 1 - lam * dt / 3 ** dt
    assert e.key() == "(1 - ((lam * dt) / (3 ** dt)))"
    v = {"lam": 0.7, "dt": 0.3}
    assert e.evaluate(v) == 1 - 0.7 * 0.3 / 3 ** 0.3
    assert (-abs(lam)).evaluate({"lam": -2}) == -2


@pytest.mark.parametrize("bad,err", [
    (lambda T2, T, dt: {"T2": T[1:-1, 1]}, "unsupported index"),
    (lambda T2, T, dt: {"T2": T[1:-1:2, 1:-1]}, "strided"),
    (lambda T2, T, dt: {"T2": torch.sin(T)[1:-1, 1:-1]}, "not symbolically traceable"),
    (lambda T2, T, dt: {"T2": fd2d.inn(T) * (2.0 if dt > 0 else 1.0)}, "no concrete value"),
    (lambda T2, T, dt: {"T2": fd2d.inn(T) + T[2:, 1:]}, "shape mismatch"),
])
def test_trace_errors(bad, err):
    with pytest.raises(TraceError, match=err):
        trace_stencil(lambda f, s: bad(**f, **s), {"T2": S2, "T": S2}, ("T2",), ("dt",))


def test_bad_write_extent_raises():
    with pytest.raises(ValueError, match="even interior margin"):
        trace_stencil(lambda f, s: {"T2": f["T"][1:, 1:-1]}, {"T2": S2, "T": S2}, ("T2",))


def test_reduction_specs():
    with pytest.raises(ValueError, match="must be one of"):
        Reduction("l7_norm", "T2")
    with pytest.raises(ValueError, match="two operands"):
        Reduction("max_abs_diff", "T2")
    with pytest.raises(ValueError, match="one operand"):
        Reduction("sum", "T2", "T")
    with pytest.raises(ValueError, match="cannot parse"):
        normalize_reductions({"e": "max_abs T2"})
    with pytest.raises(ValueError, match="not a field"):
        normalize_reductions({"e": "sum(X)"}, ("T", "T2"))
    reds = normalize_reductions({"e": "max_abs_diff(T2, T)", "s": Reduction("sum", "T")})
    assert reds["e"] == Reduction("max_abs_diff", "T2", "T")
    assert reds["e"].describe() == "max_abs_diff(T2, T)" and reds["s"].combine == "sum"
    x = torch.tensor([1.0, -3.0, 2.0])
    assert float(reds["e"].fold(reds["e"].map_element(x, torch.zeros(3)))) == 3.0
    # the finite/nan_count indicator: 1 for NaN and inf, 0 otherwise
    y = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    assert Reduction("finite", "T").map_element(y).tolist() == [0.0, 1.0, 1.0, 1.0]
    assert float(Reduction("nan_count", "T").fold(Reduction("nan_count", "T").map_element(y))) == 3


def test_float_literals_are_exact_f32():
    for v in (2.0, 0.1, 1 / 3, 16, -30.0, 1e-30, 3.4e38):
        lit = codegen.float_literal(v)
        assert lit.endswith("f")
        (f32,) = struct.unpack("f", struct.pack("f", v))
        assert float.fromhex(lit[:-1]) == f32 == float(np.float32(v))
    assert codegen.float_literal(float("inf")) == "__int_as_float(0x7f800000)"


@pytest.mark.parametrize("case", list(CASES))
def test_cuda_source_prints_every_case(case):
    _, ir = _irs(case)
    prog = codegen.lower(ir)
    src = codegen.cuda_source(prog)
    assert src.count("__global__") == 1
    assert 'extern "C" int launch(' in src and "cudaGetLastError()" in src
    assert src.count("out") >= len(prog.outputs)
    for _, args in (a for o in prog.outputs for a in o.ops):
        for kind, v in args:
            if kind == "const":
                assert codegen.float_literal(v) in src


def test_cuda_source_pow_and_reductions():
    def k(T2, T, q):
        return {"T2": fd2d.inn(T) ** 2 + fd2d.inn(T) ** q + fd2d.inn(T) ** 0.5}

    ir = trace_stencil(lambda f, s: k(**f, **s), {"T2": S2, "T": S2}, ("T2",), ("q",),
                       reductions={"e": "max_abs_diff(T2, T)", "m": "sum_sq(T2)"})
    src = codegen.cuda_source(codegen.lower(ir))
    assert "(l0 * l0)" in src and "powf(l0, p0)" in src and "sqrtf(l0)" in src
    # the input operand is read at the cell through the block's own pointer
    assert "max_nan(acc0, (fabsf(v0 - g1[at0])))" in src
    assert "(acc1 + (v0 * v0))" in src and "part1[bid]" in src


def test_division_by_a_scalar_prints_the_reciprocal_product():
    """PyTorch's CUDA kernel divides a tensor by a Python scalar as a product
    with 1/s taken in double and rounded to f32; the printed kernel does the
    same, for a literal divisor and for a scalar argument (its reciprocal
    passed beside it), and divides tensor by tensor."""
    def k(T2, T, h):
        return {"T2": fd2d.inn(T) / (10.0 / 23.0) + fd2d.inn(T) / h
                + 2.0 / fd2d.inn(T) + fd2d.inn(T) / fd2d.d2_xi(T)}

    ir = trace_stencil(lambda f, s: k(**f, **s), {"T2": S2, "T": S2}, ("T2",), ("h",))
    src = codegen.cuda_source(codegen.lower(ir))
    assert f"(l0 * {codegen.float_literal(2.3)})" in src          # not 2.3000002
    assert codegen.float_literal(2.3) != codegen.float_literal(
        float(np.float32(1.0) / np.float32(10.0 / 23.0)))
    assert "const float p0" in src and "const float r0" in src   # 1 / h, taken on the host
    assert codegen.divisor_params(codegen.lower(ir)) == (0,)
    assert "(l0 * r0)" in src and "((1.0f / l0) * 0x1.0000000000000p+1f)" in src
    assert "(l0 / e" in src
