"""The port's kernel modules on the CPU: the plain diffusion3d step against
the JAX package's reference and Pallas kernel, the code generator's torch
form against the ``torch`` backend, the launch derivation and the nvcc
build's failure paths. The CUDA kernels themselves are held against
their plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: the plain diffusion3d step against the reference is held to
1e-5 (as the reference's own tests hold its Pallas kernel), with the
boundary ring kept exactly. The generated tap program evaluated with torch
operators must equal the ``torch`` backend bitwise: the same f32 operations
in the same order on the same values.
"""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops, ref as r_ref
from repro_torch.core import fd2d, fd3d, init_parallel_stencil
from repro_torch.kernels import build, codegen, diffusion3d, ops, ref, stencil

ALL_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}


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


def _inputs(rng, names, shape, device="cpu"):
    return {n: torch.tensor(rng.rand(*shape).astype(np.float32) + 0.5, device=device)
            for n in names}


CASES = {
    "fig1": (fig1, ("T2",), 3, ("T2", "T", "Ci"), (17, 12, 20),
             dict(lam=1.0, dt=1e-3, _dx=16.0, _dy=11.0, _dz=19.0), ALL_REDS),
    "upwind": (upwind, ("T2",), 2, ("T2", "T"), (17, 12), dict(dt=1e-3),
               {"e": "max_abs_diff(T2, T)"}),
    "radius2": (radius2, ("U2",), 2, ("U2", "U"), (17, 12), dict(c=0.1), {"s": "sum(U2)"}),
    "two_out": (two_out, ("A2", "B2"), 3, ("A2", "B2", "A", "B"), (17, 12, 20),
                dict(c=0.3, h=0.7), {"d": "max_abs_diff(A2, A)", "s": "sum_sq(B2)"}),
}


# ------------------------------------------------------------ diffusion3d
@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 24, 40), (8, 8, 128)])
def test_diffusion3d_ref_matches_reference(shape, rng):
    T = rng.rand(*shape).astype(np.float32)
    Ci = (rng.rand(*shape) + 0.5).astype(np.float32)
    args = (1.0, 1e-4, float(shape[0] - 1), float(shape[1] - 1), float(shape[2] - 1))
    got = ref.diffusion3d_step(torch.tensor(T), torch.tensor(T), torch.tensor(Ci), *args)
    want_ref = r_ref.diffusion3d_step(jnp.asarray(T), jnp.asarray(T), jnp.asarray(Ci), *args)
    want_pallas = r_ops.diffusion3d_step(jnp.asarray(T), jnp.asarray(T), jnp.asarray(Ci),
                                         *args, impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(17, 12), (9, 10, 11)])
def test_laplacian_step_ref_matches_reference(shape, rng):
    U = rng.rand(*shape).astype(np.float32)
    inv = tuple(float(s - 1) for s in shape)
    got = ref.laplacian_step(torch.tensor(U), 0.5, 1e-3, inv)
    want = r_ref.laplacian_step(jnp.asarray(U), 0.5, 1e-3, inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.numpy()[0], U[0])


def test_diffusion3d_boundary_preserved(rng):
    shape = (16, 12, 20)
    T = torch.tensor(rng.rand(*shape).astype(np.float32))
    T2 = torch.full(shape, 7.0)
    got = ops.diffusion3d_step(T2, T, torch.ones(shape), 1.0, 1e-4, 15.0, 11.0, 19.0)
    for face in (got[0], got[-1], got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert bool((face == 7.0).all())
    assert bool((got[1:-1, 1:-1, 1:-1] != 7.0).all())


def test_diffusion3d_dispatch_and_unported(rng):
    shape = (9, 10, 11)
    T, T2, Ci = (torch.tensor(rng.rand(*shape).astype(np.float32)) for _ in range(3))
    args = (1.0, 1e-3, 8.0, 9.0, 10.0)
    # on CPU tensors the wrapper runs the plain version, and launches nothing
    before = diffusion3d.launches
    a = ops.diffusion3d_step(T2, T, Ci, *args, impl="cuda")
    assert diffusion3d.launches == before
    assert torch.equal(a, ops.diffusion3d_step(T2, T, Ci, *args, impl="ref"))
    with pytest.raises(ValueError, match="impl"):
        ops.diffusion3d_step(T2, T, Ci, *args, impl="pallas")
    # nsteps is ported (tests/test_torch_temporal.py): two steps in one call
    # equal two rotated calls when T2 and T agree on the ring
    two = diffusion3d.diffusion3d_step(T, T, Ci, *args, nsteps=2)
    assert torch.equal(two, ops.diffusion3d_step(T, ops.diffusion3d_step(T, T, Ci, *args),
                                                 Ci, *args, impl="ref"))
    assert diffusion3d.launches == before


def test_explicit_step_equals_parallel_step_bitwise(rng):
    """The explicit kernel and the math-close @parallel step do the same
    f32 operations in the same order: their plain versions agree bitwise."""
    shape = (17, 12, 20)
    f = _inputs(rng, ("T2", "T", "Ci"), shape)
    sc = dict(lam=1.0, dt=1e-3, _dx=16.0, _dy=11.0, _dz=19.0)
    step = init_parallel_stencil(backend="torch", device="cpu").parallel(outputs=("T2",))(fig1)
    want = step(**f, **sc)
    got = ops.diffusion3d_step(f["T2"], f["T"], f["Ci"], *sc.values())
    assert torch.equal(got, want)


# -------------------------------------------------------------- codegen
def _kernel(case, reductions=None):
    fn, outs, nd, _, _, _, reds = CASES[case]
    ps = init_parallel_stencil(backend="torch", device="cpu", ndims=nd)
    return ps.parallel(outputs=outs, reductions=reductions if reductions is not None
                       else reds)(fn)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_form_equals_torch_backend_bitwise(case, rng):
    _, outs, _, names, shape, sc, _ = CASES[case]
    kern = _kernel(case)
    f = _inputs(rng, names, shape)
    want, want_reds = kern(**f, **sc)
    prog = codegen.lower(kern.stencil_ir(**f, **sc))
    got, got_reds = codegen.evaluate_torch(prog, f, sc)
    want = {outs[0]: want} if len(outs) == 1 else want
    for o in outs:
        assert torch.equal(got[o], want[o]), o
    for n in want_reds:
        assert torch.equal(got_reds[n], want_reds[n]), n


def test_stencil_call_on_cpu_runs_the_torch_form(rng):
    _, _, _, names, shape, sc, _ = CASES["two_out"]
    kern = _kernel("two_out")
    f = _inputs(rng, names, shape)
    call = kern.compiled(**f, **sc)
    before = sum(stencil.launches.values())
    outs, reds = call.run(f, sc)
    assert sum(stencil.launches.values()) == before
    want, want_reds = kern(**f, **sc)
    assert all(torch.equal(outs[o], want[o]) for o in want)
    assert all(torch.equal(reds[n], want_reds[n]) for n in want_reds)
    assert call.lib_name == "stencil_two_out_d_s_"


def test_derive_launch_covers_the_grid():
    kernel = codegen.KernelShape((32, 8), 4, 4)
    for shape in [(512, 512, 512), (33, 20, 130), (1, 17, 12), (1, 1, 5)]:
        la = stencil.derive_launch(shape, 132, kernel)
        gz, gy, gx = la.grid
        assert gz * 32 >= shape[2] and gy * 8 >= shape[1] and gx * la.xc >= shape[0]
        assert (gx - 1) * la.xc < shape[0]
        assert la.block == (32, 8, 1) and la.xc % kernel.planes == 0
        # a staged kernel's chunk and its lag fill whole steps
        lagged = stencil.derive_launch(shape, 132, kernel, lag=2)
        assert (lagged.xc + 2) % kernel.planes == 0
    la = stencil.derive_launch((512, 512, 512), 132, kernel)
    # about WAVES waves of the kernel's resident 256-thread blocks on each of 132 SMs
    assert la.n_blocks >= stencil.WAVES * kernel.min_blocks * 132
    with pytest.raises(ValueError, match="grid limits"):
        stencil.derive_launch((4, 8 * 70000, 4), 132, kernel)
    # the hand kernel keeps its own launch: each thread marches x, about 4
    # waves of 8 resident blocks
    la = diffusion3d.column_launch((512, 512, 512), 132)
    assert la.block == (32, 8, 1) and la.grid == (16, 64, 5) and la.xc == 103


# ---------------------------------------------------------------- build
def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.nvcc()
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.compile_many([("never_built", "// no such library yet\n" + repr(os.getpid()))])


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: this compiler refuses everything' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="refuses everything"):
        build.compile_many([("bad", "int main() {}\n")])
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_caches_by_source(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    # a stand-in compiler: writes its -o target
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n')
    fake.chmod(0o755)
    calls = []
    monkeypatch.setattr(build, "nvcc", lambda: calls.append(1) or str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "BUILDS", {})
    a, b = build.compile_many([("k", "// a\n"), ("k", "// b\n")])
    assert a.library != b.library and a.library.exists() and b.library.exists()
    assert build.library_path("k", "// a\n") == a.library
    (again,) = build.compile_many([("k", "// a\n")])
    assert again is a and len(calls) == 1
    # the stencil kernels are held bitwise (no FMA contraction); attention
    # and SSD, held to a tolerance, compile with it
    assert "--fmad=false" in build.flags("k") and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--fmad=false" not in build.flags("attention") + build.flags("ssd")


def test_library_argtypes_match_the_c_entry_points():
    """Pointers and the stream are c_void_p, sizes c_int64, scalars c_float,
    in the order each C source declares them: the forward kernels (the
    attention forward's log-sum-exp pointer among them) and the backward
    kernels of conv1d, SSD and attention."""
    from repro_torch.kernels import attention, conv1d, ssd
    kinds = {"int64_t": ctypes.c_int64, "float": ctypes.c_float}
    pairs = [(mod.SOURCE, mod._ARGTYPES) for mod in (diffusion3d, conv1d, ssd, attention)]
    pairs += [(mod.BWD_SOURCE, mod._BWD_ARGTYPES) for mod in (conv1d, ssd, attention)]
    for path, argtypes in pairs:
        src = path.read_text()
        head = 'extern "C" int launch('
        sig = src[src.index(head) + len(head):].split(")", 1)[0]
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]] for p in sig.split(",")]
        assert argtypes == want, path.name
    assert "void* lse" in attention.SOURCE.read_text()


def test_read_source_inlines_the_csrc_headers(tmp_path, monkeypatch):
    """A source's ``#include "x.cuh"`` of a header in csrc/ becomes the
    header's text, so a changed header changes the library's hash; system
    headers stay as they are."""
    (tmp_path / "h.cuh").write_text("// helper v1\n")
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "h.cuh"\nint k;\n')
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    text = build.read_source(tmp_path / "k.cu")
    assert text == "#include <cstdint>\n// helper v1\n\nint k;\n"
    (tmp_path / "h.cuh").write_text("// helper v2\n")
    assert build.library_path("k", build.read_source(tmp_path / "k.cu")) \
        != build.library_path("k", text)
    from repro_torch.kernels import attention, ssd
    for mod in (attention, ssd):
        assert '#include "tf32x3.cuh"' in mod.SOURCE.read_text()
