"""The hand ``diffusion3d`` kernel's layouts, on the CPU.

``csrc/diffusion3d.cu`` runs the Fig. 1 step three ways: one cell a thread
(``diffusion3d_kernel``; f32, and 2-byte fields the pair layout does not
fit), two cells of z a thread in 4-byte words for bf16 and f16
(``diffusion3d_pairs_kernel``, nz even and every field 4-byte aligned,
``diffusion3d.pairs_fit``), and k steps in one launch over a 32 x 32 tile
walked by 256 threads, T staged a step ahead and Ci through a ring of its
own or read by each sweep (``diffusion3d_steps_kernel<K, S>``). The
rehearsal (``kernels/rehearse.py``) runs the source's every variant on one
core behind stand-ins for CUDA's names, each field in the middle of a NaN
buffer, shared memory NaN before each block, and a load or an asynchronous
copy outside the fields counted (it raises): each must equal the plain
version ``ref.diffusion3d_steps`` bit for bit, at f32, bf16 and f16, k =
1-4, into a new buffer and in place, at even and odd nz, with tiles that
overhang the field and a last chunk of one plane. The launch arithmetic the
wrapper sizes grids by is held to the source's own (shared memory, resident
blocks, the pair rule), and the rehearsed f32 kernel to the JAX package's
Pallas kernel in interpret mode within 1e-5 (the tolerance of
``tests/test_torch_kernels.py``: the reference computes its own f32
operations in another order).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import diffusion3d as r_diffusion3d
from repro_torch.kernels import build, diffusion3d, ref, rehearse

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# nz even (the pair layout at 2 bytes) and odd (one cell a thread); rows and
# columns that overhang the 32 x 32 k-step tile and the 64 x 8 pair block;
# nx = 10 with chunks of 3 planes leaves a last chunk of one plane
SHAPES = {"even": (10, 37, 66), "odd": (10, 34, 65)}
# lam and the spacings such that every product rounds at 2 bytes
ARGS = (0.7, 1e-4, 8.3, 9.1, 10.7)


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the kernel")


def _fields(shape, dt, rng):
    T = torch.tensor(rng.rand(*shape).astype(np.float32)).to(dt)
    Ci = torch.tensor(rng.rand(*shape).astype(np.float32) + 0.5).to(dt)
    T2 = torch.tensor(rng.rand(*shape).astype(np.float32)).to(dt)
    return T2, T, Ci


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("nz", list(SHAPES))
def test_rehearsed_kernel_equals_plain_bitwise(cxx, nz, tag, k, alias, rng):
    """Every layout, k = 1-4, in place and not: T2 apart from T on the ring
    (the k-step ring rule of the plain version), and T2 a copy of T (k
    rotated single steps), in chunks of 3 planes (the last of one) and in
    the chunks the wrapper derives."""
    shape, dt = SHAPES[nz], DTYPES[tag]
    T2, T, Ci = _fields(shape, dt, rng)
    want = ref.diffusion3d_steps(T2, T, Ci, *ARGS, nsteps=k)
    for xc in (3, None):
        got = rehearse.diffusion3d_step(T2, T, Ci, *ARGS, nsteps=k, xc=xc, alias=alias)
        assert got.dtype == dt and torch.equal(got, want), xc
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = ref.diffusion3d_step(a, b, Ci, *ARGS)
        a, b = b, a
    got = rehearse.diffusion3d_step(T.clone(), T, Ci, *ARGS, nsteps=k, xc=3, alias=alias)
    assert torch.equal(got, b)


@pytest.mark.parametrize("tag", ["bf16", "f16"])
def test_pair_layout_where_it_fits(cxx, tag, rng):
    """The pair layout needs nz even and 4-byte aligned fields; a view two
    bytes off a word, or an odd nz, takes the one-cell kernel, and both
    equal the plain version. f32 never takes it."""
    dt = DTYPES[tag]
    shape = SHAPES["even"]
    T2, T, Ci = _fields(shape, dt, rng)
    assert diffusion3d.pairs_fit(shape[2], T2, T, Ci)
    assert not diffusion3d.pairs_fit(SHAPES["odd"][2], *_fields(SHAPES["odd"], dt, rng))
    assert not diffusion3d.pairs_fit(shape[2], *(t.float() for t in (T2, T, Ci)))
    off = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape) for t in (T2, T, Ci)]
    assert all(t.data_ptr() % 4 == 2 for t in off)
    assert not diffusion3d.pairs_fit(shape[2], *off)
    want = ref.diffusion3d_steps(T2, T, Ci, *ARGS)
    assert torch.equal(rehearse.diffusion3d_step(*off, *ARGS, xc=3), want)
    assert torch.equal(rehearse.diffusion3d_step(T2, T, Ci, *ARGS, xc=3), want)
    assert diffusion3d.layout(1, 2, True) == "pairs" and diffusion3d.layout(1, 2) == "cells"


_PROBE = r'''
extern "C" int probe_rows(int k, int itemsize) { return tile_rows(k, itemsize); }
extern "C" int probe_bytes(int k, int itemsize) {
  return itemsize == 4 ? steps_bytes<float>(k) : steps_bytes<__half>(k);
}
extern "C" int probe_resident(int k, int itemsize) {
  return itemsize == 4 ? resident<float>(k) : resident<__half>(k);
}
extern "C" int probe_stage_ci(int k, int itemsize) { return stage_ci(k, itemsize); }
extern "C" int probe_pairs(int64_t a, int64_t b, int64_t c, int64_t d, int64_t nz) {
  return pairs_fit(reinterpret_cast<void*>(a), reinterpret_cast<void*>(b),
                   reinterpret_cast<void*>(c), reinterpret_cast<void*>(d), nz);
}
'''


@pytest.fixture(scope="module")
def source_probe():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to compile the source's constants")
    text = rehearse._host_text(build.read_source(diffusion3d.SOURCE), 1)
    return rehearse._compile(text + _PROBE, "diffusion3d_probe")


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_launch_arithmetic_equals_the_source(source_probe, k, itemsize):
    """The wrapper sizes the k-step launch by the source's own shared memory,
    resident blocks and Ci choice, and every variant keeps two blocks on an
    SM (two blocks of it fit in 232,448 bytes); the chosen layout's
    grid covers the field with its tiles (32 x 24 at f32 and k = 4, else
    32 x 32)."""
    got = diffusion3d.shared_bytes(k, itemsize)
    assert got == source_probe.probe_bytes(k, itemsize)
    assert diffusion3d.tile_rows(k, itemsize) == source_probe.probe_rows(k, itemsize)
    assert diffusion3d.resident(k, itemsize) == source_probe.probe_resident(k, itemsize)
    assert diffusion3d.stage_ci(k, itemsize) == bool(source_probe.probe_stage_ci(k, itemsize))
    assert 2 * got <= 232448 and diffusion3d.resident(k, itemsize) >= 2
    rows = diffusion3d.tile_rows(k, itemsize)
    launch = diffusion3d.column_launch((512, 512, 512), 132, k, itemsize)
    assert launch.grid[:2] == (16, -(-512 // rows)) and launch.block == (32, rows, 1)
    assert (launch.xc + 2 * k) % 2 == 0 and launch.grid[2] * launch.xc >= 512


def test_pair_rule_equals_the_source(source_probe):
    """``diffusion3d.pairs_fit`` (the grid's rule) and the source's
    ``pairs_fit`` (the kernel's) agree on nz and alignment."""
    fn = source_probe.probe_pairs
    fn.argtypes = [ctypes.c_int64] * 5
    for nz in (64, 65):
        for shift in (0, 2):
            base = torch.zeros(2 * 4 * nz + 2, dtype=torch.bfloat16)
            ts = [base[shift // 2:shift // 2 + 4 * nz].view(2, 2, nz) for _ in range(4)]
            want = diffusion3d.pairs_fit(nz, *ts)
            assert want == (nz % 2 == 0 and shift == 0)
            assert bool(fn(*(t.data_ptr() for t in ts), nz)) == want
    launch = diffusion3d.column_launch((512, 512, 512), 132, 1, 2, pairs=True)
    assert launch.grid[:2] == (8, 64) and launch.block == (64, 8, 1)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_rehearsed_f32_matches_jax_interpret(cxx, k, rng):
    """The rehearsed f32 kernel against the JAX package's Pallas kernel of
    ``nsteps = k`` in interpret mode, within 1e-5, the boundary ring exact
    (T2 a copy of T)."""
    shape = (9, 12, 34)
    T = rng.rand(*shape).astype(np.float32)
    Ci = (rng.rand(*shape) + 0.5).astype(np.float32)
    args = (1.0, 1e-4, float(shape[0] - 1), float(shape[1] - 1), float(shape[2] - 1))
    got = rehearse.diffusion3d_step(torch.tensor(T), torch.tensor(T), torch.tensor(Ci), *args,
                                    nsteps=k).numpy()
    want = np.asarray(r_diffusion3d.diffusion3d_step(jnp.asarray(T), jnp.asarray(T),
                                                     jnp.asarray(Ci), *args, interpret=True,
                                                     nsteps=k))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
                 np.s_[:, :, -1]):
        np.testing.assert_array_equal(got[face], T[face])


def test_tuning_variants_change_one_choice_each():
    """``tune_stencil.hand_variant`` rewrites exactly the source's constant
    of each choice it is given (the Ci ring, the resident cap, the tile's
    rows) and leaves the rest of the text as it was."""
    from repro_torch.launch import tune_stencil

    text = build.read_source(diffusion3d.SOURCE)
    assert tune_stencil.hand_variant(text) == text
    for kw, needle in (({"ci": False}, "constexpr bool stage_ci(int k, int bytes) {\n  return false;"),
                       ({"cap": 3}, "constexpr int kMaxResident = 3;"),
                       ({"rows": 16}, "constexpr int tile_rows(int k, int bytes) {\n  return 16;")):
        got = tune_stencil.hand_variant(text, **kw)
        assert needle in got and needle not in text
        assert len(got.splitlines()) == len(text.splitlines())
    assert set(tune_stencil.HAND_VARIANTS) >= {"own", "ci-ldg", "b3", "rows16", "rows32"}


def _sass(fn: str, body: list) -> str:
    lines = [f"\n\tFunction : _ZN12_GLOBAL__N_1{fn}EEvPT0_", "\t.text"]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;   /* 0x0 */")
    return "\n".join(lines) + "\n"


def test_sass_hand_counts_a_cell_by_segment():
    """``tune_stencil.sass_hand`` cuts the k-step kernel's march loop at its
    barriers and counts each segment's instructions by class over its cells
    a thread a step (k = 2 at f32: the landing over T's 6 rounds of 2
    planes, sweep 0 over 5, the last sweep over 4); the single step's loop
    over the cells its full stores write (a word two cells in the pair
    layout)."""
    from repro_torch.launch import tune_stencil

    # k = 2: a loop of 3 segments between 2 barriers
    body = (["MOV R0, R1"] + ["LDGDEPBAR"] * 3 + ["BAR.SYNC.DEFER_BLOCKING 0x0"]
            + ["FADD R2, R2, R3"] * 40 + ["LDS R4, [R5]"] * 20 + ["IMAD R6, R6, R7, R8"] * 10
            + ["BAR.SYNC.DEFER_BLOCKING 0x0"] + ["FMUL R2, R2, R3"] * 16 + ["STG.E [R8.64], R2"] * 8)
    body.append(f"BRA 0x{16:x}")
    text = _sass("24diffusion3d_steps_kernelILi2EfE", body)
    segs = tune_stencil.sass_hand(text, "float32", 2)
    assert [s["segment"] for s in segs] == ["land", "sweep0", "sweep1"]
    assert [s["cells_per_thread"] for s in segs] == [12, 10, 8]
    assert segs[1]["per_cell"]["fp32"] == 4.0 and segs[1]["per_cell"]["shared"] == 2.0
    assert segs[1]["per_cell"]["integer"] == 1.0 and segs[2]["per_cell"]["stores"] == 1.0
    # the pair layout's loop: 2 word stores and a 2-byte edge store, 17 packed operations a word
    pairs = (["MOV R0, R1"] + ["HFMA2.BF16_V2 R2, R2, R3, -RZ"] * 34 + ["PRMT R4, R4, 0x5432, R5"] * 4
             + ["STG.E [R8.64], R2"] * 2 + ["STG.E.U16 [R8.64], R2"] + [f"BRA 0x{16:x}"])
    text = (_sass("18diffusion3d_kernelILb0E13__nv_bfloat16E", ["STG.E.U16 [R8.64], R2",
                                                             "BRA 0x0"])
            + _sass("24diffusion3d_pairs_kernelILb0E13__nv_bfloat16E", pairs))
    rows = {r["segment"]: r for r in tune_stencil.sass_hand(text, "bfloat16", 1)}
    assert rows["pairs"]["cells_per_thread"] == 4
    assert rows["pairs"]["per_cell"]["packed"] == 8.5 and rows["pairs"]["per_cell"]["moves"] == 1.0
