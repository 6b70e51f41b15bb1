"""bf16 and f16 kernels' printed CUDA C++, run on the CPU.

``repro_torch.kernels.rehearse`` stands in for CUDA's bf16 and f16 types and
conversions with integer arithmetic on their bits, so its own conversions
are held first, bitwise, to PyTorch's on a sweep of f32 bit patterns: every
bf16 and f16 value, the midpoints between neighbours and the words one
above and below them (the ties of round to nearest even), ±0, f32 and f16
subnormals, the f16 overflow edge at 65520, inf, NaN and 2^20 random words.
A NaN must stay a NaN (PyTorch's own payloads differ between its scalar and
vector paths). Every bf16 and f16 value widens back bitwise. A wrong
conversion would make every rehearsal below lie.

Then each printed kernel at bf16 and f16 (single step, k steps, and the
hand kernel ``csrc/diffusion3d.cu``) must equal its plain version bitwise:
the ``torch`` backend at storage dtype for the generated kernels (max
reductions bitwise, sums within 1e-5), ``ref.diffusion3d_steps`` for the
hand kernel. Shared memory is filled with 0xff bytes before each block, a
NaN as f32, bf16 and f16, so a read of an unwritten queue element shows.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, rehearse

from test_torch_coupled import VARIANTS, _variant, _variant_args
from test_torch_rehearse_steps import _case

LOW = {"bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


def _sweep() -> torch.Tensor:
    """f32 words: every bf16 value and f16 value, the midpoints between
    neighbours of each and the words beside them, edges, random words."""
    u16 = np.arange(1 << 16, dtype=np.int64)
    words = [u16 << 16, (u16 << 16) | 0x8000, ((u16 << 16) | 0x8000) + 1,
             ((u16 << 16) | 0x8000) - 1]
    halves = torch.from_numpy(u16.astype(np.uint16).view(np.int16)).view(torch.float16)
    words.append(halves.float().numpy().view(np.uint32).astype(np.int64))
    finite = halves[: 0x7c00].double().numpy()          # 0 .. 65504, every f16 step
    mid = ((finite[:-1] + finite[1:]) / 2).astype(np.float32).view(np.uint32).astype(np.int64)
    for d in (-1, 0, 1):
        words += [mid + d, (mid + d) | 0x80000000]
    words.append(np.array([0, 0x80000000, 0x7f800000, 0xff800000, 0x7fc00000, 0xffc00001,
                           0x7f800001, 0x477fefff, 0x477ff000, 0x477ff001, 0x47800000,
                           0x33000000, 0x33000001, 0x1, 0x807fffff, 0x7f7fffff],
                          dtype=np.int64))
    words.append(np.random.RandomState(7).randint(0, 1 << 32, size=1 << 20, dtype=np.int64))
    return torch.from_numpy((np.concatenate(words) & 0xffffffff).astype(np.uint32)
                            .view(np.float32))


@pytest.mark.parametrize("tag", list(LOW))
def test_conversion_shims_equal_torch_bitwise(cxx, tag):
    """The one-cell conversions, and the packed ones of the pair layout
    (``__floats2bfloat162_rn``, ``__bfloat1622float2`` and their f16 twins,
    each half converted alone), on the sweep both ways round in each pair:
    NaN, +-inf and the f16 overflow edge included, each half equal to the
    one-cell conversion bit for bit, NaN payloads too."""
    dt = LOW[tag]
    x = _sweep()
    got, want = rehearse.convert(x, dt), x.to(dt)
    nan = torch.isnan(x)
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))
    assert bool(torch.isnan(got[nan]).all())
    every = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16).view(dt)
    wide, want = rehearse.convert(every, dt), every.float()
    nan = torch.isnan(want)
    assert torch.equal(wide[~nan].view(torch.int32), want[~nan].view(torch.int32))
    assert bool(torch.isnan(wide[nan]).all())
    for swept in (x, x.flip(0)):        # every word in both halves of a pair
        assert torch.equal(rehearse.convert(swept, dt, pairs=True).view(torch.int16),
                           rehearse.convert(swept, dt).view(torch.int16))
    for h in (every, every.flip(0)):
        assert torch.equal(rehearse.convert(h, dt, pairs=True).view(torch.int32),
                           rehearse.convert(h, dt).view(torch.int32))


def _assert_same(kern, got, reds, want, want_reds):
    for o in kern.outputs:
        assert got[o].dtype == want[o].dtype
        assert torch.equal(got[o], want[o]), o
    for n, r in kern.reductions.items():
        if r.combine == "max":
            assert float(reds[n]) == float(want_reds[n]), n
        else:
            np.testing.assert_allclose(float(reds[n]), float(want_reds[n]), rtol=1e-5)


def _outs(kern, res):
    res, reds = res if kern.reductions else (res, {})
    return ({kern.outputs[0]: res} if len(kern.outputs) == 1 else res), reds


# every variant of tests/test_torch_coupled.py (the 14 coupled kernels and
# FIG1's three), at a size that puts a face, a ring and a partial tile in
# each block row
SIZES = {"fig1": (9, 10, 33), "porosity": (13, 20), "gp": (7, 8, 9)}
SINGLE = [(n, (11, 10, 35) if n == "gp_fused[none]+mass" else SIZES[v[0]])
          for n, v in VARIANTS.items()]


@pytest.mark.parametrize("name,base", SINGLE)
@pytest.mark.parametrize("tag", list(LOW))
def test_printed_kernel_equals_torch_backend(cxx, name, base, tag, rng):
    kern = _variant(name, base).with_dtype(LOW[tag])
    f, sc = _variant_args(kern, base, rng)
    f = {n: t.to(LOW[tag]) for n, t in f.items()}
    want, want_reds = _outs(kern, kern(**f, **sc))
    call = kern.compiled(**f, **sc)
    assert call.dtype == LOW[tag] and "narrow(" in call.source
    got, reds = rehearse.run(call, f, sc, xc=3)
    _assert_same(kern, got, reds, want, want_reds)


STEPS = [("fig1", 2), ("fig1+4red@interior", 3), ("porosity_fused[neumann]", 2),
         ("porosity_fused[dirichlet]+err", 2), ("porosity_fused[dirichlet]+err@interior", 2),
         ("gp_fused[none]", 2), ("gp_fused[neumann]", 2), ("staggered", 3),
         ("diffuse2d[neumann0]", 3), ("diffuse2d[dirichlet]", 3)]


@pytest.mark.parametrize("name,k", STEPS)
@pytest.mark.parametrize("tag", list(LOW))
def test_printed_k_step_kernel_equals_run_steps(cxx, name, k, tag, rng):
    """Each sweep rounds its outputs through storage before the next reads
    them, so one launch equals k single steps, each of which stores."""
    kern, f, sc = _case(name, rng)
    kern = kern.with_dtype(LOW[tag])
    f = {n: t.to(LOW[tag]) for n, t in f.items()}
    want, want_reds = _outs(kern, kern.run_steps(k, **f, **sc))
    got, reds = rehearse.run(kern.compiled(nsteps=k, **f, **sc), f, sc, xc=3)
    _assert_same(kern, got, reds, want, want_reds)


@pytest.mark.parametrize("shape", [(9, 10, 33), (16, 40, 100)])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("tag", list(LOW))
def test_hand_diffusion3d_source_equals_plain(cxx, shape, k, tag, rng):
    """The hand kernel at the storage dtype, each operation rounding to it:
    k steps in one launch equal k rotated plain steps (T2 a copy of T), and
    the plain version's k-step ring rule (T2 apart from T)."""
    dt = LOW[tag]
    T = torch.tensor(rng.rand(*shape).astype(np.float32)).to(dt)
    Ci = torch.tensor(rng.rand(*shape).astype(np.float32) + 0.5).to(dt)
    # lam and the spacings such that every product rounds (lam = 1 or a power
    # of two would hide a missing rounding)
    args = (0.7, 1e-4, 8.3, 9.1, 10.7)
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = ref.diffusion3d_step(a, b, Ci, *args)
        a, b = b, a
    got = rehearse.diffusion3d_step(T.clone(), T, Ci, *args, nsteps=k, xc=3)
    assert got.dtype == dt and torch.equal(got, b)
    T2 = torch.tensor(rng.rand(*shape).astype(np.float32)).to(dt)
    assert torch.equal(rehearse.diffusion3d_step(T2, T, Ci, *args, nsteps=k),
                       ref.diffusion3d_steps(T2, T, Ci, *args, nsteps=k))


def _operands(dt) -> tuple[torch.Tensor, torch.Tensor]:
    """Operand pairs of every class: each 16-bit value (zeros, subnormals,
    normals, the largest finite values, +-inf, NaN) against 48 others drawn
    from the same words, half of them from the classes' edges."""
    every = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    edges = torch.tensor([0, 1, 2, 0x7f, 0x80, 0x3ff, 0x400, 0x3c00, 0x3f80, 0x7bff, 0x7c00,
                          0x7e00, 0x7f7f, 0x7f80, 0x7fc0, 0x4000, 0x3800, 0x0401, 0x0081,
                          0x5bf8, 0x6000, 0x2400, 0x1c00, 0x4b80], dtype=torch.int32)
    edges = torch.cat([edges, edges | 0x8000]).to(torch.int16)
    rand = torch.randint(-(1 << 15), 1 << 15, (24,), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(torch.int16)
    others = torch.cat([edges, rand])
    a = every.repeat_interleave(others.numel())
    b = others.repeat(every.numel())
    return a.view(dt), b.view(dt)


@pytest.mark.parametrize("op", rehearse.PACKED_OPS)
@pytest.mark.parametrize("tag", list(LOW))
def test_packed_arithmetic_shims_equal_torch_bitwise(cxx, op, tag):
    """The packed 2-byte arithmetic the hand kernel computes with
    (``__hadd2_rn``, ``__hadd2_rn`` of ``__hneg2``, ``__hmul2_rn``), each
    half PyTorch's operation at that dtype (f32 then rounded), NaN as NaN,
    over every operand class in both halves of a pair."""
    dt = LOW[tag]
    a, b = _operands(dt)
    want = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    for x, y, w in ((a, b, want), (b.flip(0), a.flip(0), None)):
        w = {"add": x + y, "sub": x - y, "mul": x * y}[op] if w is None else w
        got = rehearse.packed_op(x, y, op)
        nan = torch.isnan(w)
        assert torch.equal(got[~nan].view(torch.int16), w[~nan].view(torch.int16))
        assert bool(torch.isnan(got[nan]).all())


@pytest.mark.parametrize("tag", list(LOW))
def test_word_move_shims_are_exact(cxx, tag):
    """The pair kernel's z neighbours out of aligned words
    (``__halves2bfloat162`` of ``__high2bfloat16`` and ``__low2bfloat16``,
    and their f16 twins): every 16-bit value moved bit for bit, NaN
    payloads and signed zeros included."""
    dt = LOW[tag]
    h = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    h = torch.cat([h, h.flip(0)]).view(dt)
    below, above = rehearse.word_moves(h)
    bits = h.view(torch.int16)
    assert torch.equal(below.view(torch.int16)[2:-2], bits[1:-3])
    assert torch.equal(above.view(torch.int16)[2:-2], bits[3:-1])
