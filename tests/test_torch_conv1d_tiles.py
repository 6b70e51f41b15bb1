"""The tiled conv1d kernels (``csrc/conv1d.cu``, ``csrc/conv1d_bwd.cu``) on the
CPU, through ``kernels/rehearse.py``: the wrapper's layout (channels a
thread, positions a block), the sources' refusal of any other, their shared
memory beside the wrapper's, and both kernels at the tile edges: C not a
multiple of 4 and a view one f32 off its allocation's start (4-byte copies),
L not a multiple of the tile and L < K, K = 1 and 8, each tile of
``conv1d.TILES``, with and without bias and SiLU.

Inputs come from a numpy seed. Tolerances (f32): the forward bitwise to the
plain version without SiLU (the same taps summed in the same order, each
multiply and add rounded on its own); with SiLU within SILU_ULPS ulp (the
host's expf against PyTorch's CPU sigmoid; on the card the two agree bit for
bit, chip_smoke.py); against the JAX package's Pallas kernel in interpret
mode rtol 1e-5 / atol 1e-6, as tests/test_torch_lm_kernels.py. The backward
within rtol 1e-4 / atol 1e-5 of the case's largest gradient (the plain
version sums dw and dbias in autograd's order) and bitwise the same on two
calls.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.kernels import conv1d, ref, rehearse

SILU_ULPS = 4
REHEARSE_RTOL, REHEARSE_ATOL = 1e-4, 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _off(t):
    """A copy of ``t`` one f32 past a 16-byte line: contiguous, misaligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    return buf[1:].view(t.shape).copy_(t)


def _case(rng, B, L, C, K, bias=True):
    x = rng.randn(B, L, C).astype(np.float32)
    w = (rng.randn(K, C) * K ** -0.5).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32) if bias else None
    return x, w, b


def _ulps(got, want):
    """|got - want| in units of the last place of |want|."""
    spacing = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    return float(((got - want).abs() / spacing).max())


# (B, L, C, K): C a multiple of 128 and not, of 4 and not; L a multiple of the
# tile and not, below K; K = 1, 3, 4, 8
EDGES = [(2, 70, 36, 4), (1, 37, 128, 3), (2, 2, 132, 4), (1, 50, 13, 1), (1, 19, 8, 8),
         (3, 64, 260, 2)]


@pytest.fixture(params=conv1d.TILES, ids=lambda t: f"tile{t}")
def tile(request, monkeypatch):
    """Every layout takes this tile (the wrapper picks it by the card's
    blocks; these shapes are too small to reach the larger ones)."""
    monkeypatch.setattr(conv1d, "TILES", (request.param,))
    return request.param


@pytest.mark.parametrize("B,L,C,K", EDGES)
@pytest.mark.parametrize("silu,bias", [(False, True), (True, True), (True, False)])
def test_conv1d_kernel_rehearsed(B, L, C, K, silu, bias, tile, rng):
    x, w, b = map(lambda a: None if a is None else _t(a), _case(rng, B, L, C, K, bias))
    got = rehearse.conv1d(x, w, b, silu)
    want = conv1d.plain(x, w, b, silu)
    if silu:
        assert _ulps(got, want) <= SILU_ULPS
    else:
        assert torch.equal(got, want)
        assert torch.equal(got, ref.conv1d_causal(x, w, b))


@pytest.mark.parametrize("silu", [False, True])
def test_conv1d_kernel_misaligned_and_generic(silu, rng):
    """A view one f32 off a 16-byte line and C a multiple of 4 take the
    4-byte copies; K = 9 the generic kernel."""
    x, w, b = map(_t, _case(rng, 2, 70, 300, 4))
    xo = _off(x)
    assert conv1d.layout(2, 70, 300, 4, xo)[0] == 1 and conv1d.layout(2, 70, 300, 4, x)[0] == 4
    got, want = rehearse.conv1d(xo, w, b, silu), conv1d.plain(x, w, b, silu)
    assert torch.equal(got, want) if not silu else _ulps(got, want) <= SILU_ULPS
    x, w, b = map(_t, _case(rng, 1, 50, 24, 9))
    got, want = rehearse.conv1d(x, w, b, silu), conv1d.plain(x, w, b, silu)
    assert torch.equal(got, want) if not silu else _ulps(got, want) <= SILU_ULPS


def test_conv1d_kernel_matches_pallas(rng):
    """The rehearsed forward against the JAX package's Pallas kernel
    (interpret mode) at an odd shape, SiLU and bias."""
    x, w, b = _case(rng, 2, 45, 20, 4)
    want = np.asarray(r_ops.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          silu=True, impl="pallas"))
    got = rehearse.conv1d(_t(x), _t(w), _t(b), True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,L,C,K", EDGES)
@pytest.mark.parametrize("silu,bias", [(True, True), (False, False)])
def test_conv1d_bwd_kernel_tiles_rehearsed(B, L, C, K, silu, bias, tile, rng):
    x, w, b = map(lambda a: None if a is None else _t(a), _case(rng, B, L, C, K, bias))
    g = _t(rng.randn(B, L, C).astype(np.float32))
    got = rehearse.conv1d_bwd(g, x, w, b, silu)
    want = ref.conv1d_bwd(g, x, w, b, silu)
    assert (got[2] is None) == (b is None)
    got, want = [t for t in got if t is not None], [t for t in want if t is not None]
    scale = max(float(t.abs().max()) for t in want)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=REHEARSE_RTOL, atol=REHEARSE_ATOL * scale)
    again = rehearse.conv1d_bwd(g, x, w, b, silu)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_conv1d_bwd_kernel_misaligned(rng):
    x, w, b = map(_t, _case(rng, 2, 70, 300, 4))
    g = _t(rng.randn(2, 70, 300).astype(np.float32))
    assert conv1d.layout(2, 70, 300, 4, _off(g), x)[0] == 1
    got = rehearse.conv1d_bwd(_off(g), _off(x), w, b, True)
    want = ref.conv1d_bwd(g, x, w, b, True)
    scale = max(float(t.abs().max()) for t in want)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=REHEARSE_RTOL, atol=REHEARSE_ATOL * scale)


def test_layout_at_the_main_paths_shapes():
    """16-byte copies at Zamba2's and mamba2-130m's widths; tiles of 32
    positions where the grid still has 16 blocks an SM of the H100 (Zamba2's
    4224 channels), else 16 (mamba2-130m's 1792, prefill and training)."""
    x = torch.empty(16)
    assert conv1d.layout(4, 1024, 4224, 4, x) == (4, 32)        # 4224 blocks
    assert conv1d.layout(4, 1024, 1792, 4, x) == (4, 16)        # 3584
    assert conv1d.layout(4, 128, 1792, 4, x) == (4, 16)         # 448
    assert conv1d.layout(4, 1024, 1790, 4, x) == (1, 32)        # C not a multiple of 4
    assert conv1d.layout(4, 1024, 1792, 9, x) == (1, 32)        # the generic kernel
    assert conv1d.layout_name(4, 1024, 4224, 4, 32) == "v4/t32/32x33x4"


def _source_lib(bwd):
    """The source compiled as its rehearsal compiles it."""
    path, name, smem = ((conv1d.BWD_SOURCE, "conv1d_bwd", conv1d.bwd_smem_floats) if bwd else
                        (conv1d.SOURCE, "conv1d", conv1d.smem_floats))
    lib = rehearse.lm_library(path, name, smem(conv1d.MAX_K, 4, conv1d.MAX_TILE))
    lib.rehearse_inputs(0, None, None)
    return lib


@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_sources_refuse_other_layouts_and_share_the_smem_sizes(bwd):
    """Each source's entry point refuses a layout the wrapper would not
    pick (vec 4 at C not a multiple of 4 or a misaligned pointer, a tile not
    in TILES, K above the backward's instances); its shared memory a block
    (``smem_floats``) is the wrapper's."""
    lib = _source_lib(bwd)
    argtypes = conv1d._BWD_ARGTYPES if bwd else conv1d._ARGTYPES
    lib.launch.argtypes, lib.launch.restype = list(argtypes), ctypes.c_int
    x = torch.zeros(2, 8, 12)
    w, b = torch.zeros(4, 12), torch.zeros(12)

    def launch(vec, tile, C=12, K=4, off=0):
        if bwd:
            (dx, dw, db), args, part = conv1d.bwd_arguments(x, x, w, b, False)
            args = args[:4] + (args[4] + off,) + args[5:8] + (2, 8, C, K, vec, tile, 0)
        else:
            out, args = conv1d.fwd_arguments(x, w, b, False)
            args = (args[0], args[1] + off) + args[2:4] + (2, 8, C, K, vec, tile, 0)
        return lib.launch(*args, None)

    assert launch(4, 16) == 0 and launch(1, 32) == 0
    assert launch(4, 16, C=10) != 0          # C not a multiple of 4
    assert launch(4, 16, off=4) != 0         # 4 bytes off a 16-byte line
    assert launch(2, 16) != 0 and launch(4, 64) != 0
    assert (launch(1, 16, K=9) != 0) == bwd  # the forward's generic kernel
    fn = lib.smem_floats
    fn.argtypes, fn.restype = [ctypes.c_int64] * 3, ctypes.c_int64
    mine = conv1d.bwd_smem_floats if bwd else conv1d.smem_floats
    for K in range(1, conv1d.MAX_K + 1):
        for vec in (1, 4):
            for t in conv1d.TILES:
                assert fn(K, vec, t) == mine(K, vec, t), (K, vec, t)
