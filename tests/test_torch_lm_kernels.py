"""The port's LM kernels on the CPU, against the JAX package: the causal
conv1d, the SSD chunk scan, flash attention, and decode's plain attention
and SSD step.

On the CPU each kernel wrapper runs its plain version (the tensors lie
there); the JAX side runs its Pallas kernel as its own tests do
(``impl="pallas"``, interpret mode here) and its ``chunked``/``ref``
paths. The CUDA kernels themselves are held against these plain versions
on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances (f32 throughout): conv1d rtol 1e-5 / atol 1e-6 (K products and
a sigmoid; both sides round each once); attention rtol 1e-5 / atol 1e-6
(one softmax over at most 96 keys, summed in another order); SSD rtol 1e-4
/ atol 1e-5 (up to 80 steps of a recurrence, and the chunked and
sequential forms sum in different orders).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops, ref as r_ref
from repro_torch.kernels import attention, conv1d, ops, ref, ssd

CONV_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
SSD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------------------
# conv1d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,C,K", [(1, 16, 8, 2), (2, 3, 8, 4), (3, 100, 24, 4),
                                     (2, 33, 8, 3), (1, 20, 5, 9)])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_conv1d_matches_pallas_and_oracle(B, L, C, K, silu, bias, rng):
    x = rng.randn(B, L, C).astype(np.float32)
    w = rng.randn(K, C).astype(np.float32)            # asymmetric taps
    b = rng.randn(C).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    want = np.asarray(r_ops.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jb, silu=silu,
                                          impl="pallas"))
    want_chunked = np.asarray(r_ops.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jb,
                                                  silu=silu, impl="chunked"))
    tb = None if b is None else _t(b)
    before = conv1d.launches
    got = conv1d.conv1d_causal(_t(x), _t(w), tb, silu=silu).numpy()
    assert conv1d.launches == before              # the CPU path launches nothing
    np.testing.assert_allclose(got, want, **CONV_TOL)
    np.testing.assert_allclose(got, want_chunked, **CONV_TOL)
    np.testing.assert_array_equal(
        got, ops.conv1d_causal(_t(x), _t(w), tb, silu=silu, impl="ref").numpy())


def test_conv1d_tap_orientation():
    """An impulse at t = 0 comes out as the taps in order: out[t] = w[t]."""
    K, C = 4, 3
    w = torch.arange(1.0, 1.0 + K * C).reshape(K, C)
    x = torch.zeros(1, 6, C)
    x[0, 0] = 1.0
    out = conv1d.conv1d_causal(x, w)
    torch.testing.assert_close(out[0, :K], w, rtol=0, atol=0)
    assert torch.all(out[0, K:] == 0)


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------
def _ssd_inputs(rng, B, L, H, P, G, N, with_h0):
    x = (rng.randn(B, L, H, P) * 0.5).astype(np.float32)
    dt = (np.abs(rng.randn(B, L, H)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rng.rand(H)) - 0.1).astype(np.float32)
    Bm = (rng.randn(B, L, G, N) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, L, G, N) * 0.3).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    h0 = (rng.randn(B, H, P, N) * 0.2).astype(np.float32) if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,with_h0", [
    (1, 32, 2, 4, 1, 8, 8, False),
    (2, 64, 4, 8, 2, 16, 16, True),      # G = 2: two heads per group
    (1, 80, 4, 8, 4, 8, 32, False),      # L not a multiple of the chunk
    (2, 48, 4, 8, 1, 8, 64, True),       # L below the chunk, with h0
])
def test_ssd_matches_pallas_chunked_and_oracle(B, L, H, P, G, N, chunk, with_h0, rng):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(rng, B, L, H, P, G, N, with_h0)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else _t(h0)
    got, h = ssd.ssd_chunk_scan(*map(_t, (x, dt, A, Bm, Cm)), D=_t(D), h0=th0, chunk=chunk)
    want, hw = r_ops.ssd(*j, D=jnp.asarray(D), h0=jh0, chunk=chunk, impl="pallas")
    want, hw = np.asarray(want), np.asarray(hw)
    np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), hw, **SSD_TOL)
    # the chunked plain version at the reference's own chunk choice
    yc, hc = r_ops.ssd(*j, D=jnp.asarray(D), h0=jh0, chunk=chunk, impl="chunked")
    tc, thc = ops.ssd(*map(_t, (x, dt, A, Bm, Cm)), D=_t(D), h0=th0, chunk=chunk, impl="ref")
    np.testing.assert_allclose(tc.numpy(), np.asarray(yc), **SSD_TOL)
    np.testing.assert_allclose(thc.numpy(), np.asarray(hc), **SSD_TOL)
    # the port's sequential oracle (the JAX one is held in the decode test)
    so, sh = ref.ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), D=_t(D), h0=th0)
    np.testing.assert_allclose(so.numpy(), want, **SSD_TOL)
    np.testing.assert_allclose(sh.numpy(), hw, **SSD_TOL)


def test_ssd_chunk_choice_follows_each_reference_path():
    # the TPU kernel halves, the chunked twin takes the largest divisor
    assert ssd.pick_chunk(80, 32) == 16 and ref.pick_divisor(80, 32) == 20
    assert ssd.pick_chunk(1024, 64) == 64 and ssd.pick_chunk(7, 64) == 7
    assert ssd.pick_chunk(100, 64) == 4


def test_ssd_decode_chain_equals_scan(rng):
    B, L, H, P, G, N = 2, 16, 4, 8, 2, 16
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(rng, B, L, H, P, G, N, False)
    want, hw = r_ref.ssd_scan(*[jnp.asarray(a) for a in (x, dt, A, Bm, Cm)],
                              D=jnp.asarray(D))
    Bh = _t(np.repeat(Bm, H // G, axis=2))
    Ch = _t(np.repeat(Cm, H // G, axis=2))
    h = torch.zeros(B, H, P, N)
    outs = []
    for t in range(L):
        y, h = ops.ssd_decode_step(h, _t(x)[:, t], _t(dt)[:, t], _t(A), Bh[:, t], Ch[:, t],
                                   D=_t(D))
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), np.asarray(want), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), **SSD_TOL)
    jy, jh = r_ops.ssd_decode_step(jnp.zeros((B, H, P, N)), jnp.asarray(x[:, 0]),
                                   jnp.asarray(dt[:, 0]), jnp.asarray(A),
                                   jnp.asarray(Bh[:, 0].numpy()), jnp.asarray(Ch[:, 0].numpy()),
                                   D=jnp.asarray(D))
    ty, th = ops.ssd_decode_step(torch.zeros(B, H, P, N), _t(x)[:, 0], _t(dt)[:, 0], _t(A),
                                 Bh[:, 0], Ch[:, 0], D=_t(D))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hkv,L,D", [
    (1, 4, 4, 64, 16),     # MHA
    (2, 4, 2, 96, 16),     # GQA, rep = 2
    (1, 6, 3, 40, 32),     # GQA, rep = 2, L not a power of two
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37), (False, None),
                                           (False, 9)])
def test_attention_matches_pallas_and_oracle(B, Hq, Hkv, L, D, causal, window, rng):
    q = rng.randn(B, Hq, L, D).astype(np.float32)
    k = rng.randn(B, Hkv, L, D).astype(np.float32)
    v = rng.randn(B, Hkv, L, D).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(r_ops.attention(*j, causal=causal, window=window, impl="pallas"))
    want_ref = np.asarray(r_ref.attention(*j, causal=causal, window=window))
    before = attention.launches
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **ATTN_TOL)
    np.testing.assert_array_equal(
        got.numpy(), ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                   impl="ref").numpy())


def test_attention_fully_masked_rows_give_zero(rng):
    q, k, v = (torch.tensor(rng.randn(1, 2, 20, 16).astype(np.float32)) for _ in range(3))
    want = np.asarray(r_ops.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                      causal=True, window=0, impl="pallas"))
    got = attention.flash_attention(q, k, v, causal=True, window=0)
    assert np.all(want == 0) and torch.all(got == 0)


@pytest.mark.parametrize("pos,window", [(10, None), (31, None), (20, 7), (None, None),
                                        (None, 5)])
def test_decode_attention_matches_reference(pos, window, rng):
    B, Hq, Hkv, S, D = 2, 8, 4, 32, 16
    kc = rng.randn(B, Hkv, S, D).astype(np.float32)
    vc = rng.randn(B, Hkv, S, D).astype(np.float32)
    q = rng.randn(B, Hq, D).astype(np.float32)
    jpos = None if pos is None else jnp.asarray(pos)
    want = np.asarray(r_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                             jnp.asarray(vc), pos=jpos, window=window))
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), pos=pos, window=window)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    if pos is not None and window is None:
        # keys after pos are masked: the cache cut at pos gives the same
        cut = ops.decode_attention(_t(q), _t(kc)[:, :, :pos + 1], _t(vc)[:, :, :pos + 1])
        np.testing.assert_allclose(got.numpy(), cut.numpy(), **ATTN_TOL)


def test_ops_reject_an_unknown_impl():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="impl"):
        ops.conv1d_causal(x, torch.zeros(2, 2), impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.attention(torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, 4, 16),
                      torch.zeros(1, 1, 4, 16), impl="chunked")


def test_wrappers_refuse_tensors_off_the_card_and_cpu():
    """A tensor that is neither on the CPU nor on a card (``meta``) is
    refused with the kernel's name; nothing falls back to the plain path."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="conv1d: the CUDA kernel takes CUDA tensors"):
        conv1d.conv1d_causal(torch.zeros(1, 4, 2, **m), torch.zeros(2, 2, **m))
    with pytest.raises(ValueError, match="attention"):
        attention.flash_attention(*(torch.zeros(1, 1, 4, 16, **m) for _ in range(3)))
    with pytest.raises(ValueError, match="ssd"):
        ssd.ssd_chunk_scan(torch.zeros(1, 4, 2, 4, **m), torch.zeros(1, 4, 2, **m),
                           torch.zeros(2, **m), torch.zeros(1, 4, 1, 8, **m),
                           torch.zeros(1, 4, 1, 8, **m))
    assert ssd.smem_bytes(64) < ssd.smem_bytes(256) < ssd.MAX_SMEM < ssd.smem_bytes(512)


def test_ssd_plan_and_shared_memory():
    """The kernels' chunk is ``chunk`` up to 64 steps for every L (a longer
    one runs as 64-step chunks), the last chunk short where it does not
    divide L, so an L that 64 does not divide keeps whole tiles; the output
    kernel's shared memory lets three blocks share an SM at Zamba2's N = 64."""
    assert ssd.plan(1024, 64) == (64, 16)
    assert ssd.plan(1023, 64) == (64, 16)         # pick_chunk would give 1
    assert ssd.plan(1000, 64) == (64, 16)         # pick_chunk would give 8
    assert ssd.plan(7, 64) == (64, 1)
    assert ssd.plan(256, 16) == (16, 16)
    assert ssd.plan(128, 128) == (64, 2)
    assert ssd.plan(96, 96) == (64, 2)            # 64 + a short chunk of 32
    assert ssd.plan(0, 64) == (64, 0)
    assert ssd.smem_bytes(64) == 68096 and 3 * (ssd.smem_bytes(64) + 1024) <= 228 * 1024
    assert ssd.smem_bytes(10) == ssd.smem_bytes(16)   # N is padded to 16


def test_ssd_shared_memory_matches_the_c_source():
    """ssd.py's tile constants and smem_bytes are csrc/ssd.cu's: its
    constants, and its out_smem_bytes expression evaluated here."""
    src = ssd.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    env = {}
    for name in ("kChunk", "kTile", "kLdX"):
        env[name] = eval(consts[name], {}, dict(env))
    assert (env["kChunk"], env["kTile"]) == (ssd.KERNEL_CHUNK, ssd._TILE)
    body = re.search(r"out_smem_bytes\(int npad\) \{\s*return ([^;]+);", src).group(1)
    for N in (1, 10, 16, 64, 100, 256):
        assert eval(body, {}, {**env, "npad": -(-N // 16) * 16}) == ssd.smem_bytes(N), N


def test_wrappers_refuse_shapes_the_kernels_do_not_take():
    """Refused before any tensor reaches the card (``meta`` tensors here)."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="head dim 24"):
        attention.flash_attention(*(torch.zeros(1, 2, 8, 24, **m) for _ in range(3)))
    with pytest.raises(ValueError, match="must divide"):
        attention.flash_attention(torch.zeros(1, 3, 8, 16, **m),
                                  *(torch.zeros(1, 2, 8, 16, **m) for _ in range(2)))
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_chunk_scan(torch.zeros(1, 4, 2, 4, **m), torch.zeros(1, 4, 2, **m),
                           torch.zeros(2, **m), torch.zeros(1, 4, 1, 512, **m),
                           torch.zeros(1, 4, 1, 512, **m))
    with pytest.raises(ValueError, match="groups"):
        ssd.ssd_chunk_scan(torch.zeros(1, 4, 3, 4, **m), torch.zeros(1, 4, 3, **m),
                           torch.zeros(3, **m), torch.zeros(1, 4, 2, 8, **m),
                           torch.zeros(1, 4, 2, 8, **m))
