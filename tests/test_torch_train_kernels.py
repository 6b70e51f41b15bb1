"""The LM kernels' backward passes on the CPU: each backward kernel's plain
version (``ref.{conv1d,ssd,attention}_bwd``, ``torch.autograd.grad``
through the plain forward) against ``jax.grad`` of the reference's chunked
op, each hand-written backward source (``csrc/*_bwd.cu``) rehearsed through
``kernels/rehearse.py`` against those plain gradients at small odd shapes,
the forward's log-sum-exp, the autograd Functions' plumbing on CPU tensors
(where each wrapper runs its plain version), and ``ops``' routing.

Inputs come from a numpy seed. Tolerances (f32): the plain gradients
against JAX's rtol 1e-4 / atol 1e-5 (autograd and XLA sum the same
products in other orders); the rehearsed kernels against the plain
gradients rtol 1e-4 / atol 1e-5 relative to the case's largest gradient
(the kernels walk the recurrence or the key tiles in their own order, and
the SSD kernel's dla is a suffix sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.kernels import attention, conv1d, ops, ref, rehearse, ssd

from torch_jax_compile import compiled

PLAIN_TOL = dict(rtol=1e-4, atol=1e-5)
REHEARSE_RTOL, REHEARSE_ATOL = 1e-4, 1e-5


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _close_scaled(got, want, what=""):
    """Each part within REHEARSE_RTOL and REHEARSE_ATOL x the case's largest
    |want|."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want if np.asarray(w).size)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=REHEARSE_RTOL,
                                   atol=REHEARSE_ATOL * scale, err_msg=f"{what} part {i}")


# --------------------------------------------------------------------------
# conv1d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,C,K,silu,bias", [(2, 33, 8, 4, True, True),
                                                (1, 5, 7, 3, False, True),
                                                (2, 20, 6, 1, True, False)])
def test_conv1d_bwd_plain_matches_jax_grad(B, L, C, K, silu, bias, rng):
    x, w = rng.randn(B, L, C).astype(np.float32), rng.randn(K, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32) if bias else None
    g = rng.randn(B, L, C).astype(np.float32)

    def f(x, w, *b):
        out = r_ops.conv1d_causal(x, w, b[0] if b else None, silu=silu, impl="chunked")
        return jnp.sum(out * g)

    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]
    want = compiled(jax.grad(f, argnums=tuple(range(len(args)))), *args)(*args)
    got = ref.conv1d_bwd(_t(g), _t(x), _t(w), _t(b), silu)
    assert (got[2] is None) == (b is None)
    for gt, wt in zip([t for t in got if t is not None], want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **PLAIN_TOL)


@pytest.mark.parametrize("B,L,C,K,silu", [(2, 70, 37, 4, True), (1, 5, 130, 3, False),
                                          (1, 130, 5, 8, True), (3, 9, 3, 1, True)])
def test_conv1d_bwd_kernel_rehearsed(B, L, C, K, silu, rng):
    """csrc/conv1d_bwd.cu on the CPU: tiles of 16 positions (L = 70, 130
    end inside one; L = 5, 9 in the first), the ends of its instances' K
    range, C not a multiple of 4 (4-byte copies; the 16-byte ones, every
    tile and the other edges: tests/test_torch_conv1d_tiles.py)."""
    x, w = rng.randn(B, L, C).astype(np.float32), rng.randn(K, C).astype(np.float32)
    b, g = rng.randn(C).astype(np.float32), rng.randn(B, L, C).astype(np.float32)
    got = rehearse.conv1d_bwd(_t(g), _t(x), _t(w), _t(b), silu)
    want = ref.conv1d_bwd(_t(g), _t(x), _t(w), _t(b), silu)
    _close_scaled(got, want, "conv1d_bwd")
    again = rehearse.conv1d_bwd(_t(g), _t(x), _t(w), _t(b), silu)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------
def _ssd_case(rng, B, L, H, P, G, N, with_h0, with_dhf):
    x = (rng.randn(B, L, H, P) * 0.5).astype(np.float32)
    dt = (np.abs(rng.randn(B, L, H)) * 0.05 + 0.01).astype(np.float32)
    A = (-rng.rand(H) * 4 - 0.5).astype(np.float32)
    Bm = (rng.randn(B, L, G, N) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, L, G, N) * 0.3).astype(np.float32)
    D = (rng.rand(H) + 0.5).astype(np.float32)
    h0 = (rng.randn(B, H, P, N) * 0.2).astype(np.float32) if with_h0 else None
    dy = rng.randn(B, L, H, P).astype(np.float32)
    dhf = rng.randn(B, H, P, N).astype(np.float32) if with_dhf else None
    return x, dt, A, Bm, Cm, D, h0, dy, dhf


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,with_h0,with_dhf", [
    (1, 32, 2, 4, 1, 8, 8, True, True),
    (2, 24, 4, 6, 2, 5, 16, False, True),
    (1, 20, 4, 8, 4, 8, 64, True, False)])
def test_ssd_bwd_plain_matches_jax_grad(B, L, H, P, G, N, chunk, with_h0, with_dhf, rng):
    x, dt, A, Bm, Cm, D, h0, dy, dhf = _ssd_case(rng, B, L, H, P, G, N, with_h0, with_dhf)
    names = ["x", "dt", "A", "B", "C", "D"] + (["h0"] if with_h0 else [])
    given = [x, dt, A, Bm, Cm, D] + ([h0] if with_h0 else [])

    def f(*a):
        y, h = r_ops.ssd(*a[:5], D=a[5], h0=a[6] if with_h0 else None, chunk=chunk,
                         impl="chunked")
        loss = jnp.sum(y * dy)
        return loss + (jnp.sum(h * dhf) if with_dhf else 0.0)

    given = [jnp.asarray(a) for a in given]
    want = compiled(jax.grad(f, argnums=tuple(range(len(given)))), *given)(*given)
    got = ref.ssd_bwd(*map(_t, (x, dt, A, Bm, Cm, dy)), D=_t(D), h0=_t(h0), dh_final=_t(dhf),
                      chunk=ssd.pick_chunk(L, chunk))
    assert (got["dh0"] is None) == (not with_h0)
    for n, w in zip(names, want):
        np.testing.assert_allclose(got[f"d{n}"].numpy(), np.asarray(w), err_msg=n,
                                   **PLAIN_TOL)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,with_h0,with_dhf", [
    (1, 20, 2, 6, 1, 10, 8, True, True),      # P, N not multiples of 4
    (2, 37, 4, 5, 2, 7, 16, False, False),    # G < H, a short last chunk
    (1, 33, 2, 40, 1, 70, 64, True, True),    # two row tiles of 16, N over 64
    (1, 19, 4, 16, 2, 16, 4, True, False),
    (1, 150, 2, 8, 1, 64, 64, True, True),    # three chunks, the last of 22 steps, N 64
    (1, 24, 4, 72, 2, 12, 8, True, True),     # P over 64: two p tiles
    (1, 136, 4, 4, 1, 8, 4, False, True)])    # 136 blocks: a head a block, four slices
def test_ssd_bwd_kernel_rehearsed(B, L, H, P, G, N, chunk, with_h0, with_dhf, rng):
    """csrc/ssd_bwd.cu on the CPU from the plain recurrence's chunk-start
    states at the forward kernel's chunk plan."""
    x, dt, A, Bm, Cm, D, h0, dy, dhf = _ssd_case(rng, B, L, H, P, G, N, with_h0, with_dhf)
    t = [_t(a) for a in (x, dt, A, Bm, Cm, dy)]
    got = rehearse.ssd_bwd(*t, D=_t(D), h0=_t(h0), dh_final=_t(dhf), chunk=chunk)
    want = ref.ssd_bwd(*t, D=_t(D), h0=_t(h0), dh_final=_t(dhf),
                       chunk=ssd.pick_chunk(L, chunk))
    keys = [k for k in want if want[k] is not None]
    assert [k for k in got if got[k] is not None] == keys
    _close_scaled([got[k] for k in keys], [want[k] for k in keys], "ssd_bwd")


# (B, L, H, P, G, N, chunk): chip_smoke.py's TRAIN_CASE_SHAPES["ssd"] and two more
SSD_BWD_SHAPES = [(1, 40, 2, 6, 1, 10, 16), (1, 1000, 8, 64, 2, 64, 64),
                  (2, 100, 4, 36, 2, 128, 64), (1, 65, 4, 16, 4, 17, 32),
                  (4, 1024, 64, 64, 1, 64, 64), (4, 128, 24, 64, 1, 128, 64),
                  (1, 7, 3, 5, 3, 10, 64), (1, 136, 4, 4, 1, 8, 4)]


def test_ssd_bwd_scratch_and_rows_match_the_c_source():
    """ssd.py's scratch size, heads a block and shared memory are
    csrc/ssd_bwd.cu's own."""
    import ctypes
    lib = rehearse.lm_library(ssd.BWD_SOURCE, "ssd_bwd", ssd.bwd_smem_floats(ssd.MAX_N_BWD))
    lib.work_floats.restype, lib.work_floats.argtypes = ctypes.c_int64, [ctypes.c_int64] * 7
    lib.heads_per_block.restype = ctypes.c_int
    lib.heads_per_block.argtypes = [ctypes.c_int64] * 5
    lib.chunk_smem.restype, lib.chunk_smem.argtypes = ctypes.c_int64, [ctypes.c_int64]
    for (B, L, H, P, G, N, chunk) in SSD_BWD_SHAPES:
        cs, _ = ssd.plan(L, chunk)
        assert lib.heads_per_block(B, L, H, G, cs) == ssd.bwd_heads_per_block(B, L, H, G, chunk)
        assert lib.work_floats(B, L, H, P, G, N, cs) == ssd.bwd_work_floats(B, L, H, P, G, N,
                                                                             chunk)
    for N in range(1, ssd.MAX_N_BWD + 1):
        assert lib.chunk_smem(N) == ssd.bwd_smem_floats(N)
        assert 4 * ssd.bwd_smem_floats(N) <= ssd.MAX_SMEM


def test_ssd_bwd_scratch_is_below_the_step_walks():
    """At every shape chip_smoke checks, the chunked backward's scratch is
    at most the step-walk design's (per-step, per-row-tile parts of dB and
    dC, of e and dy·(h C); row tiles of 32 state rows, 16 above N = 64)."""
    for (B, L, H, P, G, N, chunk) in SSD_BWD_SHAPES[:6]:
        nt = -(-P // (32 if N <= 64 else 16))
        walks = 2 * B * L * H * nt * N + 2 * B * L * H * nt + 2 * B * H * nt + 2 * B * H
        assert ssd.bwd_work_floats(B, L, H, P, G, N, chunk) <= walks, (B, L, H, P, G, N)


def test_ssd_bwd_heads_per_block():
    """A call of fewer blocks than SMs folds whole groups in a block (no
    slices to fold); a large one keeps four blocks an SM."""
    assert ssd.bwd_heads_per_block(1, 40, 2, 1, 16) == 2
    assert ssd.bwd_heads_per_block(4, 1024, 64, 1, 64) == 4      # 1024 blocks
    assert ssd.bwd_heads_per_block(4, 128, 24, 1, 64) == 1       # 192 blocks
    assert ssd.bwd_heads_per_block(1, 65, 4, 4, 32) == 1         # a head a group


def test_ssd_bwd_kernel_rehearsed_against_jax_grad(rng):
    """The rehearsed csrc/ssd_bwd.cu against the reference's own gradient:
    jax.value_and_grad of _ssd_chunked_jnp (B and C repeated to the heads
    inside, so their gradients sum over each group's heads)."""
    from repro.kernels.ops import _ssd_chunked_jnp
    B, L, H, P, G, N, chunk = 1, 48, 4, 8, 2, 16, 16
    x, dt, A, Bm, Cm, D, h0, dy, dhf = _ssd_case(rng, B, L, H, P, G, N, True, True)

    def loss(x, dt, A, Bm, Cm, D, h0):
        rep = H // G
        y, h = _ssd_chunked_jnp(x, dt, A, jnp.repeat(Bm, rep, axis=2),
                                jnp.repeat(Cm, rep, axis=2), D, h0, chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dhf)

    given = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D, h0)]
    _, want = compiled(jax.value_and_grad(loss, argnums=tuple(range(7))), *given)(*given)
    got = rehearse.ssd_bwd(*map(_t, (x, dt, A, Bm, Cm, dy)), D=_t(D), h0=_t(h0),
                           dh_final=_t(dhf), chunk=chunk)
    names = ["dx", "ddt", "dA", "dB", "dC", "dD", "dh0"]
    _close_scaled([got[n] for n in names], want, "ssd_bwd against jax")


def test_ssd_states_are_the_chunk_starts():
    """ref.ssd_states: the chunked forward's states at each chunk start and
    its final state."""
    rng = np.random.RandomState(3)
    x, dt, A, Bm, Cm, _, h0, _, _ = _ssd_case(rng, 2, 21, 2, 4, 1, 6, True, False)
    t = [_t(a) for a in (x, dt, A, Bm, Cm)]
    states, h = ref.ssd_states(*t, h0=_t(h0), chunk=8)
    assert states.shape == (2, 3, 2, 4, 6)
    for c, start in enumerate((0, 8, 16)):
        head = [a if a.dim() == 1 else a[:, :start] for a in t]
        want = _t(h0) if start == 0 else ref.ssd(*head, h0=_t(h0), chunk=start)[1]
        torch.testing.assert_close(states[:, c], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(h, ref.ssd(*t, h0=_t(h0), chunk=21)[1], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [
    (1, 4, 2, 33, 16, True, None), (2, 2, 2, 17, 16, False, None),
    (1, 4, 1, 24, 32, True, 5)])
def test_attention_bwd_plain_matches_jax_grad(B, Hq, Hkv, L, D, causal, window, rng):
    q = rng.randn(B, Hq, L, D).astype(np.float32)
    k, v = (rng.randn(B, Hkv, L, D).astype(np.float32) for _ in range(2))
    g = rng.randn(B, Hq, L, D).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(r_ops.attention(q, k, v, causal=causal, window=window, impl="chunked",
                                       q_chunk=8, k_chunk=8) * g)

    qkv = [jnp.asarray(a) for a in (q, k, v)]
    want = compiled(jax.grad(f, argnums=(0, 1, 2)), *qkv)(*qkv)
    got = ref.attention_bwd(_t(q), _t(k), _t(v), _t(g), causal=causal, window=window)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **PLAIN_TOL)


def test_attention_plain_gradient_of_a_row_with_no_key_is_zero():
    """window 0 leaves no key: the plain gradient is 0, not NaN."""
    q, k, v, g = (torch.randn(1, 2, 9, 16) for _ in range(4))
    for t in ref.attention_bwd(q, k, v, g, causal=True, window=0):
        assert torch.equal(t, torch.zeros_like(t))
    lse = ref.attention_lse(q, k, causal=True, window=0)
    assert bool(torch.isneginf(lse).all())


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [
    (1, 2, 1, 37, 16, True, None),    # a key tile past L, GQA rep 2
    (1, 4, 1, 40, 32, True, 7),       # rep 4, window
    (2, 2, 2, 33, 16, False, None),   # non-causal
    (1, 2, 2, 5, 48, True, 0),        # no key at all
    (1, 1, 1, 1, 16, True, None),     # L = 1
    (1, 2, 1, 65, 80, True, 70),      # a window past L
    (1, 4, 2, 70, 128, True, 20)])    # D 128: 16-row inner tiles, GQA, a window
def test_attention_bwd_kernel_rehearsed(B, Hq, Hkv, L, D, causal, window, rng):
    """csrc/attention_bwd.cu on the CPU (shared memory NaN before each
    block) from the plain forward's output and log-sum-exp."""
    q = _t(rng.randn(B, Hq, L, D).astype(np.float32))
    k, v = (_t(rng.randn(B, Hkv, L, D).astype(np.float32)) for _ in range(2))
    g = _t(rng.randn(B, Hq, L, D).astype(np.float32))
    got = rehearse.attention_bwd(q, k, v, g, causal=causal, window=window)
    want = ref.attention_bwd(q, k, v, g, causal=causal, window=window)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    if window == 0:
        assert all(torch.equal(t, torch.zeros_like(t)) for t in got)
    _close_scaled(got, want, "attention_bwd")


def test_attention_bwd_kernel_rehearsed_against_jax_grad(rng):
    """The rehearsed csrc/attention_bwd.cu against the reference's own
    gradient: jax.value_and_grad of _chunked_attention (GQA, a window)."""
    from repro.kernels.ops import _chunked_attention
    B, Hq, Hkv, L, D, window = 1, 4, 2, 40, 32, 9
    q = rng.randn(B, Hq, L, D).astype(np.float32)
    k, v = (rng.randn(B, Hkv, L, D).astype(np.float32) for _ in range(2))
    g = rng.randn(B, Hq, L, D).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(_chunked_attention(q, k, v, True, window, None, 8, 8) * g)

    qkv = [jnp.asarray(a) for a in (q, k, v)]
    _, want = compiled(jax.value_and_grad(loss, argnums=(0, 1, 2)), *qkv)(*qkv)
    got = rehearse.attention_bwd(_t(q), _t(k), _t(v), _t(g), causal=True, window=window)
    _close_scaled(got, want, "attention_bwd against jax")


def test_attention_bwd_shared_memory_matches_the_c_source():
    import ctypes
    lib = rehearse.lm_library(attention.BWD_SOURCE, "attention_bwd",
                              max(map(attention.bwd_smem_floats, attention.HEAD_DIMS)))
    lib.bwd_smem_floats.restype, lib.bwd_smem_floats.argtypes = ctypes.c_int64, [ctypes.c_int64]
    for D in attention.HEAD_DIMS:
        assert lib.bwd_smem_floats(D) == attention.bwd_smem_floats(D)
        assert 4 * attention.bwd_smem_floats(D) <= 232448


def test_mma_tf32_emulation_is_ptx_layout():
    """The rehearsal's mma.sync.m16n8k8 on known operands: each lane's D
    fragment is A·B + C at PTX's positions (group g = lane / 4, t = lane % 4:
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1
    (t + 4, g); c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1)). Small
    integers are TF32 values and the sums exact, so a misplaced element
    shows as a difference."""
    A = np.arange(16 * 8, dtype=np.float32).reshape(16, 8) % 13 - 6
    Bk = np.arange(8 * 8, dtype=np.float32).reshape(8, 8) % 7 - 3
    C = np.arange(16 * 8, dtype=np.float32).reshape(16, 8) * 10
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    a = np.stack([A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4]], 1)
    b = np.stack([Bk[t, g], Bk[t + 4, g]], 1)
    c = np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]], 1)
    d = rehearse.mma_tf32_lanes(_t(a), _t(b), _t(c)).numpy()
    Dm = A @ Bk + C
    want = np.stack([Dm[g, 2 * t], Dm[g, 2 * t + 1], Dm[g + 8, 2 * t], Dm[g + 8, 2 * t + 1]], 1)
    np.testing.assert_array_equal(d, want)


def test_attention_lse_is_the_logsumexp_of_the_scores(rng):
    """The forward's log-sum-exp (plain version) is each row's logsumexp
    of its allowed scaled scores; with ``return_lse`` on CPU tensors the
    wrapper returns it beside the output."""
    q, k, v = (_t(rng.randn(1, 2, 12, 16).astype(np.float32)) for _ in range(3))
    out, lse = attention.flash_attention(q, k, v, causal=True, window=4, return_lse=True)
    torch.testing.assert_close(out, ref.attention(q, k, v, causal=True, window=4))
    s = np.einsum("bhqd,bhkd->bhqk", q.numpy(), k.numpy()) / 4.0
    i = np.arange(12)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 4)
    m = np.where(ok, s, -np.inf)
    want = np.log(np.sum(np.exp(m - m.max(-1, keepdims=True)), -1)) + m.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the autograd Functions and ops' routing
# --------------------------------------------------------------------------
def _grads(fn, inputs, seed):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return torch.autograd.grad(loss, leaves)


def test_functions_give_the_plain_gradients_on_cpu(rng):
    """Each Function on CPU tensors runs the plain forward and, in its
    backward, the wrapper's plain backward: the gradients of the plain
    forward differentiated directly, and no launch."""
    before = (conv1d.launches_bwd, ssd.launches_bwd, attention.launches_bwd)
    x, w, b = (_t(rng.randn(*s).astype(np.float32)) for s in ((2, 9, 6), (4, 6), (6,)))
    for s in (True, False):
        got = _grads(lambda x, w, b: conv1d.Conv1dFn.apply(x, w, b, s), (x, w, b), 0)
        want = _grads(lambda x, w, b: conv1d.plain(x, w, b, s), (x, w, b), 0)
        for g, wt in zip(got, want):
            torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-6)
    xs, dt, A, Bm, Cm, D, h0, _, _ = _ssd_case(rng, 1, 12, 2, 4, 1, 5, True, False)
    t = [_t(a) for a in (xs, dt, A, Bm, Cm, D, h0)]
    got = _grads(lambda *a: ssd.SSDFn.apply(*a, 8), t, 1)
    want = _grads(lambda *a: ref.ssd(*a[:5], D=a[5], h0=a[6], chunk=ssd.pick_chunk(12, 8)),
                  t, 1)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-6)
    q, k, v = (_t(rng.randn(1, 2, 10, 16).astype(np.float32)) for _ in range(3))
    got = _grads(lambda q, k, v: attention.AttentionFn.apply(q, k, v, True, 3, None),
                 (q, k, v), 2)
    want = _grads(lambda q, k, v: ref.attention(q, k, v, causal=True, window=3), (q, k, v), 2)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-6)
    assert (conv1d.launches_bwd, ssd.launches_bwd, attention.launches_bwd) == before


def test_ops_differentiate_the_plain_forward_on_cpu():
    """On CPU tensors ``ops`` does not wrap the call in a Function: the
    graph is the plain version's own."""
    q = torch.randn(1, 2, 6, 16, requires_grad=True)
    out = ops.attention(q, q.detach(), q.detach(), impl="cuda")
    assert "AttentionFn" not in type(out.grad_fn).__name__
    x = torch.randn(1, 6, 4, requires_grad=True)
    out = ops.conv1d_causal(x, torch.randn(2, 4), silu=True, impl="cuda")
    assert "Conv1dFn" not in type(out.grad_fn).__name__
    assert not ops._kernel_grad(torch.randn(2, device="meta"))
    assert ops._kernel_grad(torch.randn(2, device="meta", requires_grad=True))
    with torch.no_grad():
        assert not ops._kernel_grad(torch.randn(2, device="meta", requires_grad=True))


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    """Refused before any launch (``meta`` tensors): nothing falls back to
    the plain gradients."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="K <= 8"):
        conv1d.conv1d_causal_bwd(*(torch.zeros(1, 8, 4, **m) for _ in range(2)),
                                 torch.zeros(9, 4, **m))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv1d.conv1d_causal_bwd(*(torch.zeros(1, 8, 4, **m) for _ in range(2)),
                                 torch.zeros(4, 4, **m))
    args = [torch.zeros(s, **m) for s in ((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 1, 130),
                                          (1, 8, 1, 130), (1, 8, 2, 4))]
    with pytest.raises(ValueError, match="N <= 128"):
        ssd.ssd_chunk_scan_bwd(*args, states=torch.zeros(1, 1, 2, 4, 130, **m))
    with pytest.raises(ValueError, match="chunk-start states"):
        ssd.ssd_chunk_scan_bwd(*args)
    with pytest.raises(ValueError, match="head dim 24"):
        attention.flash_attention_bwd(*(torch.zeros(1, 2, 8, 24, **m) for _ in range(5)),
                                      torch.zeros(1, 2, 8, **m))
