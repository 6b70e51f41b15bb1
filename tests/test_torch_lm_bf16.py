"""The port's LM kernels with bf16 inputs, on the CPU, against the JAX
package: each kernel's module at bf16 against the reference's Pallas kernel
(interpret mode), the bf16 instances of the CUDA sources through the
rehearsal, the Zamba2 smoke slice (prefill and a training step) on the
reference's bf16 weights, the interop of bf16 trees, and the dtype rule of
the kernels' arguments.

The reference's kernels take bf16 as storage: they load, compute in f32 and
round once on store. So does the port: the plain versions compute in f32,
and each CUDA source's bf16 instance converts on load and rounds on store
around the f32 instance's arithmetic, so that it is bit for bit that
instance on the upcast inputs, rounded.

Tolerances. A kernel's bf16 output against the reference's at bf16: the f32
tolerance of ``test_torch_lm_kernels.py`` (conv1d rtol 1e-5 / atol 1e-6,
attention 1e-5 / 1e-6, SSD 1e-4 / 1e-5) plus one bf16 ulp of the larger of
the two values (the two f32 results may straddle a rounding boundary);
SSD's h_final stays f32 and takes the f32 tolerance. The slice: prefill
logits (|logit| up to about 3) within atol 0.1 of the reference's, and
within twice the f32 control, the distance between the reference's bf16
and f32 runs on the same weights (about 0.03 both: the two stacks round
their bf16 products and sums in other places, as bf16 rounds against f32);
a training step's loss within rtol 2e-3 (about 3e-4 here; the f32 control,
the reference's loss at bf16 against f32 on the same weights, about 2e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.kernels import ops as r_ops
from repro.models import RunConfig as RRunConfig, build as r_build
from repro_torch import configs, interop
from repro_torch.kernels import args, attention, conv1d, rehearse, ssd
from repro_torch.launch import train as t_train
from repro_torch.models import RunConfig, build
from repro_torch.optim import adamw

from conftest import SEED
from torch_jax_compile import compiled

BF16 = torch.bfloat16
CONV_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
SSD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGITS_ATOL = 0.1
LOSS_RTOL = 2e-3


def _bf(rng, *shape, scale=1.0):
    """bf16 values from a numpy seed: (the port's tensor, the reference's array)."""
    t = torch.tensor((rng.randn(*shape) * scale).astype(np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |v| (8 significant bits)."""
    m = v.abs().float()
    return torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7),
                       torch.full_like(m, 2.0 ** -133))


def _pallas(fn, *args):
    """The reference's ``fn`` (its Pallas kernel in interpret mode) on
    ``args``, compiled through torch_jax_compile."""
    return compiled(fn, *args)(*args)


def _within_ulp(got, want, rtol, atol):
    got = got.float()
    want = torch.tensor(np.asarray(want, dtype=np.float32))
    bound = atol + rtol * want.abs() + _ulp(torch.maximum(got.abs(), want.abs()))
    bad = (got - want).abs() > bound
    assert not bool(bad.any()), (float((got - want).abs().max()), int(bad.sum()))


# --------------------------------------------------------------------------
# each kernel's module at bf16 against the reference's Pallas kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,C,K,silu,bias", [(2, 19, 13, 4, True, True),    # C % 4 != 0
                                               (1, 16, 16, 3, False, False)])
def test_conv1d_bf16_matches_pallas(B, L, C, K, silu, bias, rng):
    (x, jx), (w, jw) = _bf(rng, B, L, C), _bf(rng, K, C, scale=K ** -0.5)
    b, jb = _bf(rng, C, scale=0.1) if bias else (None, None)
    want = _pallas(lambda x, w, b: r_ops.conv1d_causal(x, w, b, silu=silu, impl="pallas"),
                   jx, jw, jb)
    got = conv1d.conv1d_causal(x, w, b, silu=silu)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(got, want.astype(jnp.float32), **CONV_TOL)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,with_h0", [
    (2, 40, 4, 8, 2, 16, 16, True),       # G = 2, L not a multiple of the chunk
])
def test_ssd_bf16_matches_pallas(B, L, H, P, G, N, chunk, with_h0, rng):
    (x, jx) = _bf(rng, B, L, H, P, scale=0.5)
    (Bm, jB), (Cm, jC) = _bf(rng, B, L, G, N, scale=0.3), _bf(rng, B, L, G, N, scale=0.3)
    dt = (np.abs(rng.randn(B, L, H)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rng.rand(H)) - 0.1).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    h0 = (rng.randn(B, H, P, N) * 0.2).astype(np.float32) if with_h0 else None
    want, hw = _pallas(lambda x, dt, A, Bm, Cm, D, h0: r_ops.ssd(
        x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk, impl="pallas"),
        jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D),
        None if h0 is None else jnp.asarray(h0))
    got, h = ssd.ssd_chunk_scan(x, torch.tensor(dt), torch.tensor(A), Bm, Cm,
                                D=torch.tensor(D), h0=None if h0 is None else torch.tensor(h0),
                                chunk=chunk)
    assert got.dtype == BF16 and h.dtype == torch.float32
    _within_ulp(got, want.astype(jnp.float32), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), **SSD_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [(1, 4, 2, 24, 32, True, 9),   # GQA
                                                        (1, 2, 2, 20, 16, False, None)])
def test_attention_bf16_matches_pallas(B, Hq, Hkv, L, D, causal, window, rng):
    (q, jq), (k, jk), (v, jv) = (_bf(rng, B, h, L, D) for h in (Hq, Hkv, Hkv))
    want = _pallas(lambda q, k, v: r_ops.attention(q, k, v, causal=causal, window=window,
                                                   impl="pallas"), jq, jk, jv)
    got = attention.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == BF16
    _within_ulp(got, want.astype(jnp.float32), **ATTN_TOL)


# --------------------------------------------------------------------------
# the bf16 instances of the CUDA sources through the rehearsal
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rehearsed():
    """Both instances of the four rehearsed sources compiled together (one
    g++ each), as the rehearsal then loads them."""
    rehearse.compile_lm([(n, bf16) for n in rehearse.LM_REHEARSED for bf16 in (False, True)])


def _same(a, b):
    """a is b rounded to a's dtype (bf16, or b's own), bit for bit."""
    assert a.dtype in (BF16, b.dtype)
    assert torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("B,L,C,K,silu,bias", [(1, 24, 264, 4, True, True),   # vec 4
                                               (1, 37, 301, 3, False, False)])  # vec 1
def test_rehearsed_conv1d_bf16_is_f32_rounded(rehearsed, B, L, C, K, silu, bias, rng):
    (x, _), (w, _), (g, _) = _bf(rng, B, L, C), _bf(rng, K, C, scale=K ** -0.5), \
        _bf(rng, B, L, C)
    b = _bf(rng, C, scale=0.1)[0] if bias else None
    up = [None if t is None else t.float() for t in (x, w, b, g)]
    out = rehearse.conv1d(x, w, b, silu)
    assert conv1d.layout(B, L, C, K, x, out)[0] == (4 if C % 4 == 0 else 1)
    _same(out, rehearse.conv1d(*up[:3], silu))
    torch.testing.assert_close(out, conv1d.plain(x, w, b, silu), rtol=0, atol=0)
    for a, f in zip(rehearse.conv1d_bwd(g, x, w, b, silu),
                    rehearse.conv1d_bwd(up[3], *up[:3], silu)):
        if a is not None:
            _same(a, f)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,h0,dhf", [(1, 40, 2, 6, 1, 10, 16, True, True),
                                                      (1, 50, 4, 16, 2, 17, 32, False, False)])
def test_rehearsed_ssd_bwd_bf16_is_f32_rounded(rehearsed, B, L, H, P, G, N, chunk, h0, dhf,
                                               rng):
    (x, _), (dy, _) = _bf(rng, B, L, H, P, scale=0.5), _bf(rng, B, L, H, P)
    (Bm, _), (Cm, _) = _bf(rng, B, L, G, N, scale=0.3), _bf(rng, B, L, G, N, scale=0.3)
    dt = torch.tensor((np.abs(rng.randn(B, L, H)) * 0.05 + 0.001).astype(np.float32))
    A = torch.tensor((-rng.rand(H) * 15 - 1).astype(np.float32))
    D = torch.tensor((rng.rand(H) + 0.5).astype(np.float32))
    kw = dict(D=D, chunk=chunk,
              h0=torch.tensor((rng.randn(B, H, P, N) * 0.2).astype(np.float32)) if h0 else None,
              dh_final=torch.tensor(rng.randn(B, H, P, N).astype(np.float32)) if dhf else None)
    got = rehearse.ssd_bwd(x, dt, A, Bm, Cm, dy, **kw)
    want = rehearse.ssd_bwd(x.float(), dt, A, Bm.float(), Cm.float(), dy.float(), **kw)
    for name in ("dx", "dB", "dC"):
        assert got[name].dtype == BF16
    for name, t in got.items():
        if t is not None:
            _same(t, want[name])


@pytest.mark.parametrize("B,Hq,Hkv,L,D,causal,window", [(1, 4, 2, 33, 16, True, 7),
                                                        (1, 2, 1, 20, 64, False, None)])
def test_rehearsed_attention_bwd_bf16_is_f32_rounded(rehearsed, B, Hq, Hkv, L, D, causal,
                                                     window, rng):
    from repro_torch.kernels import ref

    (q, _), (k, _), (v, _), (g, _) = (_bf(rng, B, h, L, D) for h in (Hq, Hkv, Hkv, Hq))
    # the forward's output before rounding, which the backward reads (out32)
    out = ref.attention(q.float(), k.float(), v.float(), causal=causal, window=window)
    kw = dict(causal=causal, window=window, out=out,
              lse=ref.attention_lse(q, k, causal=causal, window=window))
    got = rehearse.attention_bwd(q, k, v, g, **kw)
    want = rehearse.attention_bwd(q.float(), k.float(), v.float(), g.float(), **kw)
    for a, f in zip(got, want):
        assert a.dtype == BF16
        _same(a, f)


# --------------------------------------------------------------------------
# the slice: Zamba2's smoke config on the reference's bf16 weights
# --------------------------------------------------------------------------
def _r_rc(dtype):
    return RRunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False, loss_chunk=32,
                      attn_q_chunk=32, attn_k_chunk=32)


@pytest.fixture(scope="module")
def zamba():
    """The smoke config, the reference's bf16 weights (its init), a prompt
    and a training batch, and the reference's prefill logits and loss on
    them at bf16 and, on the weights upcast, at f32 (the control): one
    compiled program."""
    from repro.data import tokens as r_tokens

    rcfg = r_configs.get_smoke("zamba2-1.2b")
    key = jax.random.PRNGKey(0)
    toks = jnp.asarray(np.random.RandomState(SEED).randint(0, rcfg.vocab, size=(2, 16)),
                       jnp.int32)
    src = r_tokens.make_source(r_tokens.DataConfig(vocab=rcfg.vocab, seq_len=32,
                                                   global_batch=2))
    batch = {k: jnp.asarray(v) for k, v in src.batch(0).items()}
    m16, m32 = r_build(rcfg, _r_rc("bfloat16")), r_build(rcfg, _r_rc("float32"))

    def reference(key, toks, batch):
        p16 = m16.init(key)[0]
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
        return p16, {"logits": [m16.prefill(p16, {"tokens": toks}, 16)[0],
                                m32.prefill(p32, {"tokens": toks}, 16)[0]],
                     "loss": [m16.loss_fn(p16, batch), m32.loss_fn(p32, batch)]}

    rparams, out = compiled(reference, key, toks, batch)(key, toks, batch)
    return rcfg, rparams, np.asarray(toks), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                         out)


def test_zamba2_bf16_prefill_matches_reference(zamba):
    rcfg, rparams, toks, want = zamba
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    tmodel = build(configs.get_smoke("zamba2-1.2b"), RunConfig(param_dtype="bfloat16"),
                   device="cpu")
    got, _ = tmodel.prefill(tparams, {"tokens": torch.tensor(toks).long()}, 16)
    got = got.float().numpy()
    ref16, ref32 = want["logits"]
    err = float(np.abs(got - ref16).max())
    control = float(np.abs(ref16 - ref32).max())
    assert np.isfinite(got).all() and got.shape == (2, rcfg.vocab)
    assert err <= LOGITS_ATOL and err <= 2 * control, (err, control)


def test_zamba2_bf16_training_step_matches_reference(zamba):
    """A step of train() with bf16 parameters, from the reference's bf16
    weights: its loss against the reference's loss at bf16 on the same
    batch (the f32 control: the reference's at f32 on the weights upcast),
    and the step's update through the f32 master, which the parameters are
    rounded from."""
    rcfg, rparams, _, ref = zamba
    loop = t_train.TrainLoopConfig(steps=1, seq_len=32, global_batch=2, log_every=100)
    rc = dataclasses.replace(t_train.default_run_config(loop), param_dtype="bfloat16")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    before = [t.clone() for t in adamw.leaves(tparams)]
    tp, ts, got = t_train.train("zamba2-1.2b", loop, rc=rc, smoke=True, device="cpu",
                                params=tparams, log_fn=lambda *a: None)
    for p, m, b in zip(adamw.leaves(tp), adamw.leaves(ts["master"]), before):
        assert p.dtype == b.dtype and m.dtype == torch.float32
        assert torch.equal(p, m.to(p.dtype))
    assert any(p.dtype == BF16 and not torch.equal(p, b)
               for p, b in zip(adamw.leaves(tp), before))
    want, want32 = (float(v) for v in ref["loss"])
    err, control = abs(got[0] - want) / abs(want), abs(want - want32) / abs(want32)
    assert err <= LOSS_RTOL, (got, want, want32, control)


def test_run_config_compute_dtype_is_the_reference_default_or_param_dtype():
    """compute_dtype is read nowhere, in the port as in the reference: it
    takes the reference's default or param_dtype, so a reference
    RunConfig's value carries across, and refuses any other value."""
    for r in (RRunConfig(), RRunConfig(param_dtype="float32"),
              RRunConfig(param_dtype="float32", compute_dtype="float32")):
        rc = RunConfig(param_dtype=r.param_dtype, compute_dtype=r.compute_dtype)
        assert (rc.param_dtype, rc.compute_dtype) == (r.param_dtype, r.compute_dtype)
    assert RunConfig().compute_dtype == RRunConfig().compute_dtype == "bfloat16"
    for pd, cd in (("bfloat16", "float32"), ("float32", "float16"), ("bfloat16", "float16")):
        with pytest.raises(ValueError, match="compute_dtype.*read nowhere"):
            RunConfig(param_dtype=pd, compute_dtype=cd)


# --------------------------------------------------------------------------
# interop of bf16 trees, and the dtype rule of the kernels' arguments
# --------------------------------------------------------------------------
def test_interop_carries_bf16_trees_exactly(rng):
    a = (rng.randn(3, 5) * 7).astype(ml_dtypes.bfloat16)
    tree = {"w": a, "inner": {"b": np.arange(4, dtype=np.float32), "h": a[:2]}}
    got = interop.params_from_numpy(tree, device="cpu")
    assert got["w"].dtype == BF16 and got["inner"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), a.view(np.int16))
    cache = interop.cache_from_numpy(tree, device="cpu")
    back = interop.cache_to_numpy(cache)
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], a.astype(np.float32))
    np.testing.assert_array_equal(back["inner"]["h"].astype(ml_dtypes.bfloat16), a[:2])
    state = interop.opt_state_from_numpy({"master": {"w": a.astype(np.float32)}, "m": tree},
                                         device="cpu")
    assert state["m"]["w"].dtype == BF16 and state["master"]["w"].dtype == torch.float32


def test_storage_dtype_rule():
    f32, bf = torch.float32, BF16
    assert args.storage_dtype("k", {"x": bf, "w": bf, "dt": f32}, ["dt"]) == bf
    assert args.storage_dtype("k", {"x": f32, "dt": f32}, ["dt"]) == f32
    with pytest.raises(TypeError, match="share one dtype"):
        args.storage_dtype("conv1d", {"x": bf, "w": f32})
    with pytest.raises(TypeError, match="float16.*reference's kernels take it.*ROADMAP"):
        args.storage_dtype("attention", {"q": torch.float16, "k": torch.float16})
    with pytest.raises(TypeError, match="'dt' is torch.bfloat16.*float32"):
        args.storage_dtype("ssd", {"x": bf, "dt": bf}, ["dt"])
    with pytest.raises(TypeError, match="float64"):
        args.storage_dtype("ssd", {"x": torch.float64})
    assert set(ssd.F32_ARGS) >= {"dt", "A", "D", "h0", "states"}
