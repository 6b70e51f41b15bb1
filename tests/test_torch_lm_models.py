"""The port's Zamba2 serving slice on the CPU, against the JAX package: the
numerics (rms_norm, RoPE), the attention and Mamba2 layers, and the whole
hybrid model's prefill and decode with the reference's weights carried
across (``interop.params_from_numpy``), then ``serve`` against the
reference's ``serve``.

The JAX side reaches its Pallas kernels as its own tests do: layer and
model tests run it with ``impl="pallas"`` (interpret mode here) and
``impl="chunked"``; the port runs its CPU path (each kernel's plain
version) and ``impl="ref"``.

Tolerances (f32): rms_norm and RoPE rtol 1e-5 / atol 1e-6 (a few rounded
operations); a layer rtol 1e-5 / atol 1e-5 (two projections around a
kernel); the SSM state and the whole model's logits and cache rtol 1e-4 /
atol 1e-4 (several layers of matmuls summed in another order, and the SSD
recurrence).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import serve as r_serve
from repro.models import RunConfig as RRunConfig, build as r_build, synth_batch as r_synth
from repro.models import common as r_cm, layers as r_ly, ssm as r_ssm
from repro.models import config as r_config
from repro_torch import configs, interop
from repro_torch.kernels import attention, conv1d, ssd
from repro_torch.launch import profile_serve, serve as t_serve
from repro_torch.models import RunConfig, build, common as cm, layers as ly, ssm as t_ssm
from repro_torch.models import config as t_config, smoke_variant

NUM_TOL = dict(rtol=1e-5, atol=1e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

R_RC = {impl: RRunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                         attn_impl=impl, ssd_impl=impl, conv_impl=impl)
        for impl in ("pallas", "chunked")}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


# --------------------------------------------------------------------------
# config and registry
# --------------------------------------------------------------------------
def test_config_matches_reference():
    cfg = configs.get_arch("zamba2-1.2b")
    rcfg = r_configs.get_arch("zamba2-1.2b")

    def fields(c):
        return dataclasses.asdict(dataclasses.replace(c, notes=""))

    assert fields(cfg) == fields(rcfg)
    assert fields(configs.get_smoke("zamba2-1.2b")) == \
        fields(r_configs.get_smoke("zamba2-1.2b"))
    assert t_config.SMOKE_OVERRIDES == r_config.SMOKE_OVERRIDES
    assert configs.ARCH_IDS == r_configs.ARCH_IDS and len(configs.ARCH_IDS) == 10
    with pytest.raises(ValueError, match="impl"):
        RunConfig(ssd_impl="chunked")


def test_unported_family_raises():
    odd = dataclasses.replace(configs.get_smoke("zamba2-1.2b"), family="retnet")
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        build(odd, device="cpu")


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
def test_rms_norm_and_rope_match_reference(rng):
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    s = rng.randn(16).astype(np.float32)
    _close(cm.rms_norm(torch.tensor(x), torch.tensor(s)),
           r_cm.rms_norm(jnp.asarray(x), jnp.asarray(s)), NUM_TOL)
    pos = rng.randint(0, 500, size=(2, 1, 7))
    got = cm.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    want = r_cm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(got, want, NUM_TOL)
    # interleaved pairs: position 1 rotates (x0, x1) by the first frequency
    e = torch.zeros(1, 1, 4)
    e[..., 0] = 1.0
    r = cm.apply_rope(e, torch.ones(1, 1, dtype=torch.long))
    assert torch.allclose(r[0, 0, :2], torch.tensor([np.cos(1.0), np.sin(1.0)]).float())
    z = rng.randn(50).astype(np.float32) * 30
    _close(cm.softplus(torch.tensor(z)), jax.nn.softplus(jnp.asarray(z)), NUM_TOL)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def _attn_case(rng, window, extras):
    cfg_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                  qkv_bias=extras, qk_norm=extras)
    rp, _ = r_cm.split(r_ly.attn_init(jax.random.PRNGKey(3), r_ly.AttnCfg(**cfg_kw),
                                      jnp.float32))
    return r_ly.AttnCfg(**cfg_kw), ly.AttnCfg(**cfg_kw), rp, \
        interop.params_from_numpy(_np_tree(rp), device="cpu")


# the JAX side's Pallas kernel (interpret mode) is slow to build here: the
# window and the extras go through its chunked path (the kernel tests hold
# the Pallas kernel with windows)
@pytest.mark.parametrize("window,extras,impls", [(None, False, ("pallas", "chunked")),
                                                 (5, False, ("chunked",)),
                                                 (None, True, ("chunked",))])
def test_attn_apply_and_decode_match_reference(window, extras, impls, rng):
    rcfg, tcfg, rp, tp = _attn_case(rng, window, extras)
    assert ("bq" in tp and "q_norm" in tp) == extras
    L, S = 12, 16
    x = (rng.randn(2, L, 32) * 0.5).astype(np.float32)
    for impl in impls:
        want, (wk, wv) = r_ly.attn_apply(rp, jnp.asarray(x), rcfg, attn_impl=impl)
        for timpl in ("cuda", "ref"):
            got, (gk, gv) = ly.attn_apply(tp, torch.tensor(x), tcfg, attn_impl=timpl)
            _close(got, want, LAYER_TOL, f"{impl}/{timpl}")
            _close(gk, wk, LAYER_TOL)
            _close(gv, wv, LAYER_TOL)
    kc = np.pad(np.asarray(wk), ((0, 0), (0, 0), (0, S - L), (0, 0)))
    vc = np.pad(np.asarray(wv), ((0, 0), (0, 0), (0, S - L), (0, 0)))
    xt = (rng.randn(2, 1, 32) * 0.5).astype(np.float32)
    want, (wkc, wvc) = r_ly.attn_decode(rp, jnp.asarray(xt), rcfg, jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(L, jnp.int32))
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    got, (gkc, gvc) = ly.attn_decode(tp, torch.tensor(xt), tcfg, tk, tv, L)
    _close(got, want, LAYER_TOL)
    _close(gkc, wkc, LAYER_TOL)
    _close(gvc, wvc, LAYER_TOL)
    assert gkc is tk                                # the cache is written in place


def _ssm_case(G=1):
    rcfg = r_ssm.SSMCfg(d_model=32, d_state=8, head_dim=8, n_groups=G, chunk=8)
    tcfg = t_ssm.SSMCfg(d_model=32, d_state=8, head_dim=8, n_groups=G, chunk=8)
    rp, _ = r_cm.split(r_ssm.ssm_init(jax.random.PRNGKey(5), rcfg, jnp.float32))
    return rcfg, tcfg, rp, interop.params_from_numpy(_np_tree(rp), device="cpu")


@pytest.mark.parametrize("L,G,impl", [(12, 1, "pallas"), (20, 2, "chunked"),
                                      (2, 1, "chunked")])   # L = 2 < K - 1 = 3
def test_ssm_apply_with_state_and_decode_match_reference(L, G, impl, rng):
    rcfg, tcfg, rp, tp = _ssm_case(G)
    h = (rng.randn(2, L, 32) * 0.5).astype(np.float32)
    want, wst = r_ssm.ssm_apply(rp, jnp.asarray(h), rcfg, ssd_impl=impl, conv_impl=impl,
                                return_state=True)
    for timpl in ("cuda", "ref"):
        got, gst = t_ssm.ssm_apply(tp, torch.tensor(h), tcfg, ssd_impl=timpl,
                                   conv_impl=timpl, return_state=True)
        _close(got, want, LAYER_TOL, f"{impl}/{timpl}")
        _close(gst["conv"], wst["conv"], LAYER_TOL)
        _close(gst["ssm"], wst["ssm"], MODEL_TOL)
    assert gst["conv"].shape == (2, tcfg.d_conv - 1, tcfg.d_conv_in)
    if L < tcfg.d_conv - 1:
        assert torch.all(gst["conv"][:, :tcfg.d_conv - 1 - L] == 0)
    xt = (rng.randn(2, 1, 32) * 0.5).astype(np.float32)
    want, wdec = r_ssm.ssm_decode(rp, jnp.asarray(xt), rcfg, wst)
    got, gdec = t_ssm.ssm_decode(tp, torch.tensor(xt), tcfg, gst)
    _close(got, want, LAYER_TOL)
    _close(gdec["conv"], wdec["conv"], LAYER_TOL)
    _close(gdec["ssm"], wdec["ssm"], MODEL_TOL)


# --------------------------------------------------------------------------
# the slice as a whole: Zamba2 prefill + decode
# --------------------------------------------------------------------------
def _zamba(variant):
    cfg = r_configs.get_smoke("zamba2-1.2b")
    if variant == "tail":
        cfg = dataclasses.replace(cfg, n_layers=5)    # 2 groups of 2 and a tail of 1
    return cfg


@pytest.mark.parametrize("variant,impl", [("smoke", "pallas"), ("tail", "chunked")])
def test_zamba2_prefill_and_decode_match_reference(variant, impl, rng):
    rcfg = _zamba(variant)
    tcfg = t_config.ArchConfig(**dataclasses.asdict(rcfg))
    L, n_dec = 10, 3
    max_seq = L + n_dec
    toks = rng.randint(0, rcfg.vocab, size=(2, L + n_dec)).astype(np.int32)
    rmodel = r_build(rcfg, R_RC[impl])
    rparams, _ = rmodel.init(jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np_tree(rparams), device="cpu")
    if variant == "tail":
        assert tparams["mamba"]["ssm"]["in_proj"].shape[:2] == (2, 2)
        assert tparams["mamba_tail"]["ssm"]["in_proj"].shape[0] == 1
    else:
        assert "mamba_tail" not in tparams
    rlog, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks[:, :L])}, max_seq)
    tmodel = build(tcfg, RunConfig(param_dtype="float32"), device="cpu")
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.tensor(toks[:, :L]).long()},
                                  max_seq)
    rlog_ref, _ = build(tcfg, RunConfig(param_dtype="float32", attn_impl="ref",
                                        ssd_impl="ref", conv_impl="ref"),
                        device="cpu").prefill(tparams,
                                              {"tokens": torch.tensor(toks[:, :L]).long()},
                                              max_seq)
    _close(tlog, rlog, MODEL_TOL)
    _close(rlog_ref, rlog, MODEL_TOL)
    for n in ("conv", "ssm", "k", "v"):
        assert tuple(tcache[n].shape) == rcache[n].shape, n
        _close(tcache[n], rcache[n], MODEL_TOL, n)
    for i in range(n_dec):
        tok = toks[:, L + i]
        rlog, rcache = rmodel.decode_step(rparams, jnp.asarray(tok), rcache,
                                          jnp.asarray(L + i, jnp.int32))
        tlog, tcache = tmodel.decode_step(tparams, torch.tensor(tok).long(), tcache, L + i)
        _close(tlog, rlog, MODEL_TOL, f"decode {i}")
    back = interop.cache_to_numpy(tcache)
    for n in ("conv", "ssm", "k", "v"):
        _close(back[n], rcache[n], MODEL_TOL, n)


@pytest.mark.parametrize("variant", ["smoke", "tail"])
def test_prefill_then_decode_equals_full_forward(variant, rng):
    """The serving invariant within the port: prefill over t_0..t_{n-1} and
    a decode of t_n give the last logits of a prefill over t_0..t_n."""
    tcfg = t_config.ArchConfig(**dataclasses.asdict(_zamba(variant)))
    model = build(tcfg, RunConfig(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L = 12
    toks = torch.tensor(rng.randint(0, tcfg.vocab, size=(2, L + 1)))
    full, _ = model.prefill(params, {"tokens": toks}, max_seq=L + 1)
    part, cache = model.prefill(params, {"tokens": toks[:, :L]}, max_seq=L + 1)
    dec, _ = model.decode_step(params, toks[:, L], cache, L)
    torch.testing.assert_close(dec, full, **MODEL_TOL)
    assert torch.isfinite(full).all()


def test_port_init_follows_reference_distributions():
    tcfg = configs.get_smoke("zamba2-1.2b")
    params = build(tcfg, RunConfig(param_dtype="float32"), device="cpu").init(
        torch.Generator().manual_seed(1))
    rparams, _ = r_build(r_configs.get_smoke("zamba2-1.2b"), R_RC["chunked"]).init(
        jax.random.PRNGKey(1))
    flat_t = dict(_flatten(params))
    flat_r = dict(_flatten(_np_tree(rparams)))
    assert flat_t.keys() == flat_r.keys()
    for k, t in flat_t.items():
        assert tuple(t.shape) == flat_r[k].shape and t.dtype == torch.float32, k
    # dt = softplus(dt_bias) is log-uniform in [1e-3, 1e-1]; A = -exp(A_log) in [-16, -1]
    dt = cm.softplus(flat_t["mamba/ssm/dt_bias"])
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    A = torch.exp(flat_t["mamba/ssm/A_log"])
    assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0
    s = float(flat_t["mamba/ssm/in_proj"].std()) * tcfg.d_model ** 0.5
    assert 0.9 < s < 1.1


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_serve_gives_the_reference_serve_tokens():
    """The port's serve, fed the weights and prompt the reference's serve
    draws, generates the same greedy tokens; the CPU path launches no
    kernel."""
    scfg = r_serve.ServeConfig(batch=2, prompt_len=12, gen_len=6)
    want, _ = r_serve.serve("zamba2-1.2b", scfg, smoke=True, log_fn=lambda *a: None)
    rmodel = r_build(r_configs.get_smoke("zamba2-1.2b"),
                     RRunConfig(param_dtype="float32", remat=False))
    rparams, _ = rmodel.init(jax.random.PRNGKey(scfg.seed))
    toks = r_synth(rmodel, jax.random.PRNGKey(scfg.seed + 1), scfg.prompt_len, scfg.batch,
                   mode="prefill")["tokens"]
    before = (conv1d.launches, ssd.launches, attention.launches)
    got, info = t_serve.serve(
        "zamba2-1.2b", t_serve.ServeConfig(batch=2, prompt_len=12, gen_len=6), smoke=True,
        device="cpu", params=interop.params_from_numpy(_np_tree(rparams), device="cpu"),
        tokens=np.asarray(toks), log_fn=lambda *a: None)
    assert (conv1d.launches, ssd.launches, attention.launches) == before
    np.testing.assert_array_equal(got, np.asarray(want))
    assert info["prefill_logits"].shape == (2, 256) and info["tok_per_s"] > 0


def test_serve_draws_its_own_weights_and_samples_with_temperature():
    scfg = t_serve.ServeConfig(batch=2, prompt_len=5, gen_len=4, temperature=0.8, seed=3)
    a, _ = t_serve.serve("zamba2-1.2b", scfg, smoke=True, device="cpu", log_fn=lambda *x: None)
    b, _ = t_serve.serve("zamba2-1.2b", scfg, smoke=True, device="cpu", log_fn=lambda *x: None)
    assert a.shape == (2, 4) and np.array_equal(a, b)      # seeded generators
    assert a.min() >= 0 and a.max() < 256
    # no --arch: forwards to the simulation server's demo (repro_torch.serve)
    assert t_serve.main(["--device", "cpu", "--demo", "--n", "8", "--requests", "2"]) == 0
    assert smoke_variant(configs.get_arch("zamba2-1.2b")).n_layers == 2


def test_cache_round_trip(rng):
    cache = {n: rng.randn(2, 3, 4).astype(np.float32) for n in ("conv", "ssm", "k", "v")}
    t = interop.cache_from_numpy(cache, device="cpu")
    back = interop.cache_to_numpy(t)
    for n, a in cache.items():
        np.testing.assert_array_equal(back[n], a)
    t["k"][0, 0, 0] = 7.0
    assert cache["k"][0, 0, 0] != 7.0


def test_profile_serve_runs_its_phases_on_the_cpu():
    out = profile_serve.profile("zamba2-1.2b", 2, 8, 2, "cuda", smoke=True, device="cpu")
    assert out["device"] == "cpu" and out["prefill_ms"] > 0 and out["decode_step_ms"] > 0
    # no device number from a CPU run
    assert out["prefill_trace"]["device_ms"] == 0 and out["prefill_trace"]["busy_share"] is None
    for name in ("void (anonymous namespace)::ssd_states_kernel(float*)",
                 "void (anonymous namespace)::ssd_output_kernel(float*)",
                 "void (anonymous namespace)::attention_kernel<64>(float*)"):
        assert profile_serve._kind(name) == "port kernels"
    assert profile_serve._kind("sm90_xmma_gemm_f32f32") == "matrix products"
