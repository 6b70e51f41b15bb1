"""The port's serving stacks of the dense, MoE, SSM, VLM and enc-dec
families on the CPU, against the JAX package: the registry, the MoE layer's
routing and drops, every new arch's prefill and decode at its smoke size,
the kernel paths against the reference's Pallas kernels in interpret mode,
the reference's serving invariants, and ``serve`` against the reference's
``serve``.

Weights are the reference's, carried across with
``interop.params_from_numpy``; inputs come from a numpy seed. The reference
runs at f32 (``RunConfig(param_dtype="float32", compute_dtype="float32",
remat=False)``); the port runs its CPU path (each kernel's plain version).

Tolerances (f32), those of ``tests/test_torch_lm_models.py``: a layer rtol
1e-5 / atol 1e-5 (projections around a kernel or an expert product); a
model's logits and caches rtol 1e-4 / atol 1e-4 (several layers of matmuls
summed in another order, and the SSD recurrence).
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
from repro.models import common as r_cm, moe as r_moe
from repro_torch import configs, interop
from repro_torch.kernels import attention, conv1d, ssd
from repro_torch.launch import profile_serve, serve as t_serve
from repro_torch.models import RunConfig, build, moe as t_moe, synth_batch

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

NEW_ARCHS = [a for a in r_configs.ARCH_IDS if a != "zamba2-1.2b"]


def _r_rc(impl, **kw):
    return RRunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                      attn_impl=impl, ssd_impl=impl, conv_impl=impl, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def _fields(c):
    return dataclasses.asdict(c)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_config_and_counts_match_reference(arch):
    cfg, rcfg = configs.get_arch(arch), r_configs.get_arch(arch)
    assert _fields(cfg) == _fields(rcfg)
    assert _fields(configs.get_smoke(arch)) == _fields(r_configs.get_smoke(arch))
    for c, rc in ((cfg, rcfg), (configs.get_smoke(arch), r_configs.get_smoke(arch))):
        assert c.param_count() == rc.param_count()
        assert c.active_param_count() == rc.active_param_count()
        assert (c.attention_free, c.sub_quadratic, c.is_moe) == \
            (rc.attention_free, rc.sub_quadratic, rc.is_moe)
    over = {"n_layers": "8", "window": 16, "qk_norm": "true", "rope_theta": 5}
    assert _fields(configs.apply_overrides(cfg, over)) == \
        _fields(r_configs.apply_overrides(rcfg, over))


def test_registry_shapes_and_cells_match_reference():
    assert configs.ARCH_IDS == r_configs.ARCH_IDS and len(configs.ARCH_IDS) == 10
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in r_configs.SHAPES.items()}
    cells = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why in configs.all_cells()]
    want = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why in r_configs.all_cells()]
    assert cells == want and len(cells) == 40
    assert sum(ok for _, _, ok, _ in cells) == 33    # seven full-attention archs skip 500k
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-2")
    assert RunConfig().capacity_factor == RRunConfig().capacity_factor == 1.25


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_param_count_equals_the_tree(arch):
    """The analytic count against the port's own tree at the smoke size: as
    the reference's sanity bound (test_models.py) for every family, and
    exact for the dense and MoE stacks (the formula leaves out qk_norm's
    two scales)."""
    cfg = configs.get_smoke(arch)
    params = build(cfg, RunConfig(param_dtype="float32"), device="cpu").init(torch.Generator().manual_seed(0))
    actual = sum(t.numel() for t in _leaves(params))
    assert 0.5 < cfg.param_count() / actual < 1.6
    if cfg.family in ("dense", "moe") and not cfg.qk_norm:
        assert cfg.param_count() == actual


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------
def _moe_case(T_rows, cf, E=4, K=2, D=16, F=32, seed=0):
    rcfg = r_moe.MoECfg(d_model=D, d_ff=F, n_experts=E, top_k=K, capacity_factor=cf)
    tcfg = t_moe.MoECfg(d_model=D, d_ff=F, n_experts=E, top_k=K, capacity_factor=cf)
    rp, _ = r_cm.split(r_moe.moe_init(jax.random.PRNGKey(seed), rcfg, jnp.float32))
    return rcfg, tcfg, rp, interop.params_from_numpy(_np_tree(rp), device="cpu")


@pytest.mark.parametrize("B,L,cf,drops", [(2, 10, 1.25, None), (2, 16, 8.0, False),
                                          (4, 8, 0.25, True), (1, 1, 1.25, False)])
def test_moe_apply_matches_reference(B, L, cf, drops, rng):
    rcfg, tcfg, rp, tp = _moe_case(B * L, cf)
    x = rng.randn(B, L, 16).astype(np.float32)
    want, waux = r_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    got, gaux = t_moe.moe_apply(tp, torch.tensor(x), tcfg)
    _close(got, want, LAYER_TOL)
    _close(gaux, waux, LAYER_TOL)
    # the same routing: jax.lax.top_k over the reference's gate
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 16) @ rp["router"], axis=-1)
    _, r_idx = jax.lax.top_k(probs, rcfg.top_k)
    _, _, t_idx = t_moe.route(tp, torch.tensor(x).reshape(-1, 16), tcfg.top_k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))
    cap = t_moe.capacity_of(tcfg, B * L)
    assert cap == int(max(2 * cf * B * L / 4, min(B * L * 2, 8)))
    loads = np.bincount(t_idx.numpy().ravel(), minlength=4)
    if drops is not None:
        # a dropped (token, k) is sent to slot capacity - 1, which the
        # capacity-th token routed there holds: the scatter must accumulate
        assert bool((loads > cap).any()) == drops, (loads, cap)


def test_moe_ties_go_to_the_lower_expert():
    """Equal gate probabilities (a zero token) pick experts 0..K-1, as
    ``jax.lax.top_k`` does."""
    rcfg, tcfg, rp, tp = _moe_case(3, 1.25, E=8, K=3)
    x = np.zeros((1, 3, 16), np.float32)
    _, _, idx = t_moe.route(tp, torch.tensor(x).reshape(-1, 16), 3)
    assert idx.tolist() == [[0, 1, 2]] * 3
    _, r_idx = jax.lax.top_k(jnp.full((3, 8), 0.125), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    want, _ = r_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    got, _ = t_moe.moe_apply(tp, torch.tensor(x), tcfg)
    _close(got, want, LAYER_TOL)


# --------------------------------------------------------------------------
# every new arch, prefill and one decode step
# --------------------------------------------------------------------------
def _inputs(cfg, rng, B, L):
    """(tokens, extras) from numpy: a VLM's L positions are n_patches patch
    embeddings and L - n_patches tokens; an enc-dec's source is source_len
    frames."""
    n_tok = L - cfg.n_patches if cfg.family == "vlm" else L
    toks = rng.randint(0, cfg.vocab, size=(B, n_tok + 1)).astype(np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = (rng.randn(B, cfg.n_patches, cfg.d_model) * 0.02
                                  ).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = (rng.randn(B, cfg.source_len, cfg.d_model) * 0.02
                            ).astype(np.float32)
    return toks, extras


def _prefill_and_decode(arch, impl, rng, L=10, n_dec=1):
    rcfg = r_configs.get_smoke(arch)
    rmodel = r_build(rcfg, _r_rc(impl))
    rparams, _ = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build(configs.get_smoke(arch), RunConfig(param_dtype="float32"), device="cpu")
    tparams = interop.params_from_numpy(_np_tree(rparams), device="cpu")
    toks, extras = _inputs(rcfg, rng, 2, L)
    n_tok = toks.shape[1] - 1
    max_seq = L + n_dec
    rb = {"tokens": jnp.asarray(toks[:, :n_tok]), **{k: jnp.asarray(v) for k, v in extras.items()}}
    tb = {"tokens": torch.tensor(toks[:, :n_tok]).long(),
          **{k: torch.tensor(v) for k, v in extras.items()}}
    rlog, rcache = rmodel.prefill(rparams, rb, max_seq)
    tlog, tcache = tmodel.prefill(tparams, tb, max_seq)
    _close(tlog, rlog, MODEL_TOL, f"{arch} prefill")
    assert sorted(tcache) == sorted(rcache)
    for n in rcache:
        assert tuple(tcache[n].shape) == rcache[n].shape, n
        _close(tcache[n], rcache[n], MODEL_TOL, f"{arch} cache {n}")
    tok = toks[:, n_tok]
    # the reference's cache carried across decodes as the port's own does
    carried = interop.cache_from_numpy(_np_tree(rcache), device="cpu")
    rlog, rcache = rmodel.decode_step(rparams, jnp.asarray(tok), rcache,
                                      jnp.asarray(L, jnp.int32))
    tlog, tcache = tmodel.decode_step(tparams, torch.tensor(tok).long(), tcache, L)
    _close(tlog, rlog, MODEL_TOL, f"{arch} decode")
    clog, _ = tmodel.decode_step(tparams, torch.tensor(tok).long(), carried, L)
    _close(clog, rlog, MODEL_TOL, f"{arch} decode from the carried cache")
    back = interop.cache_to_numpy(tcache)
    for n in rcache:
        _close(back[n], rcache[n], MODEL_TOL, f"{arch} decode cache {n}")
    return tparams


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch, rng):
    tparams = _prefill_and_decode(arch, "chunked", rng)
    cfg = configs.get_smoke(arch)
    if cfg.family == "encdec":
        assert tparams["enc_blocks"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    else:
        assert tparams["blocks"]["attn_norm" if cfg.family != "ssm" else "norm"][
            "scale"].shape[0] == cfg.n_layers


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-130m"])
def test_forward_hidden_and_aux_match_reference(arch, rng):
    """The full-sequence stack (``forward_hidden`` over ``block_apply``)
    and the mean MoE load-balancing aux of its blocks."""
    from repro.models import transformer as r_tf
    from repro_torch.models import transformer as t_tf

    rcfg = r_configs.get_smoke(arch)
    rparams, _ = r_build(rcfg, _r_rc("chunked")).init(jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np_tree(rparams), device="cpu")
    emb = (rng.randn(2, 10, rcfg.d_model) * 0.5).astype(np.float32)
    want, waux = r_tf.forward_hidden(rparams, rcfg, _r_rc("chunked"), jnp.asarray(emb))
    got, gaux = t_tf.forward_hidden(tparams, configs.get_smoke(arch),
                                    RunConfig(param_dtype="float32"), torch.tensor(emb))
    _close(got, want, MODEL_TOL)
    _close(gaux, waux, LAYER_TOL)
    assert (float(gaux) > 0) == configs.get_smoke(arch).is_moe


@pytest.mark.parametrize("arch", ["stablelm-3b", "seamless-m4t-medium", "mamba2-130m"])
def test_kernel_paths_match_reference_pallas(arch, rng):
    """The reference's Pallas kernels in interpret mode: causal attention
    (stablelm), the non-causal encoder and the causal decoder (seamless),
    conv1d and SSD (mamba2-130m)."""
    _prefill_and_decode(arch, "pallas", rng, L=8)


# --------------------------------------------------------------------------
# the reference's serving invariants (tests/test_models.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-130m", "qwen3-32b", "mixtral-8x7b",
                                  "moonshot-v1-16b-a3b", "phi-3-vision-4.2b"])
def test_prefill_then_decode_equals_full_forward(arch, rng):
    """logits(prefill(t_0..t_{n-1})) then decode(t_n) equal the last logits
    of a prefill over t_0..t_n. MoE routing drops depend on the step's token
    count, so the MoE archs run drop-free (capacity_factor 8, as the
    reference's test does)."""
    cfg = configs.get_smoke(arch)
    model = build(cfg, RunConfig(param_dtype="float32", capacity_factor=8.0), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L = 12
    toks, extras = _inputs(cfg, rng, 2, L)
    toks = torch.tensor(toks).long()
    extras = {k: torch.tensor(v) for k, v in extras.items()}
    n = toks.shape[1] - 1
    full, _ = model.prefill(params, {"tokens": toks, **extras}, max_seq=L + 1)
    part, cache = model.prefill(params, {"tokens": toks[:, :n], **extras}, max_seq=L + 1)
    dec, _ = model.decode_step(params, toks[:, n], cache, L)
    torch.testing.assert_close(dec, full, **MODEL_TOL)
    assert torch.isfinite(full).all()


def test_encdec_prefill_decode_consistency(rng):
    cfg = configs.get_smoke("seamless-m4t-medium")
    model = build(cfg, RunConfig(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L = 10
    toks, extras = _inputs(cfg, rng, 2, L)
    toks, frames = torch.tensor(toks).long(), torch.tensor(extras["frames"])
    full, _ = model.prefill(params, {"tokens": toks, "frames": frames}, max_seq=L + 1)
    part, cache = model.prefill(params, {"tokens": toks[:, :L], "frames": frames},
                                max_seq=L + 1)
    assert tuple(cache["mk"].shape) == (cfg.n_dec_layers, 2, cfg.n_kv_heads, cfg.source_len,
                                        cfg.head_dim)
    mk = cache["mk"].clone()
    dec, cache = model.decode_step(params, toks[:, L], cache, L)
    torch.testing.assert_close(dec, full, **MODEL_TOL)
    assert torch.equal(cache["mk"], mk)          # the memory's K/V stay as prefill left them


def test_window_attention_limits_context(rng):
    """One layer with window w: a token farther than w behind the last
    position cannot change the last logits at all; a near one does."""
    cfg = dataclasses.replace(configs.get_smoke("stablelm-3b"), n_layers=1, window=8)
    model = build(cfg, RunConfig(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    L = 24
    toks = torch.tensor(rng.randint(0, cfg.vocab, size=(1, L))).long()

    def last(t):
        return model.prefill(params, {"tokens": t}, max_seq=L)[0]

    far, near = toks.clone(), toks.clone()
    far[0, 2] = (far[0, 2] + 1) % cfg.vocab          # L - 1 - 2 > 8 behind
    near[0, L - 2] = (near[0, L - 2] + 1) % cfg.vocab
    assert float((last(far) - last(toks)).abs().max()) == 0.0
    assert float((last(near) - last(toks)).abs().max()) > 0.0


def test_vlm_prefix_is_used(rng):
    cfg = configs.get_smoke("phi-3-vision-4.2b")
    model = build(cfg, RunConfig(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = synth_batch(model, torch.Generator().manual_seed(1), 16, 2)
    assert tuple(b["patch_embeds"].shape) == (2, cfg.n_patches, cfg.d_model)
    assert tuple(b["tokens"].shape) == (2, 16 - cfg.n_patches)
    out, cache = model.prefill(params, b, max_seq=20)
    assert int((cache["k"][0, 0, 0].abs().sum(-1) > 0).sum()) == 16   # patches + tokens
    out2, _ = model.prefill(params, dict(b, patch_embeds=b["patch_embeds"] * 0 + 1.0),
                            max_seq=20)
    assert float((out - out2).abs().max()) > 0     # the stub frontend is used


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b", "mamba2-130m",
                                  "phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_serve_gives_the_reference_serve_tokens(arch):
    """The port's serve, fed the weights and the prompt (with its patch
    embeddings or frames) the reference's serve draws, generates the same
    greedy tokens; the CPU path launches no kernel."""
    scfg = r_serve.ServeConfig(batch=2, prompt_len=12, gen_len=5)
    want, _ = r_serve.serve(arch, scfg, smoke=True, log_fn=lambda *a: None)
    rmodel = r_build(r_configs.get_smoke(arch), RRunConfig(param_dtype="float32", remat=False))
    rparams, _ = rmodel.init(jax.random.PRNGKey(scfg.seed))
    batch = r_synth(rmodel, jax.random.PRNGKey(scfg.seed + 1), scfg.prompt_len, scfg.batch,
                    mode="prefill")
    before = (conv1d.launches, ssd.launches, attention.launches)
    got, info = t_serve.serve(
        arch, t_serve.ServeConfig(batch=2, prompt_len=12, gen_len=5), smoke=True,
        device="cpu", params=interop.params_from_numpy(_np_tree(rparams), device="cpu"),
        tokens=np.asarray(batch["tokens"]),
        extras={k: np.asarray(v) for k, v in batch.items() if k != "tokens"},
        log_fn=lambda *a: None)
    assert (conv1d.launches, ssd.launches, attention.launches) == before
    np.testing.assert_array_equal(got, np.asarray(want))
    assert info["prefill_logits"].shape == (2, 256)


def test_serve_takes_overrides_and_checks_the_prompt():
    scfg = t_serve.ServeConfig(batch=2, prompt_len=8, gen_len=3)
    quiet = dict(smoke=True, device="cpu", log_fn=lambda *a: None)
    got, _ = t_serve.serve("qwen3-32b", scfg, overrides={"n_layers": 1}, **quiet)
    assert got.shape == (2, 3)
    toks = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError, match="frames"):
        t_serve.serve("seamless-m4t-medium", scfg, tokens=toks, **quiet)
    with pytest.raises(ValueError, match=r"do not match \(batch, tokens\) = \(2, 4\)"):
        t_serve.serve("phi-3-vision-4.2b", scfg, tokens=toks, **quiet)
    with pytest.raises(ValueError, match="patch_embeds"):
        t_serve.serve("phi-3-vision-4.2b", scfg, tokens=toks[:, :4],
                      extras={"patch_embeds": np.zeros((2, 3, 64), np.float32)}, **quiet)
    assert t_serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--batch", "1",
                         "--prompt-len", "6", "--gen-len", "2", "--override",
                         "n_layers=1"]) == 0
    out = profile_serve.profile("seamless-m4t-medium", 2, 8, 2, "cuda", smoke=True,
                                device="cpu", overrides={"n_dec_layers": 1})
    assert out["device"] == "cpu" and out["prefill_ms"] > 0 and out["decode_step_ms"] > 0
