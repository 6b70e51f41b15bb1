"""The port's LM training path on the CPU, against the JAX package: the
training batch, remat, the chunked cross-entropy, the optimiser and its
schedules, the token pipeline, ``train()``'s loss history, and the twins
of the reference's end-to-end training tests (``tests/test_system.py``: the
loss decreases and resumes; a resumed run matches the uninterrupted one).
Every arch's loss and gradients are in ``tests/test_torch_train_families.py``.

Weights are the reference's, carried across with
``interop.params_from_numpy``; batches are the reference's (or the same
numpy token stream). The reference runs at f32 with its chunked kernels
(``RunConfig(param_dtype="float32", remat=False)``, ``impl="chunked"``); its
value_and_grad is compiled as ``torch_jax_compile.compiled`` compiles it,
which only makes the compile cheaper. The port runs each kernel's plain version.

Tolerances (f32): AdamW and the schedules rtol 1e-6 (one f32 update; cos in numpy
against XLA's); train() histories rtol 1e-4 (two steps from the same
weights and batches); a resumed run rtol 1e-5, the reference's own bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.data import tokens as r_tokens
from repro.models import RunConfig as RRunConfig, build as r_build
from repro.models import losses as r_losses
from repro.optim import adamw as r_adamw, schedules as r_sch
from repro_torch import configs, interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import tokens
from repro_torch.launch import steps, train as t_train
from repro_torch.models import RunConfig, build, losses, synth_batch
from repro_torch.optim import adamw, schedules

from torch_jax_compile import compiled

R_RC = RRunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                  loss_chunk=32, attn_q_chunk=32, attn_k_chunk=32)
T_RC = RunConfig(param_dtype="float32", remat=False, loss_chunk=32)
QUIET = dict(log_fn=lambda *a: None)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    """A tree of tensors as the reference's arrays (copies: the port updates
    its tensors in place)."""
    return jax.tree.map(lambda t: jnp.array(t.detach().numpy().astype(
        np.int32 if t.dtype == torch.int64 else np.float32)), tree)


def test_synth_train_batch_shapes():
    """synth_batch(mode="train") carries labels of the tokens' shape; a VLM's
    tokens leave room for its patches, an enc-dec has its frames."""
    for arch, extra in (("phi-3-vision-4.2b", "patch_embeds"), ("seamless-m4t-medium", "frames"),
                        ("stablelm-3b", None)):
        cfg = configs.get_smoke(arch)
        model = build(cfg, T_RC, device="cpu")
        b = synth_batch(model, torch.Generator().manual_seed(0), 16, 3, mode="train")
        n = 16 - cfg.n_patches if cfg.family == "vlm" else 16
        assert b["tokens"].shape == b["labels"].shape == (3, n)
        assert (extra is None) == (set(b) == {"tokens", "labels"})
        assert float(model.loss_fn(model.init(torch.Generator().manual_seed(1)), b)) > 0
    with pytest.raises(ValueError, match="mode"):
        synth_batch(model, torch.Generator(), 16, 3, mode="decode")


def test_remat_gives_the_same_gradients_and_dots_names_its_item():
    cfg = configs.get_smoke("zamba2-1.2b")
    base = build(cfg, T_RC, device="cpu")
    params = base.init(torch.Generator().manual_seed(0))
    batch = synth_batch(base, torch.Generator().manual_seed(1), 16, 2, mode="train")
    out = []
    for rc in (T_RC, dataclasses.replace(T_RC, remat=True)):
        ps = {k: v for k, v in params.items()}
        leaves = [p.detach().clone().requires_grad_(True) for p in adamw.leaves(ps)]
        tree = adamw.unflatten(ps, leaves)
        loss = build(cfg, rc, device="cpu").loss_fn(tree, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dots = build(cfg, dataclasses.replace(T_RC, remat=True, remat_policy="dots"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        dots.loss_fn(adamw.unflatten(params, [p.requires_grad_(True)
                                              for p in adamw.leaves(params)]), batch)


# --------------------------------------------------------------------------
# the chunked cross-entropy
# --------------------------------------------------------------------------
@pytest.mark.parametrize("L,chunk,z_loss", [(24, 8, 0.0), (24, 7, 1e-3), (10, 512, 0.0)])
def test_chunked_xent_and_its_gradient(L, chunk, z_loss, rng):
    h = (rng.randn(2, L, 16) * 0.5).astype(np.float32)
    w = (rng.randn(16, 40) * 0.3).astype(np.float32)
    labels = rng.randint(0, 40, size=(2, L)).astype(np.int32)
    labels[0, :3] = losses.IGNORE
    assert losses.IGNORE == r_losses.IGNORE

    def f(h, w):
        return r_losses.chunked_softmax_xent(h, w, jnp.asarray(labels), chunk=chunk,
                                             z_loss=z_loss)

    hw = (jnp.asarray(h), jnp.asarray(w))
    want, (gh, gw) = compiled(jax.value_and_grad(f, argnums=(0, 1)), *hw)(*hw)
    th, tw = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = losses.chunked_softmax_xent(th, tw, torch.tensor(labels, dtype=torch.int64),
                                      chunk=chunk, z_loss=z_loss)
    dh, dw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-7)
    all_ignored = torch.full((2, L), losses.IGNORE)
    assert float(losses.chunked_softmax_xent(th, tw, all_ignored, chunk=chunk).detach()) == 0.0


# --------------------------------------------------------------------------
# the optimiser
# --------------------------------------------------------------------------
def _opt_tree(rng):
    return {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32),
            "blk": {"s": rng.randn(3, 4, 2).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["cosine", "const", "wsd"])
def test_adamw_apply_matches_reference(schedule, rng):
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5, schedule=schedule, warmup_steps=2,
               total_steps=6)
    r_cfg, t_cfg = r_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    params = _opt_tree(rng)
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = r_adamw.init(r_p, r_cfg)
    t_p = interop.params_from_numpy(params, device="cpu")
    t_s = adamw.init(t_p, t_cfg)
    assert set(t_s) == set(r_s) == {"m", "v", "count"}
    r_apply = compiled(lambda p, g, s: r_adamw.apply(p, g, s, r_cfg), r_p, r_p, r_s)
    for step in range(4):
        grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32) * 3, params)
        r_p, r_s, r_m = r_apply(r_p, jax.tree.map(jnp.asarray, grads), r_s)
        t_p, t_s, t_m = adamw.apply(t_p, interop.params_from_numpy(grads, device="cpu"), t_s,
                                    t_cfg)
        np.testing.assert_allclose(t_m["lr"], float(r_m["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(t_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
        for a, b in zip(adamw.leaves(t_p), jax.tree.leaves(r_p)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    back = interop.opt_state_to_numpy(t_s)
    assert int(back["count"]) == int(r_s["count"]) == 4 and back["count"].dtype == np.int32
    for a, b in zip(jax.tree.leaves(back["m"]), jax.tree.leaves(r_s["m"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8)


def test_adamw_bf16_master_path_and_state_interop(rng):
    """bf16 parameters keep an f32 master (updated, then rounded into the
    parameter); a reference state taken to numpy continues in the port."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, schedule="const")
    r_cfg = r_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, schedule="const")
    params = _opt_tree(rng)
    r_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    r_s = r_adamw.init(r_p, r_cfg)
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
             for _ in range(3)]
    r_apply = compiled(lambda p, g, s: r_adamw.apply(p, g, s, r_cfg), r_p, grads[0], r_s)
    r_p, r_s, _ = r_apply(r_p, jax.tree.map(jnp.asarray, grads[0]), r_s)
    # the reference's (params, opt_state) after one step, continued in the port
    t_p = interop.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), r_p),
                                    device="cpu")
    t_p = adamw.tree_map(lambda t: t.to(torch.bfloat16), t_p)
    t_s = interop.opt_state_from_numpy(_np_tree(r_s), device="cpu")
    assert set(t_s) == {"m", "v", "count", "master"} and t_s["count"].dtype == torch.int32
    assert set(adamw.init(t_p, cfg)) == set(t_s)
    for g in grads[1:]:
        r_p, r_s, _ = r_apply(r_p, jax.tree.map(jnp.asarray, g), r_s)
        t_p, t_s, _ = adamw.apply(t_p, interop.params_from_numpy(g, device="cpu"), t_s, cfg)
    for a, b in zip(adamw.leaves(t_s["master"]), jax.tree.leaves(r_s["master"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(adamw.leaves(t_p), jax.tree.leaves(r_p)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_clip_by_global_norm_and_schedules(rng):
    tree = _opt_tree(rng)
    for max_norm in (0.1, 1e6):
        r_g, r_n = r_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        t_g, t_n = adamw.clip_by_global_norm(interop.params_from_numpy(tree, device="cpu"),
                                             max_norm)
        np.testing.assert_allclose(float(t_n), float(r_n), rtol=1e-6)
        for a, b in zip(adamw.leaves(t_g), jax.tree.leaves(r_g)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    for name in ("cosine", "const", "wsd"):
        assert set(schedules.SCHEDULES) == set(r_sch.SCHEDULES)
        for step in (0, 1, 5, 10, 50, 89, 90, 95, 100, 130):
            want = float(r_sch.get(name)(step, 3e-4, 10, 100))
            np.testing.assert_allclose(schedules.get(name)(step, 3e-4, 10, 100), want,
                                       rtol=1e-6, err_msg=f"{name} at {step}")


def test_accumulate_grads_matches_reference(rng):
    """The mean gradient and loss over microbatches of a least-squares loss,
    written in each framework."""
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    mb = {"x": rng.randn(3, 5, 4).astype(np.float32), "y": rng.randn(3, 5, 3).astype(np.float32)}

    def r_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def t_loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    r_g, r_l = r_adamw.accumulate_grads(r_loss, jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, mb), 3)
    t_p = interop.params_from_numpy(params, device="cpu")
    for p in adamw.leaves(t_p):
        p.requires_grad_(True)
    t_g, t_l = adamw.accumulate_grads(t_loss, t_p, interop.fields_from_numpy(mb, device="cpu"),
                                      3)
    np.testing.assert_allclose(float(t_l), float(r_l), rtol=1e-6)
    for a, b in zip(adamw.leaves(t_g), jax.tree.leaves(r_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------
def test_synthetic_and_memmap_batches_bit_for_bit(tmp_path):
    for kw in (dict(vocab=256, seq_len=32, global_batch=4),
               dict(vocab=50280, seq_len=17, global_batch=6, seed=7, n_shards=3, shard_id=2)):
        r_src = r_tokens.make_source(r_tokens.DataConfig(**kw))
        t_src = tokens.make_source(tokens.DataConfig(**kw))
        for step in (0, 1, 9):
            r_b, t_b = r_src.batch(step), t_src.batch(step)
            for k in ("tokens", "labels"):
                assert r_b[k].dtype == t_b[k].dtype
                np.testing.assert_array_equal(t_b[k], r_b[k])
    path = tmp_path / "toks.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    kw = dict(vocab=5000, seq_len=20, global_batch=4, source="memmap", path=str(path))
    r_src = r_tokens.make_source(r_tokens.DataConfig(**kw))
    t_src = tokens.make_source(tokens.DataConfig(**kw))
    for step in (0, 3):
        np.testing.assert_array_equal(t_src.batch(step)["tokens"], r_src.batch(step)["tokens"])
    it = tokens.iterate(t_src, start_step=2)
    assert next(it)[0] == 2 and next(it)[0] == 3
    with pytest.raises(ValueError):
        tokens.make_source(tokens.DataConfig(vocab=8, seq_len=4, global_batch=2, source="x"))


# --------------------------------------------------------------------------
# train(): the loss history, and the reference's end-to-end tests' twins
# --------------------------------------------------------------------------
def test_train_history_matches_reference():
    """Two steps of stablelm-3b's smoke config through the port's train()
    against the reference's step (its value_and_grad, its AdamW with
    train()'s settings) from the same weights on the same token stream."""
    loop = t_train.TrainLoopConfig(steps=2, seq_len=32, global_batch=2, log_every=100)
    model = build(configs.get_smoke("stablelm-3b"), T_RC, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    r_params = _jnp(params)
    _, _, got = t_train.train("stablelm-3b", loop, smoke=True, device="cpu", params=params,
                              **QUIET)
    rc = t_train.default_run_config(loop)
    opt = r_adamw.AdamWConfig(lr=rc.lr, beta1=rc.beta1, beta2=rc.beta2,
                              weight_decay=rc.weight_decay, grad_clip=rc.grad_clip,
                              schedule=rc.schedule, warmup_steps=1, total_steps=2)
    state = r_adamw.init(r_params, opt)
    src = r_tokens.make_source(r_tokens.DataConfig(vocab=256, seq_len=32, global_batch=2))
    batches = [{k: jnp.asarray(v) for k, v in src.batch(step).items()} for step in range(2)]
    r_model = r_build(r_configs.get_smoke("stablelm-3b"), R_RC)

    def r_step(p, s, batch):
        loss, grads = jax.value_and_grad(r_model.loss_fn)(p, batch)
        p, s, _ = r_adamw.apply(p, grads, s, opt)
        return p, s, loss

    r_step = compiled(r_step, r_params, state, batches[0])
    want = []
    for batch in batches:
        r_params, state, loss = r_step(r_params, state, batch)
        want.append(float(loss))
    assert (rc.loss_chunk, rc.remat, loop.steps // 10) == (R_RC.loss_chunk, R_RC.remat, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_loss_decreases_and_resumes(tmp_path):
    loop = t_train.TrainLoopConfig(steps=16, seq_len=64, global_batch=4,
                                   ckpt_dir=str(tmp_path), ckpt_every=8, log_every=50)
    _, _, hist = t_train.train("mamba2-130m", loop, smoke=True, device="cpu", **QUIET)
    assert len(hist) == 16
    assert hist[-1] < hist[0], (hist[0], hist[-1])
    assert all(np.isfinite(h) for h in hist)
    seen = []
    loop2 = t_train.TrainLoopConfig(steps=20, seq_len=64, global_batch=4,
                                    ckpt_dir=str(tmp_path), resume=True, ckpt_every=50,
                                    log_every=50)
    _, _, hist2 = t_train.train("mamba2-130m", loop2, smoke=True, device="cpu",
                                log_fn=seen.append)
    assert len(hist2) == 4 and "resumed from step 16" in seen
    assert hist2[0] < hist[0]


def test_resume_matches_uninterrupted(tmp_path):
    """A run cut at step 5 and resumed from its checkpoint takes the
    uninterrupted run's steps 5-9 (constant schedule: the horizon does not
    differ between the runs)."""
    def rc():
        return RunConfig(param_dtype="float32", remat=False, loss_chunk=32, schedule="const",
                         warmup_steps=1)

    kw = dict(seq_len=32, global_batch=2)
    loop_a = t_train.TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
                                     log_every=100, **kw)
    _, _, hist_a = t_train.train("stablelm-3b", loop_a, rc=rc(), smoke=True, device="cpu",
                                 **QUIET)
    loop_b1 = t_train.TrainLoopConfig(steps=5, ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                                      log_every=100, **kw)
    t_train.train("stablelm-3b", loop_b1, rc=rc(), smoke=True, device="cpu", **QUIET)
    loop_b2 = t_train.TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path / "b"), resume=True,
                                      ckpt_every=100, log_every=100, **kw)
    _, _, hist_b = t_train.train("stablelm-3b", loop_b2, rc=rc(), smoke=True, device="cpu",
                                 **QUIET)
    np.testing.assert_allclose(hist_a[5:], hist_b, rtol=1e-5)
    # the last step is saved whatever ckpt_every is, as the reference saves it
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 10


def test_deterministic_training_raises_and_restores_the_earlier_setting():
    """train(deterministic=True) runs with PyTorch's deterministic
    algorithms on and raising (not warning) where an op has none; the
    setting before it, warn-only included, is back after, also when the
    block raises."""
    seen = []
    loop = t_train.TrainLoopConfig(steps=1, seq_len=16, global_batch=2, log_every=100)
    t_train.train("mamba2-130m", loop, smoke=True, device="cpu", deterministic=True,
                  on_step=lambda *a: seen.append(
                      (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())), **QUIET)
    assert seen == [(True, False)]
    assert not torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            with t_train.deterministic_algorithms():
                torch.zeros(4).put_(torch.tensor([0]), torch.tensor([1.0]))
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium",
                                  "moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_every_family_trains_a_step(arch):
    """One step of each other family through train(): a VLM's patches and an
    enc-dec's frames drawn per step, the MoE's aux loss, the hybrid's shared
    block; the metrics are finite."""
    seen = []
    loop = t_train.TrainLoopConfig(steps=2, seq_len=16, global_batch=2, log_every=1)
    params, opt, hist = t_train.train(arch, loop, smoke=True, device="cpu",
                                      on_step=lambda s, m, dt: seen.append(m), **QUIET)
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert [m["loss"] for m in seen] == hist and all(m["grad_norm"] > 0 for m in seen)
    assert int(opt["count"]) == 2


def test_train_step_microbatches_average_the_gradients():
    """n_micro = 2 on a batch of 4 rows: the mean of the two halves'
    gradients, the loss their mean."""
    cfg = configs.get_smoke("stablelm-3b")
    model = build(cfg, T_RC, device="cpu")
    batch = synth_batch(model, torch.Generator().manual_seed(2), 16, 4, mode="train")
    opt = adamw.AdamWConfig(lr=0.0, weight_decay=0.0)
    out = []
    for n_micro in (1, 2):
        params = model.init(torch.Generator().manual_seed(0))
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        step = steps.make_train_step(model, opt, 16, 4, n_micro=n_micro)
        _, _, m = step(params, adamw.init(params, opt), batch)
        out.append(m)
    halves = []
    for i in (0, 1):
        params = model.init(torch.Generator().manual_seed(0))
        halves.append(float(model.loss_fn(params, {k: v[2 * i:2 * i + 2]
                                                   for k, v in batch.items()})))
    np.testing.assert_allclose(float(out[1]["loss"]), np.mean(halves), rtol=1e-6)
    assert float(out[0]["grad_norm"]) > 0 and float(out[1]["grad_norm"]) > 0
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(model, opt, 16, 4, n_micro=3)


def test_train_cli_on_the_cpu(capsys):
    assert t_train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "3",
                         "--seq-len", "16", "--global-batch", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and out.count("step ") == 3
