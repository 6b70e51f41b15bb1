"""LM training driver of the port: a real loop with checkpoint and resume,
fault monitoring and the deterministic token stream. The twin of
``src/repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        [--smoke] [--steps 200] [--seq-len 256] [--global-batch 8] \\
        [--ckpt-dir DIR [--resume] [--ckpt-every 50]] [--device cuda|cpu] \\
        [--override field=value ...]

Every arch of ``configs.ARCH_IDS`` trains. On ``--device cuda`` (the
default) the forward runs the hand-written CUDA kernels inside their
autograd Functions and the backward runs their hand-written backward
kernels; ``--device cpu`` differentiates the kernels' plain versions.
Training defaults to f32, as the reference's ``train()`` does; a
``RunConfig(param_dtype="bfloat16")`` trains bf16 parameters, with the f32
master in the AdamW state and the kernels' bf16 instances. A VLM's patch embeddings and an enc-dec's
source frames are drawn per step from a generator seeded with the step, as
the reference draws them from ``PRNGKey(step)`` (the same distribution, not
the same bits).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .. import configs
from ..checkpoint.manager import CheckpointManager
from ..core.device import resolve_device
from ..data import DataConfig, make_source
from ..distributed import fault
from ..models import RunConfig, build
from ..models import common as cm
from ..optim import adamw
from . import steps as steps_mod


# parameter dtypes train() takes: the kernels' storage dtypes
TRAIN_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    resume: bool = False
    seed: int = 0
    data_seed: int = 1234
    heartbeat_dir: Optional[str] = None


def default_run_config(loop: TrainLoopConfig) -> RunConfig:
    """The reference ``train()``'s run config: f32, no remat, the schedule's
    horizon the loop's, a loss chunk of at most 256."""
    return RunConfig(param_dtype="float32", remat=False, total_steps=loop.steps,
                     loss_chunk=min(256, loop.seq_len))


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's own operations deterministic inside the block, or raising
    where they have no deterministic algorithm (the embedding's and the MoE
    scatter's accumulating backward use atomics otherwise); the earlier
    setting comes back on leaving it.

    ``CUBLAS_WORKSPACE_CONFIG`` is set too, since PyTorch refuses a cuBLAS
    call in this mode without it. cuBLAS reads it only where a process has
    made no cuBLAS call yet; later it only satisfies that check, and cuBLAS
    on one stream gives the same bits on every run anyway."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def step_batch(model, host: Mapping[str, np.ndarray], step: int, loop: TrainLoopConfig,
               device: torch.device) -> dict:
    """The training batch of ``step`` on ``device``: the source's tokens and
    labels; a VLM's patch embeddings (its tokens cut to leave them room)
    and an enc-dec's frames drawn from a generator seeded with the step."""
    cfg = model.cfg
    batch = {k: torch.from_numpy(np.asarray(host[k], dtype=np.int64)).to(device)
             for k in ("tokens", "labels")}
    dtype = getattr(torch, model.rc.param_dtype)
    if cfg.family == "vlm":
        n = cfg.n_patches
        gen = torch.Generator(device=device).manual_seed(step)
        batch["patch_embeds"] = cm.normal(gen, (loop.global_batch, n, cfg.d_model), 0.02, dtype)
        batch["tokens"] = batch["tokens"][:, :loop.seq_len - n]
        batch["labels"] = batch["labels"][:, :loop.seq_len - n]
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(step)
        batch["frames"] = cm.normal(gen, (loop.global_batch, cfg.source_len, cfg.d_model),
                                    0.02, dtype)
    return batch


def train(arch: str, loop: TrainLoopConfig, rc: Optional[RunConfig] = None,
          smoke: bool = False, device="cuda", log_fn=print, params=None,
          overrides: Optional[Mapping] = None, deterministic: bool = False,
          on_step: Optional[Callable] = None):
    """Train ``arch`` for ``loop.steps`` steps (from a checkpoint's step with
    ``loop.resume``). ``params`` (the port's tree) replaces the weights
    drawn from ``loop.seed``; ``overrides`` cut the config as
    ``configs.apply_overrides`` does; ``deterministic`` runs it inside
    :func:`deterministic_algorithms`; ``on_step(step, metrics, seconds)`` is called
    after each step with the loss and grad norm as floats.

    Returns (params, opt_state, the loss of each step run)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
    if overrides:
        cfg = configs.apply_overrides(cfg, overrides)
    rc = rc or default_run_config(loop)
    if rc.param_dtype not in TRAIN_DTYPES:
        raise ValueError(f"param_dtype {rc.param_dtype!r}: training takes {TRAIN_DTYPES} "
                         "(bf16 parameters keep an f32 master in the AdamW state)")
    with deterministic_algorithms() if deterministic else contextlib.nullcontext():
        return _train(cfg, rc, loop, resolve_device(device), log_fn, params, on_step)


def _train(cfg, rc: RunConfig, loop: TrainLoopConfig, dev: torch.device, log_fn, params,
           on_step):
    model = build(cfg, rc, dev)
    opt_cfg = adamw.AdamWConfig(
        lr=rc.lr, beta1=rc.beta1, beta2=rc.beta2, weight_decay=rc.weight_decay,
        grad_clip=rc.grad_clip, schedule=rc.schedule,
        warmup_steps=min(rc.warmup_steps, max(loop.steps // 10, 1)),
        total_steps=loop.steps)
    step_fn = steps_mod.make_train_step(model, opt_cfg, loop.seq_len, loop.global_batch,
                                        rc.n_microbatch)

    # --- state init / restore ----------------------------------------------
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(loop.seed))
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init(params, opt_cfg)
    start_step = 0
    mgr = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    if mgr and loop.resume and mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore((params, opt_state))
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        start_step = int(extra["step"])
        log_fn(f"resumed from step {start_step}")

    # --- data -----------------------------------------------------------------
    source = make_source(DataConfig(vocab=cfg.vocab, seq_len=loop.seq_len,
                                    global_batch=loop.global_batch, seed=loop.data_seed))
    monitor = fault.StepMonitor(host_id=0, heartbeat_dir=loop.heartbeat_dir)
    history = []
    for step in range(start_step, loop.steps):
        batch = step_batch(model, source.batch(step), step, loop, dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {"loss": float(metrics["loss"]), "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"])}
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        history.append(metrics["loss"])
        if on_step is not None:
            on_step(step, metrics, dt)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            health = monitor.check_peers()
            log_fn(f"step {step:5d} loss {metrics['loss']:.4f} lr {metrics['lr']:.2e} "
                   f"|g| {metrics['grad_norm']:.3f} {dt * 1e3:.0f} ms"
                   + (f" [stragglers: {health['stragglers']}]" if health["stragglers"]
                      else ""))
        if mgr and ((step + 1) % loop.ckpt_every == 0 or step == loop.steps - 1):
            mgr.save(step + 1, (params, opt_state), blocking=False,
                     extra={"loss": metrics["loss"]})
    if mgr:
        mgr.wait()
    return params, opt_state, history


def _override(text: str) -> tuple[str, str]:
    if "=" not in text:
        raise argparse.ArgumentTypeError(f"--override takes field=value, got {text!r}")
    k, v = text.split("=", 1)
    return k, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heartbeat-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--override", type=_override, action="append", default=[],
                    help="field=value, repeatable (e.g. n_layers=8)")
    args = ap.parse_args(argv)
    loop = TrainLoopConfig(steps=args.steps, seq_len=args.seq_len,
                           global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
                           resume=args.resume, ckpt_every=args.ckpt_every,
                           log_every=args.log_every, heartbeat_dir=args.heartbeat_dir)
    _, _, hist = train(args.arch, loop, smoke=args.smoke, device=args.device,
                       overrides=dict(args.override))
    if hist:
        print(f"final loss {hist[-1]:.4f} (first {hist[0]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
