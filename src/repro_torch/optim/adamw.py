"""AdamW with mixed-precision master weights, global-norm clipping and
microbatch gradient accumulation: the twin of ``src/repro/optim/adamw.py``.

State layout (a tree of tensors beside the parameters, key for key):
  m, v    -- f32 first and second moments
  master  -- the f32 master copy where parameters are of lower precision
  count   -- int32 step

The reference's functions are pure; here :func:`apply` updates the
parameters and the state in place under ``torch.no_grad()`` (a model's f32
state is four times its weights; new arrays each step would double it) and
returns them. Trees are nested dicts; leaves are visited in sorted key
order, the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from . import schedules as sch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 1000
    # decay mask: skip 1-D tensors (norm scales, biases), standard practice
    decay_min_ndim: int = 2


def leaves(tree) -> list[torch.Tensor]:
    """The tree's tensors in sorted key order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, values) -> dict:
    """``like``'s structure with its leaves (in :func:`leaves`' order)
    replaced by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "count": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}
    if any(p.dtype != torch.float32 for p in leaves(params)):
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), in f32; norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def apply(params, grads, state, cfg: AdamWConfig):
    """One AdamW update of ``params`` and ``state`` in place. Returns
    (params, state, metrics {"lr", "grad_norm"})."""
    count = state["count"] + 1
    step_f = float(count)
    lr = sch.get(cfg.schedule)(step_f, cfg.lr, cfg.warmup_steps, cfg.total_steps)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = torch.float32
    dev = count.device
    bc1 = 1 - torch.tensor(b1, dtype=f32, device=dev) ** count.float()
    bc2 = 1 - torch.tensor(b2, dtype=f32, device=dev) ** count.float()
    masters = state.get("master", params)
    for g, m, v, ma, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
                              leaves(masters), leaves(params)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= cfg.decay_min_ndim and cfg.weight_decay:
            upd.add_(cfg.weight_decay * ma)
        ma.sub_(lr * upd)
        if ma is not p:
            p.copy_(ma)
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm}


def accumulate_grads(loss_fn: Callable, params, batches, n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches: ``batches``
    holds leaves with a leading (n_micro, ...) axis. Returns (the mean
    gradient tree in f32, the mean loss)."""
    ps = leaves(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps]
    loss_sum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        loss = loss_fn(params, {k: v[i] for k, v in batches.items()})
        for a, g in zip(acc, torch.autograd.grad(loss, ps)):
            a.add_(g)
        loss_sum = loss_sum + loss.detach()
    inv = 1.0 / n_micro
    return unflatten(params, [a * inv for a in acc]), loss_sum * inv
