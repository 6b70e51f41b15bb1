"""The training step of the port's LM path: the twin of
``src/repro/launch/steps.py::make_train_step`` on one device (sharding is
ROADMAP queue 1, item 9).

A step computes the loss of a batch, its gradients by autograd (on the
card, through the kernels' autograd Functions: every forward kernel's
backward is a hand-written kernel), clips them to their global norm and
applies AdamW in place; with ``n_micro > 1`` the batch is cut into
microbatches whose gradients are averaged first.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model
from ..optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, seq_len: int,
                    global_batch: int, n_micro: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    metrics {"loss" (f32 scalar tensor), "lr" (float), "grad_norm" (f32
    scalar tensor)}. ``params`` are updated in place; their leaves must
    require gradients. ``batch`` is the model's training batch of
    ``global_batch`` rows (``seq_len`` positions, a VLM's patches
    included)."""
    if global_batch % n_micro:
        raise ValueError(f"global_batch {global_batch} does not divide into {n_micro} "
                         "microbatches")

    def train_step(params, opt_state, batch):
        if batch["tokens"].shape[0] != global_batch:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows, the step takes "
                             f"{global_batch}")
        if n_micro > 1:
            mb = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                  for k, v in batch.items()}
            grads, loss = adamw.accumulate_grads(model.loss_fn, params, mb, n_micro)
        else:
            loss = model.loss_fn(params, batch)
            grads = adamw.unflatten(params, torch.autograd.grad(loss, adamw.leaves(params)))
            loss = loss.detach()
        params, opt_state, metrics = adamw.apply(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step
