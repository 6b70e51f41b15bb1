"""Family dispatch: the one facade the serving launcher and the tests drive,
the twin of ``src/repro/models/model.py`` for the families ported so far
(hybrid)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.device import resolve_device
from . import hybrid as hybrid_mod
from .config import ArchConfig, RunConfig

_PORTED = {"hybrid": hybrid_mod}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    rc: RunConfig
    device: torch.device

    def __post_init__(self):
        if self.cfg.family not in _PORTED:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ROADMAP queue 1, item 9: "
                "the dense, MoE, SSM, enc-dec and VLM stacks)")
        self._mod = _PORTED[self.cfg.family]

    def init(self, gen: torch.Generator):
        """Parameters drawn from ``gen``, on ``gen``'s device (the model's)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        return self._mod.model_init(gen, self.cfg, self.rc)

    def init_cache(self, batch: int, max_seq: int):
        return self._mod.init_cache(self.cfg, self.rc, batch, max_seq, self.device)

    def prefill(self, params, batch, max_seq: int):
        return self._mod.prefill(params, self.cfg, self.rc, batch["tokens"], max_seq)

    def decode_step(self, params, token, cache, pos):
        return self._mod.decode_step(params, self.cfg, self.rc, token, cache, pos)


def build(cfg: ArchConfig, rc: Optional[RunConfig] = None, device="cuda") -> Model:
    return Model(cfg, rc or RunConfig(), resolve_device(device))


def synth_batch(model: Model, gen: torch.Generator, seq_len: int, global_batch: int,
                mode: str = "prefill"):
    """A random prompt batch {"tokens": (B, L) int64} drawn from ``gen``."""
    if mode != "prefill":
        raise NotImplementedError(
            f"mode {mode!r}: training batches wait for training (ROADMAP queue 1, item 9)")
    tokens = torch.randint(0, model.cfg.vocab, (global_batch, seq_len), generator=gen,
                           device=gen.device)
    return {"tokens": tokens.to(model.device)}
