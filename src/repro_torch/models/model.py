"""Family dispatch: the one facade the serving and training launchers and
the tests drive, the twin of ``src/repro/models/model.py``. ``dense``,
``moe``, ``ssm`` and ``vlm`` go to ``transformer``, ``encdec`` to ``encdec``
and ``hybrid`` to ``hybrid``."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.device import resolve_device
from . import common as cm
from . import encdec as encdec_mod
from . import hybrid as hybrid_mod
from . import transformer as tf_mod
from .config import ArchConfig, RunConfig

FAMILIES = {"dense": tf_mod, "moe": tf_mod, "ssm": tf_mod, "vlm": tf_mod,
            "encdec": encdec_mod, "hybrid": hybrid_mod}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    rc: RunConfig
    device: torch.device

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family!r}; known: {sorted(FAMILIES)}")
        self._mod = FAMILIES[self.cfg.family]

    def init(self, gen: torch.Generator):
        """Parameters drawn from ``gen``, on ``gen``'s device (the model's)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        return self._mod.model_init(gen, self.cfg, self.rc)

    def loss_fn(self, params, batch):
        """The training loss of ``batch``: {"tokens", "labels"} and, for a
        VLM, "patch_embeds"; for an enc-dec, "frames"."""
        cfg, rc = self.cfg, self.rc
        if cfg.family == "encdec":
            return encdec_mod.loss_fn(params, cfg, rc, batch["tokens"], batch["labels"],
                                      frames=batch["frames"])
        if cfg.family == "hybrid":
            return hybrid_mod.loss_fn(params, cfg, rc, batch["tokens"], batch["labels"])
        return tf_mod.loss_fn(params, cfg, rc, batch["tokens"], batch["labels"],
                              prefix_embeds=batch.get("patch_embeds"))

    def init_cache(self, batch: int, max_seq: int):
        return self._mod.init_cache(self.cfg, self.rc, batch, max_seq, self.device)

    def prefill(self, params, batch, max_seq: int):
        """``batch``: {"tokens"} and, for a VLM, "patch_embeds" (B, n, D); for
        an enc-dec, "frames" (B, S_src, D)."""
        cfg, rc = self.cfg, self.rc
        if cfg.family == "encdec":
            return encdec_mod.prefill(params, cfg, rc, batch["tokens"], max_seq,
                                      frames=batch["frames"])
        if cfg.family == "hybrid":
            return hybrid_mod.prefill(params, cfg, rc, batch["tokens"], max_seq)
        return tf_mod.prefill(params, cfg, rc, batch["tokens"], max_seq,
                              prefix_embeds=batch.get("patch_embeds"))

    def decode_step(self, params, token, cache, pos):
        return self._mod.decode_step(params, self.cfg, self.rc, token, cache, pos)


def build(cfg: ArchConfig, rc: Optional[RunConfig] = None, device="cuda") -> Model:
    return Model(cfg, rc or RunConfig(), resolve_device(device))


def synth_batch(model: Model, gen: torch.Generator, seq_len: int, global_batch: int,
                mode: str = "prefill"):
    """A random prefill or training (``mode="train"``) batch drawn from
    ``gen``, the reference's shapes: {"tokens": (B, L) int64} and, to train,
    "labels" of the tokens' shape; a VLM's prompt is ``n_patches`` patch
    embeddings then ``L - n_patches`` tokens, an enc-dec's source is
    ``source_len`` frames. Embeddings are N(0, 1) * 0.02 at the parameter
    dtype."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode must be 'prefill' or 'train', got {mode!r}")
    cfg, B = model.cfg, global_batch
    dtype = tf_mod.param_dtype(model.rc)
    n_tok = seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len
    if n_tok < 1:
        raise ValueError(f"seq_len {seq_len} leaves no tokens after {cfg.n_patches} patches")

    def embeds(n):
        return cm.normal(gen, (B, n, cfg.d_model), 0.02, dtype).to(model.device)

    out = {"tokens": torch.randint(0, cfg.vocab, (B, n_tok), generator=gen,
                                   device=gen.device).to(model.device)}
    if mode == "train":
        out["labels"] = torch.randint(0, cfg.vocab, (B, n_tok), generator=gen,
                                      device=gen.device).to(model.device)
    if cfg.family == "vlm":
        out["patch_embeds"] = embeds(cfg.n_patches)
    if cfg.family == "encdec":
        out["frames"] = embeds(cfg.source_len)
    return out

