"""Deterministic, shardable token pipeline with exact resume: the port's own
copy of ``src/repro/data/tokens.py`` (numpy only), so both packages draw the
same batches, bit for bit.

Two sources behind one interface:
  * SyntheticSource — a fixed-seed Zipf-ish token stream with local n-gram
    structure (so losses actually decrease), generated on the fly;
  * MemmapSource — flat binary token file (np.uint16/uint32 memmap), the
    production path.

Determinism contract (fault-tolerance critical): batch(step, shard) is a
pure function of (seed, step, shard_id, n_shards) — any host can
reconstruct any other host's batch after failover, and resume needs no
pipeline state beyond the step counter.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    source: str = "synthetic"       # synthetic | memmap
    path: Optional[str] = None       # memmap file
    n_shards: int = 1                # data-parallel host shards
    shard_id: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        return self.global_batch // self.n_shards


class SyntheticSource:
    """Zipf marginals + order-1 mixing: next ~ 0.7 * f(prev) + 0.3 * zipf."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        self._perm = rng.permutation(cfg.vocab)  # deterministic f(prev)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 131 + cfg.shard_id) % (2**31 - 1))
        B, L, V = cfg.local_batch, cfg.seq_len, cfg.vocab
        ranks = rng.zipf(1.3, size=(B, L + 1)).astype(np.int64)
        base = np.minimum(ranks, V) - 1
        toks = np.empty((B, L + 1), np.int32)
        toks[:, 0] = base[:, 0]
        follow = rng.rand(B, L) < 0.7
        for t in range(1, L + 1):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self._perm[toks[:, t - 1] % V] % V, base[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class MemmapSource:
    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_tokens = len(self.data)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        B, L = cfg.local_batch, cfg.seq_len
        n_seq = self.n_tokens // (L + 1)
        rng = np.random.RandomState((cfg.seed + step) % (2**31 - 1))
        # global sample of global_batch sequence ids; take our shard's slice
        ids = rng.randint(0, n_seq, size=cfg.global_batch)
        ids = ids[cfg.shard_id * B:(cfg.shard_id + 1) * B]
        toks = np.stack([self.data[i * (L + 1):(i + 1) * (L + 1)] for i in ids])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticSource(cfg)
    if cfg.source == "memmap":
        return MemmapSource(cfg)
    raise ValueError(cfg.source)


def iterate(source, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, source.batch(step)
        step += 1
