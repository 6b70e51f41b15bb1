"""Learning-rate schedules: cosine, constant and WSD (Warmup-Stable-Decay),
the twins of ``src/repro/optim/schedules.py``, computed in f32 as the
reference computes them (so both give the same learning rate, bit for bit,
for the same step).

WSD is the MiniCPM schedule (arXiv:2404.06395): linear warmup, a long
stable plateau at the peak rate, then an exponential decay tail.
"""
from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    step = _f32(step)
    warm = _f32(base_lr) * step / _f32(max(warmup, 1))
    prog = np.clip((step - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0), _f32(1))
    cos = _f32(final_frac) + _f32((1 - final_frac) * 0.5) * (_f32(1) + np.cos(_f32(math.pi) * prog))
    return float(warm if step < warmup else _f32(base_lr) * cos)


def constant(step, base_lr: float, warmup: int = 0, total: int = 0) -> float:
    step = _f32(step)
    warm = _f32(base_lr) * step / _f32(max(warmup, 1))
    return float(warm if step < warmup else _f32(base_lr))


def wsd(step, base_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        final_frac: float = 0.01) -> float:
    """Warmup-Stable-Decay: the decay starts at (1 - decay_frac) * total."""
    step = _f32(step)
    decay_start = (1.0 - decay_frac) * total           # a Python float, as in the reference
    warm = _f32(base_lr) * step / _f32(max(warmup, 1))
    prog = np.clip((step - _f32(decay_start)) / _f32(max(total - decay_start, 1)),
                   _f32(0), _f32(1))
    decay = _f32(base_lr) * np.exp(np.log(_f32(final_frac)) * prog)
    if step < warmup:
        return float(warm)
    return float(_f32(base_lr) if step < _f32(decay_start) else decay)


SCHEDULES = {"cosine": warmup_cosine, "const": constant, "wsd": wsd}


def get(name: str):
    return SCHEDULES[name]
