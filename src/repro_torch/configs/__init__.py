"""The paper's PDE configs and the LM architecture registry of the port.

``get_arch``/``get_smoke`` resolve an ``--arch`` id as the reference's
registry does (``src/repro/configs/__init__.py``): each LM config module
pins the published hyperparameters, and ``SHAPES`` is the (arch x input
shape) grid of cells, with ``cell_runnable``'s skip rule.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ArchConfig, smoke_variant
from .diffusion3d import BENCH_256, FIG1, SMOKE, Diffusion3DConfig

_ARCH_MODULES = {
    "moonshot-v1-16b-a3b": ".moonshot_v1_16b_a3b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "phi-3-vision-4.2b": ".phi_3_vision_4_2b",
    "seamless-m4t-medium": ".seamless_m4t_medium",
    "minicpm-2b": ".minicpm_2b",
    "stablelm-3b": ".stablelm_3b",
    "qwen3-32b": ".qwen3_32b",
    "qwen2-72b": ".qwen2_72b",
    "zamba2-1.2b": ".zamba2_1_2b",
    "mamba2-130m": ".mamba2_130m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name], __package__).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return smoke_variant(get_arch(name))


def cell_runnable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? A 500k-token decode needs
    sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def all_cells():
    """Yield (arch_name, shape, runnable, reason) for the 40-cell grid."""
    for a in ARCH_IDS:
        cfg = get_arch(a)
        for s in SHAPES.values():
            ok, why = cell_runnable(cfg, s)
            yield a, s, ok, why


def apply_overrides(cfg, overrides: dict):
    """CLI-style overrides: field=value with type coercion (a field that is
    None takes the value as given)."""
    kw = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if cur is None:
            kw[k] = v
        elif isinstance(cur, bool):
            kw[k] = v in (True, "true", "True", "1", 1)
        else:
            kw[k] = type(cur)(v)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCH_IDS", "BENCH_256", "FIG1", "SHAPES", "SMOKE", "Diffusion3DConfig",
           "ShapeCell", "all_cells", "apply_overrides", "cell_runnable", "get_arch",
           "get_smoke"]
