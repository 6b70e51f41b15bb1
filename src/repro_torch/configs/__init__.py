"""The paper's PDE configs and the LM architecture registry of the port.

``get_arch``/``get_smoke`` resolve an ``--arch`` id as the reference's
registry does, for the architectures ported so far (``ARCH_IDS``); every
other id of the reference raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig, smoke_variant
from .diffusion3d import BENCH_256, FIG1, SMOKE, Diffusion3DConfig

_ARCH_MODULES = {
    "zamba2-1.2b": ".zamba2_1_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"arch {name!r} is not ported (ROADMAP queue 1, item 9: the dense, MoE, "
            f"SSM, enc-dec and VLM stacks); ported: {list(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[name], __package__).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return smoke_variant(get_arch(name))


__all__ = ["ARCH_IDS", "BENCH_256", "FIG1", "SMOKE", "Diffusion3DConfig", "get_arch",
           "get_smoke"]
