"""The port's LM substrate: the Zamba2 hybrid serving path."""
from .config import ArchConfig, RunConfig, smoke_variant
from .model import Model, build, synth_batch

__all__ = ["ArchConfig", "Model", "RunConfig", "build", "smoke_variant", "synth_batch"]
