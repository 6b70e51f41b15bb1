"""The port's LM substrate: the serving paths of the dense, MoE, SSM, VLM,
encoder-decoder and hybrid families."""
from .config import ArchConfig, RunConfig, smoke_variant
from .model import Model, build, synth_batch

__all__ = ["ArchConfig", "Model", "RunConfig", "build", "smoke_variant", "synth_batch"]
