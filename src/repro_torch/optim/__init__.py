"""The optimiser of the port's LM training: AdamW with global-norm
clipping, mixed-precision master weights and microbatch gradient
accumulation (``adamw``), and the learning-rate schedules
(``schedules``). The twin of ``src/repro/optim/``."""
from . import adamw, schedules
from .adamw import AdamWConfig

__all__ = ["adamw", "schedules", "AdamWConfig"]
