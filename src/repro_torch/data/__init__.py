from . import physics, tokens
from .tokens import DataConfig, make_source

__all__ = ["physics", "tokens", "DataConfig", "make_source"]
