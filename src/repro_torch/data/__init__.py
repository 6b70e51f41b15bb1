from . import physics

__all__ = ["physics"]
