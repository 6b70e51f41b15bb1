from .manager import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
