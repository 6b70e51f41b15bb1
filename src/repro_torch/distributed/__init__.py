"""Distributed runtime of the port. Only fault handling is ported so far
(retry, fault injection, heartbeats, step monitoring); halo exchange,
overlap and elastic restart are still to come."""
from . import fault

__all__ = ["fault"]
