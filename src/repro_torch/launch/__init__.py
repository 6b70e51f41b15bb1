"""Launchers of the port: LM serving (``serve``), the stencil roofline
record (``roofline``), the layout sweeps on the card (``tune_stencil``)."""
from . import roofline

__all__ = ["roofline"]
