"""Device resolution shared by the entry points.

Entry points run on the card unless the caller asks for the CPU. Asking for
the card on a machine without one raises: nothing falls back to the CPU
behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; ``RuntimeError`` when it names
    CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(device)!r}")
    return dev


def default_backend(device) -> str:
    """The ``@parallel`` backend an entry point takes when the caller names
    none: the generated kernels on the card, the plain path on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` (``cuda`` without an index means the
    current card)."""
    if t.device.type != device.type:
        return False
    if device.type == "cuda":
        want = torch.cuda.current_device() if device.index is None else device.index
        return t.device.index == want
    return True
