"""Public kernel entry points with an explicit implementation switch."""
from __future__ import annotations

from . import diffusion3d as _diff_kernel
from . import ref as _ref


# =====================================================================
# 3-D diffusion step (paper Fig. 1)
# =====================================================================
def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, impl: str = "cuda"):
    """``impl="cuda"`` runs the hand-written kernel (its plain version for
    CPU tensors); ``impl="ref"`` runs the plain PyTorch version."""
    if impl == "cuda":
        return _diff_kernel.diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)
    if impl == "ref":
        return _ref.diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)
    raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")
