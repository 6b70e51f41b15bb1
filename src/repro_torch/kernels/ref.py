"""Plain PyTorch versions of the kernels: the semantic ground truth that the
CPU tests hold against the JAX package, and that ``chip_smoke.py`` holds
each CUDA kernel against on the card."""
from __future__ import annotations

import torch


# -- 3-D heat diffusion (paper Fig. 1) ---------------------------------------
def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz):
    """One explicit Euler step of ``dT/dt = lam/c * lap(T)`` on the interior.

    Returns a new tensor: the update on the interior, T2's values on the
    boundary ring.
    """
    d2x = (T[2:, 1:-1, 1:-1] - 2 * T[1:-1, 1:-1, 1:-1] + T[:-2, 1:-1, 1:-1]) * inv_dx**2
    d2y = (T[1:-1, 2:, 1:-1] - 2 * T[1:-1, 1:-1, 1:-1] + T[1:-1, :-2, 1:-1]) * inv_dy**2
    d2z = (T[1:-1, 1:-1, 2:] - 2 * T[1:-1, 1:-1, 1:-1] + T[1:-1, 1:-1, :-2]) * inv_dz**2
    upd = T[1:-1, 1:-1, 1:-1] + dt * (lam * Ci[1:-1, 1:-1, 1:-1] * (d2x + d2y + d2z))
    out = T2.clone()
    out[1:-1, 1:-1, 1:-1] = upd
    return out


# -- generic 2nd-order laplacian step ----------------------------------------
def laplacian_step(U, coeff, dt, inv_spacing):
    nd = U.ndim
    inner = tuple(slice(1, -1) for _ in range(nd))
    lap = torch.zeros_like(U[inner])
    for a in range(nd):
        lo = tuple(slice(None, -2) if i == a else slice(1, -1) for i in range(nd))
        hi = tuple(slice(2, None) if i == a else slice(1, -1) for i in range(nd))
        lap = lap + (U[hi] - 2 * U[inner] + U[lo]) * inv_spacing[a] ** 2
    out = U.clone()
    out[inner] = U[inner] + dt * coeff * lap
    return out
