"""Plain PyTorch versions of the kernels: the semantic ground truth that the
CPU tests hold against the JAX package, and that ``chip_smoke.py`` holds
each CUDA kernel against on the card.

The backward kernels' plain versions (``conv1d_bwd``, ``ssd_bwd``,
``attention_bwd``) are ``torch.autograd.grad`` through the plain forward.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def pick_divisor(n: int, target: int) -> int:
    """The largest divisor of ``n`` not above ``target`` (the reference's
    ``ops._pick_divisor``)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return max(c, 1)


# -- 3-D heat diffusion (paper Fig. 1) ---------------------------------------
def stored_value(v, dtype: torch.dtype) -> float:
    """A Python number as a tensor of ``dtype`` holds it: rounded to f32,
    then to ``dtype`` (as PyTorch rounds a number into a bf16 or f16
    tensor)."""
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype).double())


def stored_scalars(dtype, lam, dt, inv_dx, inv_dy, inv_dz) -> list[float]:
    """``lam, dt, inv_dx**2, inv_dy**2, inv_dz**2`` as the reference's hand
    kernel holds them: squared in Python double, then rounded to the
    fields' dtype (:func:`stored_value`)."""
    return [stored_value(v, dtype) for v in (lam, dt, inv_dx ** 2, inv_dy ** 2, inv_dz ** 2)]


def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz):
    """One explicit Euler step of ``dT/dt = lam/c * lap(T)`` on the interior,
    computed at the fields' dtype, as the reference's hand kernel computes
    it: the scalars rounded to it first (:func:`stored_scalars`), then each
    operation rounding to it (PyTorch's bf16 and f16 operators compute each
    in f32 and round, which equals the operation in bf16 or f16).

    Returns a new tensor: the update on the interior, T2's values on the
    boundary ring.
    """
    lam, dt, idx2, idy2, idz2 = stored_scalars(T.dtype, lam, dt, inv_dx, inv_dy, inv_dz)
    d2x = (T[2:, 1:-1, 1:-1] - 2 * T[1:-1, 1:-1, 1:-1] + T[:-2, 1:-1, 1:-1]) * idx2
    d2y = (T[1:-1, 2:, 1:-1] - 2 * T[1:-1, 1:-1, 1:-1] + T[1:-1, :-2, 1:-1]) * idy2
    d2z = (T[1:-1, 1:-1, 2:] - 2 * T[1:-1, 1:-1, 1:-1] + T[1:-1, 1:-1, :-2]) * idz2
    upd = T[1:-1, 1:-1, 1:-1] + dt * (lam * Ci[1:-1, 1:-1, 1:-1] * (d2x + d2y + d2z))
    out = T2.clone()
    out[1:-1, 1:-1, 1:-1] = upd
    return out


def diffusion3d_steps(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps: int = 1):
    """``nsteps`` rotated steps of :func:`diffusion3d_step` with the reference's
    k-step ring rule: an intermediate step keeps T's value on the boundary
    ring, the last takes T2's (the reference's ``nsteps=k`` kernel)."""
    for _ in range(int(nsteps) - 1):
        T = diffusion3d_step(T, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)
    return diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)


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


# -- causal depthwise conv1d (Mamba2's short convolution) --------------------
def conv1d_causal(x, w, b=None):
    """x: (B, L, C), w: (K, C) depthwise taps; ``out[t] = sum_d w[d] x[t-d]``
    with zeros where ``t - d < 0``, plus the bias. The reference oracle's
    order: taps from the oldest input to the newest, then the bias."""
    B, L, C = x.shape
    K = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + L, :] * w[K - 1 - k][None, None, :]
    if b is not None:
        out = out + b[None, None, :]
    return out


def conv1d_bwd(dout, x, w, b=None, silu: bool = False):
    """(dx, dw, db) of :func:`conv1d_causal` (then SiLU if asked) given
    ``dout``, computed in f32 and each rounded once to its input's dtype
    (``conv1d.plain``'s function); db is None when b is."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b) if t is not None]
        out = conv1d_causal(*(t.float() for t in leaves))
        if silu:
            out = out * torch.sigmoid(out)
        grads = torch.autograd.grad(out, leaves, dout.float())
    return (*grads, None) if b is None else grads


# -- attention oracle ----------------------------------------------------------
def _allowed(Lq: int, Lk: int, causal: bool, window: Optional[int], device):
    """(Lq, Lk) mask of the keys each query attends to (queries are the last
    Lq positions)."""
    qpos = torch.arange(Lq, device=device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, scale):
    """f32 scaled scores (B, Hq, Lq, Lk), k broadcast over the GQA groups."""
    Hq, Hkv = q.shape[1], k.shape[1]
    # widened before the broadcast, so a bf16 k's gradient sums its heads in f32
    k = torch.repeat_interleave(k.float(), Hq // Hkv, dim=1) if Hq > Hkv else k
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None):
    """q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D); GQA by head broadcast
    (``kv head = q head // rep``). ``window``: each query attends to its last
    ``window`` keys. Computed in f32; a row with no key left gives 0."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq > Hkv:
        v = torch.repeat_interleave(v.float(), Hq // Hkv, dim=1)
    mask = _allowed(q.shape[2], k.shape[2], causal, window, q.device)
    # masked scores are NEG_INF, the reference's chunked path's value: exp
    # underflows to exactly 0 beside any allowed key, and a row with no key
    # left stays finite (its softmax is uniform), so its gradient does too
    logits = torch.where(mask[None, None], _scores(q, k, scale), NEG_INF)
    # a row with no key left gives 0, as the flash kernel gives it
    p = torch.where(mask.any(-1, keepdim=True)[None, None], torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_lse(q, k, causal: bool = True, scale: Optional[float] = None,
                  window: Optional[int] = None):
    """Each row's log-sum-exp of its allowed scaled scores (B, Hq, Lq), f32:
    what the attention kernel writes beside its output for the backward;
    ``-inf`` for a row with no key."""
    mask = _allowed(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.logsumexp(torch.where(mask[None, None], _scores(q, k, scale),
                                       float("-inf")), dim=-1)


def attention_bwd(q, k, v, dout, causal: bool = True, scale: Optional[float] = None,
                  window: Optional[int] = None):
    """(dq, dk, dv) of :func:`attention` given ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention(*leaves, causal=causal, scale=scale, window=window)
        return torch.autograd.grad(out, leaves, dout)


# -- Mamba2 SSD ------------------------------------------------------------------
def _heads(m, H):
    """(B, L, G, N) per state group -> (B, L, H, N) per head, in f32 (so a
    bf16 input's gradient sums its heads in f32 and is rounded once)."""
    rep = H // m.shape[2]
    m = m.float()
    return torch.repeat_interleave(m, rep, dim=2) if rep > 1 else m


def ssd_scan(x, dt, A, B, C, D=None, h0=None):
    """Sequential state-space-duality oracle (Mamba2, arXiv:2405.21060).

    x (b, L, H, P); dt (b, L, H) positive; A (H,) negative; B/C (b, L, G, N)
    per state group; D (H,) or None; h0 (b, H, P, N) or None.
    Returns (y (b, L, H, P), h_final (b, H, P, N) f32)."""
    b, L, H, P = x.shape
    N = B.shape[3]
    Bh, Ch = _heads(B, H).float(), _heads(C, H).float()
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    xf, dtf = x.float(), dt.float()
    ys = []
    for t in range(L):
        h, y = ssd_step(h, xf[:, t], dtf[:, t], A, Bh[:, t], Ch[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, H, P))
    if D is not None:
        y = y + xf * D[None, None, :, None].float()
    return y.to(x.dtype), h


def ssd_step(h, x_t, dt_t, A, B_t, C_t):
    """One token of the SSD recurrence, f32: h (b, H, P, N), x_t (b, H, P),
    dt_t (b, H), B_t/C_t (b, H, N). Returns (h_new, y_t without the skip)."""
    dA = torch.exp(dt_t * A.float()[None, :])
    h = h * dA[..., None, None] + (dt_t[..., None] * x_t)[..., None] * B_t[:, :, None, :]
    return h, torch.einsum("bhpn,bhn->bhp", h, C_t)


def ssd_states(x, dt, A, Bm, Cm, h0=None, chunk: int = 64):
    """The sequential recurrence's state at the start of each chunk of
    ``chunk`` steps (the last one short), (B, nc, H, P, N) f32, and the
    final state: what the SSD kernel's forward keeps for its backward."""
    b, L, H, P = x.shape
    N = Bm.shape[3]
    Bh, Ch = _heads(Bm, H).float(), _heads(Cm, H).float()
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    starts = []
    for t in range(L):
        if t % chunk == 0:
            starts.append(h)
        h, _ = ssd_step(h, x[:, t].float(), dt[:, t].float(), A, Bh[:, t], Ch[:, t])
    return torch.stack(starts, dim=1).contiguous(), h


def ssd(x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64):
    """Chunked SSD, the twin of the reference's ``ops._ssd_chunked_jnp``: the
    plain version of the SSD kernel (the same per-chunk algebra).

    Bm/Cm are per state group (B, L, G, N). The chunk is the largest divisor
    of L not above ``chunk``. Returns (y (B, L, H, P), h_final f32)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    cs = pick_divisor(L, chunk)
    nc = L // cs
    f32 = torch.float32
    xf = x.float()      # once: a bf16 x's gradient is summed in f32, rounded once
    xr = xf.reshape(B, nc, cs, H, P)
    dtr = dt.reshape(B, nc, cs, H).float()
    Br = _heads(Bm, H).reshape(B, nc, cs, H, N).float()
    Cr = _heads(Cm, H).reshape(B, nc, cs, H, N).float()

    la = dtr * A[None, None, None, :].float()
    logcum = torch.cumsum(la, dim=2)                            # (B, nc, cs, H)
    s_last = torch.exp(logcum[:, :, -1])                        # (B, nc, H)

    # chunk-local quadratic part; mask BEFORE the exp: for u > t the log
    # difference is positive and can overflow
    cb = torch.einsum("bnthd,bnuhd->bntuh", Cr, Br)
    ldiff = logcum[:, :, :, None, :] - logcum[:, :, None, :, :]
    idx = torch.arange(cs, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    decay = torch.exp(torch.where(tri[None, None, :, :, None], ldiff, NEG_INF))
    w = cb * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bntuh,bnuhp->bnthp", w, xr)

    # per-chunk state contribution and the inter-chunk recurrence
    coeff = torch.exp(logcum[:, :, -1:, :] - logcum) * dtr          # (B, nc, cs, H)
    G_ = torch.einsum("bnuh,bnuhp,bnuhs->bnhps", coeff, xr, Br)      # (B, nc, H, P, N)
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.float()
    starts = []
    for c in range(nc):
        starts.append(h)                                            # state at chunk start
        h = h * s_last[:, c, :, None, None] + G_[:, c]
    h_starts = torch.stack(starts, dim=1)                           # (B, nc, H, P, N)

    y_inter = torch.einsum("bnths,bnhps->bnthp", Cr * torch.exp(logcum)[..., None], h_starts)
    y = (y_intra + y_inter).reshape(B, L, H, P)
    if D is not None:
        y = y + xf * D[None, None, :, None].float()
    return y.to(x.dtype), h


def ssd_bwd(x, dt, A, Bm, Cm, dy, D=None, h0=None, dh_final=None, chunk: int = 64):
    """The gradients of :func:`ssd` (at ``chunk``) given ``dy`` and, if not
    None, the final state's ``dh_final``: a dict with dx, ddt, dA, dB, dC (per
    state group) and dD, dh0 (None where D or h0 is)."""
    names = ["x", "dt", "A", "B", "C", "D", "h0"]
    given = [(n, t) for n, t in zip(names, (x, dt, A, Bm, Cm, D, h0)) if t is not None]
    with torch.enable_grad():
        leaves = {n: t.detach().requires_grad_(True) for n, t in given}
        y, h = ssd(leaves["x"], leaves["dt"], leaves["A"], leaves["B"], leaves["C"],
                   D=leaves.get("D"), h0=leaves.get("h0"), chunk=chunk)
        outs, grads_out = [y], [dy]
        if dh_final is not None:
            outs.append(h)
            grads_out.append(dh_final)
        grads = torch.autograd.grad(outs, list(leaves.values()), grads_out,
                                    allow_unused=True)
    got = dict(zip(leaves, grads))
    return {f"d{n}": (None if n not in got else
                      torch.zeros_like(leaves[n]) if got[n] is None else got[n])
            for n in names}
