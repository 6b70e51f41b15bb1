"""Reactive porosity waves, the paper's second translated solver family (§3).

Pseudo-transient two-field compaction model (Raess et al. 2022, 2-D):

    q         = -k(phi) (grad(Pe) - rho_g)      Darcy flux (staggered)
    dPe/dtau  = -(div q + Pe/eta)               effective pressure
    dphi/dtau = -(1 - phi) Pe/eta               porosity

    PYTHONPATH=src python -m repro_torch.examples.porosity_waves --device cuda \
        [--n 128] [--nt 500] [--backend cuda|torch] [--flux-split]
        [--bc neumann|dirichlet|periodic] [--tol 1e-6] [--check-every 10]
        [--dtype float32|bfloat16|float16]
        [--checkpoint-dir DIR [--save-every 10] [--resume|--no-resume]]

The coupled (phi, Pe) update runs as one fused ``@parallel`` launch per
step, its staggered Darcy fluxes in-kernel (``d_xa``/``av_xa``). With
``--flux-split`` the fluxes are face-centred fields of their own, ``qx``
(n-1, n) and ``qy`` (n, n-1), written at full extent by a first launch and
read, mixed-shape, by the cell update. The boundary condition is declared
per output (``--bc``) and computed inside the launch on ``--backend cuda``
(the default on the card); ``--backend torch`` runs the plain PyTorch path
(also on ``--device cpu``). With ``--tol`` the fused kernel gains a
``max_abs_diff(Pe2, Pe)`` epilogue and ``solve_until`` iterates it to
steady state, checking every ``--check-every`` steps; ``--nt`` caps it.
``--dtype`` is the fields' storage dtype: bf16 and f16 fields are rounded
once from the f32 initial state, and every step computes in f32 and rounds
on store, so each step moves half the bytes of an f32 one.
``--checkpoint-dir`` (with ``--tol``) makes the solve survivable: the
carry is checkpointed atomically every ``--save-every`` checks, and a
killed run restarted with the same flags resumes from the last checkpoint
(``--no-resume`` starts afresh).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..core import Grid, fd2d as fd, init_parallel_stencil, iterate
from ..core.device import default_backend
from ..ir import BoundaryCondition


@dataclasses.dataclass(frozen=True)
class PorosityConfig:
    n: int = 128
    nt: int = 500
    npow: float = 3.0          # permeability exponent, k ~ phi^n
    phi0: float = 0.01         # background porosity
    dphi: float = 0.1          # relative anomaly amplitude
    eta: float = 1.0           # compaction viscosity
    rho_g: float = 30.0        # buoyancy contrast
    device: str = "cuda"
    backend: str | None = None  # cuda | torch; None: cuda on the card
    dtype: str = "float32"     # field STORAGE dtype; compute stays f32
    flux_split: bool = False
    bc: str = "neumann"        # neumann | dirichlet | periodic | none
    tol: float | None = None   # steady-state residual (None: fixed nt)
    check_every: int = 10      # residual cadence in --tol mode
    checkpoint_dir: str | None = None  # survivable --tol solves
    save_every: int = 10       # checks between checkpoints
    resume: bool = True        # restore from LATEST when present

    @property
    def resolved_backend(self) -> str:
        return self.backend or default_backend(self.device)


    @property
    def storage(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def boundary_conditions(cfg: PorosityConfig) -> dict | None:
    """Per-output bc specs realized by the engine.

    ``neumann`` is the zero-flux post-pass; ``dirichlet`` pins the faces to
    the far-field state (phi0, zero overpressure); ``none`` keeps the
    initial boundary ring (raw ``@inn`` semantics).
    """
    if cfg.bc == "none":
        return None
    if cfg.bc == "neumann":
        return {"phi2": BoundaryCondition("neumann0"),
                "Pe2": BoundaryCondition("neumann0")}
    if cfg.bc == "dirichlet":
        return {"phi2": BoundaryCondition("dirichlet", value=cfg.phi0),
                "Pe2": BoundaryCondition("dirichlet", value=0.0)}
    if cfg.bc == "periodic":
        return {"phi2": BoundaryCondition("periodic"),
                "Pe2": BoundaryCondition("periodic")}
    raise ValueError(f"unknown bc {cfg.bc!r}")


def make_grid(cfg: PorosityConfig) -> Grid:
    return Grid((cfg.n, cfg.n), (10.0, 10.0))


def init_state(cfg: PorosityConfig):
    """Gaussian porosity anomaly low in the domain, zero overpressure."""
    grid = make_grid(cfg)
    x, y = grid.meshgrid(device=cfg.device)
    phi = cfg.phi0 + cfg.dphi * cfg.phi0 * torch.exp(
        -((x - 5.0) ** 2 + (y - 2.0) ** 2) / 0.5)
    # storage rounding happens once, here: every later step computes in f32
    # and rounds only on store
    phi = phi.to(cfg.storage)
    Pe = torch.zeros_like(phi)
    return grid, phi, Pe


def timestep(cfg: PorosityConfig, grid: Grid) -> float:
    dx, dy = grid.spacing
    return 0.1 * min(dx, dy) ** 2 / (cfg.phi0 ** cfg.npow * 4) * cfg.phi0 ** cfg.npow


def make_step(grid: Grid, cfg: PorosityConfig):
    """Build ``step(phi, Pe, dtau) -> (phi, Pe)``: one pseudo-time step,
    its boundary condition included. ``step.kernels`` holds the
    :class:`StencilKernel`s (the fused one rotates ``{phi2: phi, Pe2:
    Pe}``)."""
    dx, dy = grid.spacing
    phi0, npow, eta, rho_g = cfg.phi0, cfg.npow, cfg.eta, cfg.rho_g
    bc = boundary_conditions(cfg)
    ps = init_parallel_stencil(backend=cfg.resolved_backend, dtype=cfg.storage, ndims=2,
                               device=cfg.device)

    if not cfg.flux_split:
        @ps.parallel(outputs=("phi2", "Pe2"),
                     rotations={"phi2": "phi", "Pe2": "Pe"}, bc=bc)
        def update(phi2, Pe2, phi, Pe, dtau):
            k = (phi / phi0) ** npow
            # staggered Darcy fluxes (x-faces / y-faces), in-kernel
            qx = -fd.av_xa(k) * fd.d_xa(Pe) / dx
            qy = -fd.av_ya(k) * (fd.d_ya(Pe) / dy
                                 - rho_g * (fd.av_ya(phi) - phi0))
            div_q = fd.d_xa(qx[:, 1:-1]) / dx + fd.d_ya(qy[1:-1, :]) / dy
            Pe_new = fd.inn(Pe) + dtau * (-(div_q + fd.inn(Pe) / eta))
            phi_new = fd.inn(phi) + dtau * (-(1.0 - fd.inn(phi)) * Pe_new / eta)
            return {"phi2": phi_new, "Pe2": Pe_new}

        def step(phi, Pe, dtau):
            out = update(phi2=phi, Pe2=Pe, phi=phi, Pe=Pe, dtau=dtau)
            return out["phi2"], out["Pe2"]

        step.kernels = (update,)
        return step

    # Flux-split scheme: face-centred flux fields written at full extent
    # (`@all`) by `fluxes`, read mixed-shape by `update`.
    @ps.parallel(outputs=("qx", "qy"))
    def fluxes(qx, qy, phi, Pe):
        k = (phi / phi0) ** npow
        return {"qx": -fd.av_xa(k) * fd.d_xa(Pe) / dx,
                "qy": -fd.av_ya(k) * (fd.d_ya(Pe) / dy
                                      - rho_g * (fd.av_ya(phi) - phi0))}

    @ps.parallel(outputs=("phi2", "Pe2"), bc=bc)
    def update(phi2, Pe2, phi, Pe, qx, qy, dtau):
        div_q = fd.d_xa(qx[:, 1:-1]) / dx + fd.d_ya(qy[1:-1, :]) / dy
        Pe_new = fd.inn(Pe) + dtau * (-(div_q + fd.inn(Pe) / eta))
        phi_new = fd.inn(phi) + dtau * (-(1.0 - fd.inn(phi)) * Pe_new / eta)
        return {"phi2": phi_new, "Pe2": Pe_new}

    nx, ny = grid.shape
    qx0 = torch.zeros((nx - 1, ny), dtype=ps.dtype, device=ps.device)
    qy0 = torch.zeros((nx, ny - 1), dtype=ps.dtype, device=ps.device)

    def step(phi, Pe, dtau):
        q = fluxes(qx=qx0, qy=qy0, phi=phi, Pe=Pe)
        out = update(phi2=phi, Pe2=Pe, phi=phi, Pe=Pe, qx=q["qx"], qy=q["qy"], dtau=dtau)
        return out["phi2"], out["Pe2"]

    step.kernels = (fluxes, update)
    return step


def solve_steady(cfg: PorosityConfig, grid: Grid, phi, Pe) -> iterate.SolveResult:
    """Iterate the fused kernel from the given state until ``max|Pe2 - Pe|
    < cfg.tol``, checked every ``cfg.check_every`` steps by the launch's own
    ``max_abs_diff`` epilogue, capped at ``cfg.nt`` steps; checkpointed
    under ``cfg.checkpoint_dir`` when it is set. Returns the
    :class:`~repro_torch.core.iterate.SolveResult`."""
    if cfg.flux_split:
        raise ValueError(
            "--tol drives the fused coupled kernel; the flux-split scheme "
            "splits the update over two launches and has no single kernel "
            "to attach the residual to: drop --flux-split"
        )
    if cfg.bc == "periodic":
        raise ValueError(
            "--tol needs the fused residual epilogue, which cannot ride a "
            "periodic-bc launch (the reference wraps after its launch); use "
            "--bc neumann or dirichlet"
        )
    dtau = timestep(cfg, grid)
    kern = make_step(grid, cfg).kernels[0]
    rkern = kern.with_reductions({"err": "max_abs_diff(Pe2, Pe)"})
    ckpt = None
    if cfg.checkpoint_dir is not None:
        # async atomic checkpoints of the carry every save_every checks; a
        # killed run restarted with the same flags resumes from LATEST
        ckpt = iterate.Checkpointing(cfg.checkpoint_dir, save_every=cfg.save_every,
                                     resume=cfg.resume)
    res = iterate.solve_until(
        rkern, dict(phi2=phi, Pe2=Pe, phi=phi, Pe=Pe), dict(dtau=dtau),
        tol=cfg.tol, max_iters=cfg.nt, check_every=cfg.check_every, checkpoint=ckpt)
    if res.resumed_from is not None:
        print(f"porosity wave: resumed from checkpoint step {res.resumed_from} "
              f"in {cfg.checkpoint_dir}")
    return res


def solve(cfg: PorosityConfig = PorosityConfig(), state=None) -> dict:
    """Run ``cfg.nt`` pseudo-time steps (or, with ``cfg.tol``, iterate to
    steady state) from ``init_state`` or from ``state = (phi, Pe)``;
    returns the fields and diagnostics."""
    iters, err, syncs, resumed_from = cfg.nt, None, 0, None
    if state is None:
        grid, phi, Pe = init_state(cfg)
    else:
        grid, (phi, Pe) = make_grid(cfg), state
    peak0_y = int(torch.argmax(torch.amax(phi, dim=0)))
    if cfg.tol is not None:
        res = solve_steady(cfg, grid, phi, Pe)
        # the rotation targets hold the newest state after the last rotation
        phi, Pe = res.fields["phi"], res.fields["Pe"]
        iters, err, syncs, resumed_from = res.iters, res.err, res.host_syncs, res.resumed_from
    else:
        dtau = timestep(cfg, grid)
        step = make_step(grid, cfg)
        for it in range(cfg.nt):
            phi, Pe = step(phi, Pe, dtau)
            if (it + 1) % 50 == 0 and not bool(torch.isfinite(phi).all()):
                raise FloatingPointError(f"diverged at step {it}")
    if not bool(torch.isfinite(phi).all()):
        raise FloatingPointError(f"diverged by step {cfg.nt}")
    dy = grid.spacing[1]
    peak_y = int(torch.argmax(torch.amax(phi, dim=0)))
    return {
        "grid": grid,
        "phi": phi,
        "Pe": Pe,
        "phi_min": float(phi.min()),
        "phi_max": float(phi.max()),
        "pe_absmax": float(Pe.abs().max()),
        "peak0_y": peak0_y * dy,
        "peak_y": peak_y * dy,
        "iters": iters,
        "residual": err,
        "host_syncs": syncs,
        "resumed_from": resumed_from,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--nt", type=int, default=500)
    ap.add_argument("--npow", type=float, default=3.0, help="k ~ phi^n")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="generated CUDA kernel (default on the card) or plain PyTorch")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"],
                    help="field storage dtype (stencil arithmetic stays f32; bf16/f16 "
                         "halve the bytes every step moves)")
    ap.add_argument("--flux-split", action="store_true",
                    help="explicit staggered flux fields (two launches)")
    ap.add_argument("--bc", default="neumann",
                    choices=["neumann", "dirichlet", "periodic"],
                    help="boundary condition computed inside the engine step")
    ap.add_argument("--tol", type=float, default=None,
                    help="steady-state residual: iterate until max|dPe| < tol; "
                         "--nt becomes the iteration cap")
    ap.add_argument("--check-every", type=int, default=10,
                    help="residual cadence (steps per check) in --tol mode")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for atomic async checkpoints of the --tol solve "
                         "(restartable: see --resume)")
    ap.add_argument("--save-every", type=int, default=10,
                    help="checkpoint cadence in CHECKS (default 10: one save every "
                         "10 * --check-every steps)")
    ap.add_argument("--resume", dest="resume", action="store_true", default=True,
                    help="resume from the LATEST checkpoint when one exists (default)")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="ignore existing checkpoints; start fresh")
    args = ap.parse_args(argv)
    if args.checkpoint_dir is not None and args.tol is None:
        ap.error("--checkpoint-dir requires --tol (checkpoints ride the steady-state "
                 "solve loop)")
    cfg = PorosityConfig(n=args.n, nt=args.nt, npow=args.npow, device=args.device,
                         backend=args.backend, dtype=args.dtype,
                         flux_split=args.flux_split, bc=args.bc, tol=args.tol,
                         check_every=args.check_every, checkpoint_dir=args.checkpoint_dir,
                         save_every=args.save_every, resume=args.resume)
    r = solve(cfg)
    steps = (f"{r['iters']} steps (tol={cfg.tol:g}, residual={r['residual']:.2e}, "
             f"{r['host_syncs']} host syncs)" if cfg.tol is not None
             else f"{cfg.nt} steps")
    print(f"porosity wave: {steps} on {r['grid'].shape} "
          f"[{cfg.resolved_backend}{'/flux-split' if cfg.flux_split else ''}"
          f"/bc={cfg.bc}{'' if cfg.dtype == 'float32' else '/' + cfg.dtype} on {cfg.device}]; "
          f"phi in [{r['phi_min']:.4f}, {r['phi_max']:.4f}]; "
          f"anomaly y: {r['peak0_y']:.2f} -> {r['peak_y']:.2f}")


if __name__ == "__main__":
    main()
