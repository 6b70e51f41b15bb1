"""Gross-Pitaevskii quantum-fluid solver (the paper's §4 application).

  i dpsi/dt = [ -1/2 lap + V(x) + g |psi|^2 ] psi

    PYTHONPATH=src python -m repro_torch.examples.gross_pitaevskii --device cuda \
        [--n 48] [--nt 200] [--backend cuda|torch] [--two-launch]
        [--bc none|neumann|dirichlet|periodic] [--tol 1e-3] [--check-every 10]

Explicit symplectic Euler on (re, im): re with the current im, im with the
new re, which keeps the Schroedinger flow norm-stable. Mass (sum |psi|^2)
is the conservation diagnostic. By default one coupled radius-2
``@parallel`` launch per step: it computes ``re1`` (the new re on the
once-shrunk frame) and im's update from ``re1`` in the same launch; the
radius is inferred from the update. ``--two-launch`` runs two radius-1
launches (re, then im). ``--bc`` declares per-output boundary conditions,
computed inside the launch on ``--backend cuda`` (the default on the card;
``none`` keeps the initial boundary ring). With ``--tol`` the fused kernel
gains ``sum_sq(re2)``/``sum_sq(im2)`` epilogues and ``solve_until(until=
"above")`` runs until the relative mass drift exceeds ``tol`` or ``--nt``
steps are done.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..core import Grid, fd3d as fd, init_parallel_stencil, iterate
from ..core.device import default_backend
from ..ir import BoundaryCondition


@dataclasses.dataclass(frozen=True)
class GPConfig:
    n: int = 48
    nt: int = 200
    g: float = 0.5             # interaction strength
    device: str = "cuda"
    backend: str | None = None  # cuda | torch; None: cuda on the card
    fused: bool = True
    bc: str = "none"           # none | neumann | dirichlet | periodic
    tol: float | None = None   # mass-drift tripwire (None: fixed nt)
    check_every: int = 10      # drift cadence in --tol mode
    checkpoint_dir: str | None = None  # not ported yet

    @property
    def resolved_backend(self) -> str:
        return self.backend or default_backend(self.device)


def boundary_conditions(cfg: GPConfig) -> dict | None:
    """Per-output bc specs for (re2, im2). ``none`` keeps the boundary ring
    of the trap at its initial (exponentially small) values."""
    if cfg.bc == "none":
        return None
    kinds = {"neumann": lambda: BoundaryCondition("neumann0"),
             "dirichlet": lambda: BoundaryCondition("dirichlet", value=0.0),
             "periodic": lambda: BoundaryCondition("periodic")}
    if cfg.bc not in kinds:
        raise ValueError(f"unknown bc {cfg.bc!r}")
    return {"re2": kinds[cfg.bc](), "im2": kinds[cfg.bc]()}


def make_grid(cfg: GPConfig) -> Grid:
    return Grid((cfg.n,) * 3, (8.0, 8.0, 8.0))


def init_state(cfg: GPConfig):
    """Normalized ground-state-like blob in a harmonic trap."""
    grid = make_grid(cfg)
    xs = grid.meshgrid(device=cfg.device)
    c = [l / 2 for l in grid.length]
    r2 = sum((x - ci) ** 2 for x, ci in zip(xs, c))
    V = 0.05 * r2
    re = torch.exp(-r2 / 4.0)
    im = torch.zeros_like(re)
    norm = torch.sqrt(torch.sum(re ** 2 + im ** 2))
    return grid, re / norm, im, V


def _H(f, re, im, V, g, _dx2, _dy2, _dz2):
    """(-1/2 lap + V + g|psi|^2) f, one frame inward (consumes radius 1)."""
    lap = fd.d2_xi(f) * _dx2 + fd.d2_yi(f) * _dy2 + fd.d2_zi(f) * _dz2
    dens = fd.inn(re) ** 2 + fd.inn(im) ** 2
    return -0.5 * lap + (fd.inn(V) + g * dens) * fd.inn(f)


def make_step(grid: Grid, cfg: GPConfig):
    """Build ``step(re, im, dt, V) -> (re, im)``; ``step.kernels`` holds the
    :class:`StencilKernel`s."""
    ps = init_parallel_stencil(backend=cfg.resolved_backend, ndims=3, device=cfg.device)
    bc = boundary_conditions(cfg)

    if cfg.fused:
        @ps.parallel(outputs=("re2", "im2"), bc=bc, rotations={"re2": "re", "im2": "im"})
        def update(re2, im2, re, im, V, g, dt, _dx2, _dy2, _dz2):
            # frame 1: new re everywhere im's stencil will need it
            re1 = fd.inn(re) + dt * _H(im, re, im, V, g, _dx2, _dy2, _dz2)
            im1, V1 = fd.inn(im), fd.inn(V)
            # frame 2: im update from the new re (symplectic order)
            return {"re2": fd.inn(re1),
                    "im2": fd.inn(im1) - dt * _H(re1, re1, im1, V1, g, _dx2, _dy2, _dz2)}

        kernels = (update,)

        def raw_step(re, im, V, g, dt, inv2):
            out = update(re2=re, im2=im, re=re, im=im, V=V, g=g, dt=dt,
                         _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
            return out["re2"], out["im2"]
    else:
        bc_re = None if bc is None else {"re2": bc["re2"]}
        bc_im = None if bc is None else {"im2": bc["im2"]}

        @ps.parallel(outputs=("re2",), bc=bc_re)
        def step_re(re2, re, im, V, g, dt, _dx2, _dy2, _dz2):
            return {"re2": fd.inn(re) + dt * _H(im, re, im, V, g, _dx2, _dy2, _dz2)}

        @ps.parallel(outputs=("im2",), bc=bc_im)
        def step_im(im2, re, im, V, g, dt, _dx2, _dy2, _dz2):
            return {"im2": fd.inn(im) - dt * _H(re, re, im, V, g, _dx2, _dy2, _dz2)}

        kernels = (step_re, step_im)

        def raw_step(re, im, V, g, dt, inv2):
            sc = dict(V=V, g=g, dt=dt, _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2])
            re = step_re(re2=re, re=re, im=im, **sc)
            im = step_im(im2=im, re=re, im=im, **sc)
            return re, im

    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)

    def step(re, im, dt, V):
        return raw_step(re, im, V, cfg.g, dt, inv2)

    step.kernels = kernels
    return step


def timestep(grid: Grid) -> float:
    return 0.2 * min(grid.spacing) ** 2   # explicit stability


def _check_ported(cfg: GPConfig) -> None:
    if cfg.checkpoint_dir is not None:
        raise NotImplementedError(
            "--checkpoint-dir is not ported yet (ROADMAP queue 1, item 6: "
            "checkpointed solve_until)"
        )


def solve_guarded(cfg: GPConfig, state=None) -> dict:
    """Drift-guarded run: the mass folds into the fused launch as ``sum_sq``
    epilogues, and ``solve_until(until="above")`` stops once the relative
    drift exceeds ``cfg.tol``, or after ``cfg.nt`` steps."""
    _check_ported(cfg)
    if not cfg.fused:
        raise ValueError(
            "--tol drives the fused coupled kernel; the two-launch scheme "
            "has no single launch to attach the mass epilogue to: drop "
            "--two-launch"
        )
    if cfg.bc == "periodic":
        raise ValueError(
            "--tol needs the fused mass epilogue, which cannot ride a "
            "periodic-bc launch (the reference wraps after its launch)"
        )
    grid, re, im, V = init_state(cfg) if state is None else (make_grid(cfg), *state)
    dt = timestep(grid)
    kern = make_step(grid, cfg).kernels[0]
    rkern = kern.with_reductions({"m_re": "sum_sq(re2)", "m_im": "sum_sq(im2)"})
    mass0 = float(torch.sum(re ** 2 + im ** 2))
    inv2 = tuple(1.0 / d ** 2 for d in grid.spacing)

    def drift_of(reds):
        return torch.abs((reds["m_re"] + reds["m_im"]) - mass0) / mass0

    res = iterate.solve_until(
        rkern, dict(re2=re, im2=im, re=re, im=im, V=V),
        dict(g=cfg.g, dt=dt, _dx2=inv2[0], _dy2=inv2[1], _dz2=inv2[2]),
        tol=cfg.tol, max_iters=cfg.nt, check_every=cfg.check_every,
        error=drift_of, until="above")
    re, im = res.fields["re"], res.fields["im"]
    mass = float(res.reds["m_re"] + res.reds["m_im"])
    return {"grid": grid, "re": re, "im": im, "V": V,
            "mass0": mass0, "mass": mass, "drift": float(res.err),
            "iters": int(res.iters), "host_syncs": res.host_syncs,
            "tripped": bool(res.err > cfg.tol)}


def solve(cfg: GPConfig = GPConfig(), state=None) -> dict:
    """Run ``cfg.nt`` steps (or the drift-guarded run with ``cfg.tol``) from
    ``init_state`` or from ``state = (re, im, V)``."""
    _check_ported(cfg)
    if cfg.tol is not None:
        return solve_guarded(cfg, state)
    grid, re, im, V = init_state(cfg) if state is None else (make_grid(cfg), *state)
    dt = timestep(grid)
    step = make_step(grid, cfg)
    mass0 = float(torch.sum(re ** 2 + im ** 2))
    for _ in range(cfg.nt):
        re, im = step(re, im, dt, V)
    mass = float(torch.sum(re ** 2 + im ** 2))
    drift = abs(mass - mass0) / mass0
    return {"grid": grid, "re": re, "im": im, "V": V,
            "mass0": mass0, "mass": mass, "drift": drift,
            "iters": cfg.nt, "host_syncs": 0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--nt", type=int, default=200)
    ap.add_argument("--g", type=float, default=0.5, help="interaction")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="generated CUDA kernel (default on the card) or plain PyTorch")
    ap.add_argument("--two-launch", action="store_true",
                    help="two radius-1 launches per step")
    ap.add_argument("--bc", default="none",
                    choices=["none", "neumann", "dirichlet", "periodic"],
                    help="boundary condition computed inside the engine step")
    ap.add_argument("--tol", type=float, default=None,
                    help="mass-drift tripwire: run until the relative drift "
                         "exceeds tol; --nt becomes the step cap")
    ap.add_argument("--check-every", type=int, default=10,
                    help="drift cadence (steps per check) in --tol mode")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoints of the --tol run (not ported yet)")
    args = ap.parse_args(argv)
    cfg = GPConfig(n=args.n, nt=args.nt, g=args.g, device=args.device,
                   backend=args.backend, fused=not args.two_launch, bc=args.bc,
                   tol=args.tol, check_every=args.check_every,
                   checkpoint_dir=args.checkpoint_dir)
    r = solve(cfg)
    print(f"GP: {r['iters']} steps on {r['grid'].shape} [{cfg.resolved_backend}"
          f"{'/fused' if cfg.fused else '/two-launch'}/bc={cfg.bc} on {cfg.device}] "
          f"mass drift {r['drift']:.2e} (explicit scheme, O(dt^2) per step)")
    if cfg.tol is not None:
        status = ("TRIPPED: drift crossed tol" if r["tripped"]
                  else "drift stayed under tol")
        print(f"GP drift guard: {status} after {r['iters']} steps (tol={cfg.tol:g}, "
              f"{r['host_syncs']} host syncs)")
    elif r["drift"] >= 0.05:
        raise SystemExit("mass not conserved: numerical instability")


if __name__ == "__main__":
    main()
