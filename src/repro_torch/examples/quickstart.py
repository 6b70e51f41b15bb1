"""Quickstart: the paper's Fig. 1 3-D heat diffusion, math-close notation.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cuda \
        [--n 512] [--nt 100] [--backend cuda|torch]

One kernel source runs on both backends: ``cuda`` generates and launches a
CUDA kernel for the update, ``torch`` evaluates it with PyTorch operators
(the plain path, also on ``--device cpu``). The explicit variant of the
same step (the hand-written kernel ``kernels/csrc/diffusion3d.cu``) runs
beside it from the same initial state and must agree with it bitwise.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs.diffusion3d import Diffusion3DConfig
from ..core import FieldSet, Grid, fd3d as fd, init_parallel_stencil, solve_until
from ..core.iterate import SolveResult
from ..core import teff
from ..data.physics import gaussian_hotspot
from ..kernels import ops


def initial_state(cfg: Diffusion3DConfig, device="cuda"):
    """Grid, fields ``{T2, T, Ci}`` and scalars of Fig. 1 (lines 14-33)."""
    grid = Grid(cfg.shape, (cfg.lx, cfg.ly, cfg.lz))
    fs = FieldSet(grid, device=device)
    T = fs.full(cfg.init_temp) + gaussian_hotspot(grid, amplitude=1.0, width=0.1,
                                                  device=device)
    fields = {"T2": T.clone(), "T": T, "Ci": fs.ones() / cfg.c0}
    _dx, _dy, _dz = grid.inv_spacing
    scalars = {"lam": cfg.lam, "dt": grid.stable_diffusion_dt(cfg.lam / cfg.c0),
               "_dx": _dx, "_dy": _dy, "_dz": _dz}
    return grid, fields, scalars


def make_step(ps):
    """The paper's ``@parallel`` Fig. 1 step; ``rotations`` names the T2 -> T
    double buffer for ``solve_until``."""
    @ps.parallel(outputs=("T2",), rotations={"T2": "T"})
    def step(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx ** 2 + fd.d2_yi(T) * _dy ** 2 +
            fd.d2_zi(T) * _dz ** 2))}

    return step


@dataclasses.dataclass
class QuickstartResult:
    grid: Grid
    step: object                 # the @parallel kernel
    T: torch.Tensor              # after cfg.nt steps of the @parallel step
    T_explicit: torch.Tensor     # after cfg.nt steps of the explicit kernel
    solve: SolveResult           # solve_until from the state after cfg.nt steps


def run(cfg: Diffusion3DConfig, *, device="cuda", backend: str | None = None,
        tol: float = 1e-7, max_iters: int | None = None,
        check_every: int = 10) -> QuickstartResult:
    """The Fig. 1 main path: ``cfg.nt`` steps of the ``@parallel`` step, the
    same steps with the explicit kernel, then ``solve_until`` with the
    error ``max|T2 - T|`` folded into the launch."""
    if backend is None:
        backend = "cuda" if torch.device(device).type == "cuda" else "torch"
    grid, fields, sc = initial_state(cfg, device)
    ps = init_parallel_stencil(backend=backend, device=device)
    step = make_step(ps)

    # Time loop (Fig. 1 lines 34-37)
    T, T2, Ci = fields["T"], fields["T2"], fields["Ci"]
    for _ in range(cfg.nt):
        T2 = step(T2=T2, T=T, Ci=Ci, **sc)
        T, T2 = T2, T

    # The explicit variant from the same initial state
    Te, Te2 = fields["T"], fields["T2"]
    for _ in range(cfg.nt):
        Te2 = ops.diffusion3d_step(Te2, Te, Ci, sc["lam"], sc["dt"], sc["_dx"],
                                   sc["_dy"], sc["_dz"], impl="cuda")
        Te, Te2 = Te2, Te

    # Convergence-driven: the same kernel with a fused error epilogue
    conv = step.with_reductions({"err": "max_abs_diff(T2, T)"})
    res = solve_until(conv, dict(T2=T2, T=T, Ci=Ci), sc, tol=tol,
                      max_iters=10 * cfg.nt if max_iters is None else max_iters,
                      check_every=check_every)
    return QuickstartResult(grid=grid, step=step, T=T, T_explicit=Te, solve=res)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"])
    args = ap.parse_args(argv)
    cfg = Diffusion3DConfig(nx=args.n, ny=args.n, nz=args.n, nt=args.nt)
    r = run(cfg, device=args.device, backend=args.backend)
    print(f"done: {cfg.nt} steps on {r.grid.shape} [{r.step.ps.backend} on "
          f"{args.device}] T in [{float(r.T.min()):.4f}, {float(r.T.max()):.4f}]")
    print(f"explicit kernel: max|T - T_explicit| = "
          f"{float((r.T - r.T_explicit).abs().max()):.3e}")
    print(f"solve_until: {r.solve.iters} steps, max|dT| = {r.solve.err:.2e}, "
          f"{r.solve.host_syncs} host syncs")
    if args.device != "cuda":
        print("T_eff: not measured (timing needs the card)")
        return
    _, fields, sc = initial_state(cfg, args.device)
    m = teff.measure(lambda: r.step(**fields, **sc), iters=10, warmup=2)
    A = teff.a_eff(r.grid.n_points, 2, 1, 4)
    print(f"T_eff = {teff.t_eff(A, m.median_s) / 1e9:.2f} GB/s "
          f"(median {m.median_s * 1e3:.3f} ms, {torch.cuda.get_device_name(0)})")


if __name__ == "__main__":
    main()
