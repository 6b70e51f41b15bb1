"""Convergence-driven iteration (``solve_until``).

The paper's solvers iterate until ``err = max|dT|`` drops under a
tolerance. The kernel's fused reduction gives the error as a device scalar
that costs no extra pass over the fields. The reference runs the whole
iteration as one device loop with no host transfers; this port runs a host
loop: each check block is ``check_every - 1`` launches of the plain kernel
and one launch of the checked kernel, then one read of the error scalar on
the host (a device synchronisation). :attr:`SolveResult.host_syncs` counts
those reads, so the gap from the reference's zero stays visible.

``until="below"`` runs while ``err > tol`` (convergence); ``until="above"``
runs while ``err <= tol`` (drift guard). Steps are taken in multiples of
``check_every``: ``iters`` may overshoot ``max_iters`` by at most
``check_every - 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

__all__ = ["SolveResult", "make_solver", "solve_until"]


@dataclasses.dataclass
class SolveResult:
    """Final state of a convergence-driven solve."""

    fields: dict[str, torch.Tensor]   # all field buffers, rotated
    reds: dict[str, torch.Tensor]     # the last check's fused reductions
    err: float                        # last error value
    iters: int                        # steps taken
    host_syncs: int                   # device-to-host reads of the error

    def output(self, kernel) -> Any:
        """The solver's answer: the rotation target of each output holds
        the newest value after the final rotation."""
        tgts = {o: self.fields[t] for o, t in kernel.rotations.items()}
        if len(kernel.outputs) == 1:
            return tgts[kernel.outputs[0]]
        return tgts


def _resolve_error(kernel, error) -> Callable[[Mapping[str, Any]], Any]:
    if error is None:
        if len(kernel.reductions) != 1:
            raise ValueError(
                f"kernel declares reductions {tuple(kernel.reductions)}; "
                "pass error=<name> (or a callable over the reduction dict) "
                "to pick the convergence scalar"
            )
        error = next(iter(kernel.reductions))
    if isinstance(error, str):
        if error not in kernel.reductions:
            raise ValueError(
                f"error={error!r} is not a declared reduction "
                f"(have {tuple(kernel.reductions)})"
            )
        name = error
        return lambda reds: reds[name]
    return error


def make_solver(kernel, scalars: Mapping[str, Any] | None = None, *,
                check_every: int = 1, error: str | Callable | None = None,
                until: str = "below"):
    """Build ``solver(fields, tol, max_iters) -> SolveResult``."""
    if not kernel.reductions:
        raise ValueError(
            "solve_until needs a kernel with fused reductions "
            "(declare reductions={'err': 'max_abs_diff(T2, T)'}-style on @parallel)"
        )
    rot = kernel.rotations
    if not rot or set(kernel.outputs) - set(rot):
        raise ValueError(
            "solve_until rotates double buffers between steps and needs "
            "rotations covering every output (pass rotations={'T2': 'T'}-style "
            "mapping to @parallel)"
        )
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if until not in ("below", "above"):
        raise ValueError(f"until must be 'below' or 'above', got {until!r}")
    err_fn = _resolve_error(kernel, error)
    scalars = dict(scalars or {})
    plain = kernel.with_reductions(None)
    single = len(kernel.outputs) == 1

    def rotate(cur, res):
        outs = {kernel.outputs[0]: res} if single else res
        cur = dict(cur)
        for o, tgt in rot.items():
            cur[o], cur[tgt] = cur[tgt], outs[o]
        return cur

    def solver(fields: Mapping[str, torch.Tensor], tol: float, max_iters: int) -> SolveResult:
        # the error is an f32 value: compare it with tol rounded to f32, as
        # the reference's device loop does
        tol = float(torch.tensor(float(tol), dtype=torch.float32))
        cur = dict(fields)
        reds: dict[str, torch.Tensor] = {}
        err = math.inf if until == "below" else -math.inf
        it = syncs = 0
        while (err > tol if until == "below" else err <= tol) and it < max_iters:
            for _ in range(check_every - 1):
                cur = rotate(cur, plain(**cur, **scalars))
            res, reds = kernel(**cur, **scalars)
            cur = rotate(cur, res)
            it += check_every
            err = float(err_fn(reds))   # the check's one host sync
            syncs += 1
        return SolveResult(fields=cur, reds=reds, err=err, iters=it, host_syncs=syncs)

    return solver


def solve_until(kernel, fields: Mapping[str, torch.Tensor],
                scalars: Mapping[str, Any] | None = None, *, tol: float,
                max_iters: int, check_every: int = 1,
                error: str | Callable | None = None, until: str = "below") -> SolveResult:
    """Iterate ``kernel`` until its fused error scalar crosses ``tol`` (or
    ``max_iters`` steps), checking every ``check_every`` steps.

    ``kernel`` is a :class:`~repro_torch.core.parallel.StencilKernel` with
    ``reductions=`` and ``rotations=`` declared; ``fields`` maps every field
    argument to its initial tensor, ``scalars`` the non-field arguments.
    ``error`` picks the convergence scalar: a reduction name (default: the
    single declared reduction) or a callable over the reduction dict.
    """
    solver = make_solver(kernel, scalars, check_every=check_every, error=error,
                         until=until)
    return solver(fields, tol, max_iters)
