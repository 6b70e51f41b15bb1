"""The roofline position of one generated stencil launch on the card.

The counterpart of ``stencil_roofline`` in the reference's
``src/repro/launch/roofline.py``: from the kernel's analytic cost model
(``ir.StencilCostModel``: flops and bytes traced from the update, no hand
count) and a :class:`~repro_torch.core.teff.HardwareSpec`, the arithmetic
intensity beside the card's ridge, the bytes and compute time bounds, which
one dominates, and with a measured time per step the share of the bound it
reached. Without a spec the bounds are the H100 data sheet's
(``teff.H100_BYTES_PER_S``, ``teff.H100_F32_FLOPS``); pass
``teff.device_spec()`` for the card's measured copy bandwidth.
"""
from __future__ import annotations

from ..core import teff

DATA_SHEET = "NVIDIA H100 SXM data sheet"


def stencil_roofline(cost_model, nsteps: int = 1, hw=None,
                     measured_s: float | None = None,
                     tile=None, march_axis: int | None = None) -> dict:
    """A JSON-able record of one launch of ``nsteps`` sweeps: flops and
    ideal bytes per step (``a_eff_bytes``), intensity and the ridge, the
    compute and bytes times, the dominant term, ``hw`` (the spec's name),
    and with ``measured_s`` (seconds a step) ``frac_of_roofline``, the
    dominant bound over it. With a ``tile`` (the launch's block extent per
    field axis, ``StencilCall.cost_tile``) the refetched bytes of the
    all-parallel launch, and with ``march_axis`` the streamed bytes of the
    launch marching that axis."""
    peak_flops = teff.H100_F32_FLOPS if hw is None else hw.peak_flops
    peak_bw = teff.H100_BYTES_PER_S if hw is None else hw.peak_bw
    flops = float(cost_model.flops.total())
    bytes_step = float(cost_model.a_eff_bytes(nsteps))
    t_c = flops / peak_flops
    t_m = bytes_step / peak_bw
    rec = {
        "hw": DATA_SHEET if hw is None else hw.name,
        "flops_per_step": flops,
        "bytes_per_step": bytes_step,
        "intensity_flop_per_byte": flops / bytes_step if bytes_step else 0.0,
        "ridge_flop_per_byte": peak_flops / peak_bw,
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "dominant": "compute" if t_c >= t_m else "memory",
        "nsteps": nsteps,
        "flop_counts": cost_model.flops.to_dict(),
    }
    if tile is not None:
        rec["tile"] = list(tile)
        rec["refetched_bytes_per_step"] = float(cost_model.fetched_bytes_per_step(tile, nsteps))
        if march_axis is not None:
            rec["march_axis"] = int(march_axis)
            rec["streamed_bytes_per_step"] = float(
                cost_model.a_eff_streamed(tile, nsteps, march_axis))
    if measured_s is not None and measured_s > 0:
        rec["measured_s"] = float(measured_s)
        rec["frac_of_roofline"] = max(t_c, t_m) / measured_s
    return rec
