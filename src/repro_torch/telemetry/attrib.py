"""Roofline-gap attribution: measured per-step seconds against the least
time the card could take for the step.

The paper's argument is T_eff against the bandwidth roofline; a production
solve therefore reports, per kernel launch configuration,

    t_eff_measured    = A_eff / t_step_measured            (bytes/s)
    t_eff_model       = A_eff / t_step_model               (bytes/s)
    roofline_fraction = t_step_model / t_step_measured

where ``t_step_model`` (:func:`least_per_step_s`) prices the port's own
traffic: A_eff (each field the step reads crosses device memory once, each
output once) plus the fused check's per-tile partials at its cadence, over
the memory rate, against the step's flops over the compute rate. The
port's kernels take neighbours' halos from shared memory or L2 and read an
output only at its boundary ring, so A_eff is what they move; the cost
model's ``predict_per_step_s`` prices a TPU launch instead (every tile's
halo and the whole output fetched), which the port's kernels beat. A
fraction near 1.0 means the launch runs at the roofline. A measured step
faster than the model's least time means the yardstick is no bound for
the launch: the record then says ``bounded: false`` and no fraction.

The hardware spec is the card's own on CUDA (:func:`repro_torch.core.teff.
device_spec`: the copy bandwidth measured at run time, and on an H100 the
data sheet's f32 rate outside the tensor cores), and on the CPU a
STREAM-copy measurement of the host. ``REPRO_TELEMETRY_BW_GBS`` /
``REPRO_TELEMETRY_FLOPS_G`` pin it, so numbers need not depend on a noisy
measurement.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["default_hardware", "attribute", "least_per_step_s", "reset_hardware_cache"]

_HW_CACHE: dict = {}      # {"cuda" | "cpu": HardwareSpec} once resolved


def reset_hardware_cache():
    _HW_CACHE.clear()


def default_hardware(device: str = "cpu"):
    """The roofline peak for ``device`` (``"cuda"`` or ``"cpu"``) in this
    process, resolved once and cached."""
    kind = "cuda" if str(device).startswith("cuda") else "cpu"
    if kind in _HW_CACHE:
        return _HW_CACHE[kind]
    from ..core import teff

    bw_env = os.environ.get("REPRO_TELEMETRY_BW_GBS")
    fl_env = os.environ.get("REPRO_TELEMETRY_FLOPS_G")
    if bw_env:
        bw = float(bw_env) * 1e9
        # a CPU-like ridge point unless pinned: ~8 flop/byte
        flops = float(fl_env) * 1e9 if fl_env else 8.0 * bw
        hw = teff.HardwareSpec("pinned", "n/a", peak_bw=bw, peak_flops=flops)
    elif kind == "cuda":
        hw = teff.device_spec()
    else:
        bw = teff.measure_host_bandwidth()
        flops = float(fl_env) * 1e9 if fl_env else 8.0 * bw
        hw = teff.HardwareSpec("host-cpu (STREAM-measured)", "n/a", peak_bw=bw,
                               peak_flops=flops)
    _HW_CACHE[kind] = hw
    return hw


def least_per_step_s(cost, tile, nsteps: int, hw, check_every: Optional[int] = None,
                     fused_checks: bool = True) -> float:
    """The least seconds a step can take on ``hw``: the larger of A_eff
    plus the check's traffic over ``hw.peak_bw`` and the step's flops plus
    the check's over ``hw.peak_flops``. ``cost`` is a
    :class:`~repro_torch.ir.cost.StencilCostModel`; ``tile`` sets the
    fused check's partials (one per tile and reduction)."""
    bytes_ = cost.a_eff_bytes(nsteps)
    flops = float(cost.flops.total())
    if check_every is not None:
        bytes_ += cost.check_bytes_per_step(check_every, fused_checks, tile)
        flops += cost.check_flops.total() / max(int(check_every), 1)
    return max(bytes_ / hw.peak_bw, flops / hw.peak_flops)


def attribute(col, kernel_name: str, per_step_s: float, cost, *,
              nsteps: int = 1, tile=None, march_axis: Optional[int] = None,
              check_every: Optional[int] = None, fused_checks: bool = True,
              hw=None) -> dict:
    """Emit the roofline-gap record for one measured launch configuration.

    ``cost`` is a :class:`~repro_torch.ir.cost.StencilCostModel`; ``tile``
    defaults to the whole grid (the ``torch`` backend's effective tile; a
    CUDA launch passes its own, ``StencilCall.cost_tile``). Emits the gauges
    ``roofline.t_eff_measured_GBs`` / ``..._model_GBs`` labeled by kernel,
    ``roofline.fraction`` when the model bounds the launch (fraction at
    most 1), and one ``roofline`` event carrying the full context; returns
    the computed dict."""
    if per_step_s <= 0:
        return {}
    hw = hw or default_hardware()
    tile = tuple(tile) if tile is not None else tuple(cost.shape)
    a = cost.a_eff_bytes(nsteps)
    t_model = least_per_step_s(cost, tile, nsteps, hw, check_every=check_every,
                               fused_checks=fused_checks)
    t_eff_measured = a / per_step_s
    t_eff_model = a / t_model if t_model > 0 else float("inf")
    frac = t_model / per_step_s
    bounded = frac <= 1.0
    out = {"kernel": kernel_name, "per_step_s": per_step_s,
           "model_per_step_s": t_model, "a_eff_bytes": a,
           "t_eff_measured": t_eff_measured, "t_eff_model": t_eff_model,
           "roofline_fraction": frac if bounded else None, "bounded": bounded,
           "hw": hw.name, "power_limit": hw.power_limit,
           "peak_bw_GBs": hw.peak_bw / 1e9, "tile": tile, "nsteps": nsteps,
           "march_axis": march_axis, "check_every": check_every}
    col.gauge("roofline.t_eff_measured_GBs", t_eff_measured / 1e9, kernel=kernel_name)
    col.gauge("roofline.t_eff_model_GBs", t_eff_model / 1e9, kernel=kernel_name)
    if bounded:
        col.gauge("roofline.fraction", frac, kernel=kernel_name)
    col.event("roofline", **out)
    return out
