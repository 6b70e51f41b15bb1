"""T_eff, the paper's effective-memory-throughput performance model.

    T_eff = A_eff / t,     A_eff = n_IO * n_gridpoints * sizeof(eltype)

where ``n_IO`` counts the arrays that must be read or written once per time
step under perfect reuse (Fig. 1: read T and Ci, write T2, so n_IO = 3).

The yardstick is this card's own device-to-device copy bandwidth, measured
at run time (:func:`measure_device_bandwidth`); :func:`device_spec` records
it beside the card's name and power limit. The one constant is the compute
peak of the roofline's other term: the H100 data sheet's f32 rate outside
the tensor cores (:data:`H100_F32_FLOPS`). Timing the card needs the card:
:func:`measure` times with CUDA events and raises without one;
:func:`measure_host` times CPU work by the host clock.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import time
from typing import Callable

import numpy as np
import torch


# NVIDIA's H100 SXM data sheet: f32 operations outside the tensor cores, at
# the full 700 W power limit. The roofline's compute term on the card.
H100_F32_FLOPS = 67e12
# The same data sheet's memory rate: the bytes term of a kernel's bound.
H100_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    power_limit: str   # as nvidia-smi reports it, e.g. "700.00 W"
    peak_bw: float     # bytes/s: the measured device-to-device copy bandwidth
    peak_flops: float = math.inf   # flop/s; inf: no compute term

    @property
    def ridge_intensity(self) -> float:
        """The operations per byte at which the compute term overtakes the
        bytes term (inf without a compute peak)."""
        return self.peak_flops / self.peak_bw


def a_eff(n_points: int, n_read: int, n_write: int, itemsize: int) -> int:
    """Effective bytes moved per step: each counted field crosses memory once."""
    return (n_read + n_write) * n_points * itemsize


def a_eff_blocked(n_points: int, n_read: int, n_write: int, itemsize: int,
                  nsteps: int = 1) -> float:
    """Ideal per-step traffic under k-step temporal blocking: each counted
    field crosses memory once per k steps."""
    return a_eff(n_points, n_read, n_write, itemsize) / max(int(nsteps), 1)


def window_overlap_factor(block, halo, nsteps: int = 1,
                          march_axis: int | None = None) -> float:
    """Read amplification of a tiled launch against ideal once-per-sweep
    streaming: ``prod_a (b_a + k*(lo_a + hi_a)) / b_a`` over the axes whose
    windows overlap (``halo``: an int, or per-axis (lo, hi) pairs). A launch
    that marches ``march_axis`` carries that axis's halo planes on chip, so
    the axis drops out of the product."""
    k = max(int(nsteps), 1)
    block = tuple(int(b) for b in block)
    if isinstance(halo, int):
        halo = ((halo, halo),) * len(block)
    f = 1.0
    for a, (b, (lo, hi)) in enumerate(zip(block, halo)):
        if march_axis is not None and a == march_axis:
            continue
        f *= (b + k * (lo + hi)) / b
    return f


def a_eff_streamed(n_points: int, n_read: int, n_write: int, itemsize: int,
                   nsteps: int = 1, overlap: float = 1.0) -> float:
    """Per-step traffic of a marched launch: each read field fetched about
    once per sweep times the window overlap left on the axes that do not
    march (:func:`window_overlap_factor` without the march axis; 1.0 is
    perfect reuse), each write once, and a k-step launch amortizing both
    over k steps. The refetched all-parallel traffic is the same formula
    with the full overlap factor."""
    return ((n_read * overlap + n_write) * n_points * itemsize
            / max(int(nsteps), 1))


def halo_compute_overhead(block, radius: int, nsteps: int) -> float:
    """Share of redundant cell updates of a k-step launch against k ideal
    sweeps over the block: sweep s updates the block widened by
    ``(k-1-s)*radius`` cells per side (the shrinking halo cone)."""
    k = max(int(nsteps), 1)
    block = tuple(int(b) for b in block)
    ideal = k * math.prod(block)
    total = sum(
        math.prod(b + 2 * (k - 1 - s) * radius for b in block) for s in range(k)
    )
    return total / ideal - 1.0


def a_eff_checked(a_eff_step: float, check_bytes: float, check_every: int = 1,
                  fused: bool = True) -> float:
    """Per-step ideal traffic of a solver that checks convergence every
    ``check_every`` steps: a fused check adds nothing (the per-block
    partials are rounded to zero); a separate norm pass re-reads
    ``check_bytes`` on every check step."""
    m = max(int(check_every), 1)
    return a_eff_step + (0.0 if fused else check_bytes / m)


def io_counts_from_ir(ir) -> tuple[int, int]:
    """(n_read, n_write) from a traced ``repro_torch.ir.StencilIR``: the
    fields the update reads and the outputs it writes, not a hand count."""
    return ir.io_counts()


def a_eff_from_ir(ir, itemsize: int, nsteps: int = 1, field_itemsizes=None) -> float:
    """A_eff derived from the stencil IR's read and write sets, each field at
    its storage width (``field_itemsizes``, ``{field: itemsize}``, defaulting
    to ``itemsize``: 2 for bf16 or f16 fields), over the steps per launch."""
    return ir.io_bytes(itemsize, field_itemsizes=field_itemsizes) / max(int(nsteps), 1)


def sample_step_cost(call) -> tuple[int, int]:
    """(bytes, f32 operations) one live sample's in-place step of a batched
    :class:`~repro_torch.kernels.stencil.StencilCall` needs: each cell of a
    field that the update reads (the core box, the cells it writes, shifted
    by each of its loads) once and each output's core-box cells written
    once, at the storage width; the tap program at each core cell. For a
    program without stages, staggered fields or a bc in the launch, as the
    serving kernel is (its 7-point update reads no edge or corner of T and
    writes only T2's interior); ``ValueError`` for any other."""
    prog, ir = call.program, call.ir
    if prog.stages or any(any(o) for o in prog.offsets) or any(o.bc for o in prog.outputs):
        raise ValueError(f"{call.label}: the batched step cost counts plain all-parallel "
                         "updates only")
    base = tuple(ir.base_shape)
    core = [(lo, n - hi) for (lo, hi), n in zip(ir.halo, base)]
    n_core = math.prod(b - a for a, b in core)
    cells = len(prog.outputs) * n_core
    for f in ir.read_fields:
        read = np.zeros(base, bool)
        for name, shift in prog.core.loads:
            if name == f:
                read[tuple(slice(a + d, b + d) for (a, b), d in zip(core, shift))] = True
        cells += int(read.sum())
    return cells * call.dtype.itemsize, n_core * prog.ops_per_cell()


def t_eff(a_eff_bytes: float, seconds: float) -> float:
    """Effective throughput in bytes/s."""
    return a_eff_bytes / seconds


def fraction(throughput: float, hw: HardwareSpec) -> float:
    return throughput / hw.peak_bw


@dataclasses.dataclass
class Measurement:
    median_s: float
    ci95_s: tuple[float, float]
    samples_s: list[float]

    def t_eff(self, a_eff_bytes: float) -> float:
        return t_eff(a_eff_bytes, self.median_s)

    # jitter over the raw samples: the median alone hides straggling ones
    @property
    def mean_s(self) -> float:
        return float(np.mean(self.samples_s))

    @property
    def p50_s(self) -> float:
        return float(np.percentile(self.samples_s, 50))

    @property
    def p90_s(self) -> float:
        return float(np.percentile(self.samples_s, 90))

    @property
    def max_s(self) -> float:
        return float(max(self.samples_s))

    def percentiles(self) -> dict[str, float]:
        """``{"mean_s", "p50_s", "p90_s", "max_s"}``: the jitter summary a
        row carries beside the median."""
        return {"mean_s": self.mean_s, "p50_s": self.p50_s, "p90_s": self.p90_s,
                "max_s": self.max_s}


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs the card: torch.cuda.is_available() is false")


def measure(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
            inner: int = 1) -> Measurement:
    """Median device time per call of ``fn`` with a bootstrap 95% CI (the
    paper's medians of 20 samples). Each sample is ``inner`` calls between
    two CUDA events on the current stream, after a synchronisation."""
    _require_card()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return _summary([s.elapsed_time(e) / 1e3 / inner for s, e in events])


def _summary(samples: list) -> Measurement:
    med = float(np.median(samples))
    rng = np.random.RandomState(0)
    boots = [float(np.median(rng.choice(samples, size=len(samples)))) for _ in range(200)]
    return Measurement(med, (float(np.percentile(boots, 2.5)),
                             float(np.percentile(boots, 97.5))), samples)


def measure_host(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> Measurement:
    """Median host-clock time per call of ``fn``, for work that runs on the
    CPU (the ``torch`` backend on ``device="cpu"``): a CPU time, never a
    device one."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return _summary(samples)


def measure_device_bandwidth(nbytes: int = 1 << 30, iters: int = 20) -> float:
    """The card's device-to-device copy bandwidth in bytes/s (read + write),
    the T_eff yardstick."""
    _require_card()
    src = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    m = measure(lambda: dst.copy_(src), iters=iters, warmup=3)
    return 2 * src.numel() * 4 / m.median_s


def card_info(index: int = 0) -> tuple[str, str]:
    """(name, power limit) of card ``index`` as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name, power = (p.strip() for p in out.split(",", 1))
    return name, power


def device_spec(index: int = 0, nbytes: int = 1 << 30) -> HardwareSpec:
    """The card's :class:`HardwareSpec`, built at run time. Its compute
    peak is :data:`H100_F32_FLOPS` on an H100; another card has no data
    sheet rate here, so its roofline keeps the memory term only."""
    _require_card()
    name, power = card_info(index)
    with torch.cuda.device(index):
        bw = measure_device_bandwidth(nbytes)
    flops = H100_F32_FLOPS if "H100" in name else math.inf
    return HardwareSpec(name=name, power_limit=power, peak_bw=bw, peak_flops=flops)


def measure_host_bandwidth(nbytes: int = 1 << 28) -> float:
    """A rough STREAM-copy estimate of this host's memory bandwidth in
    bytes/s (read + write): the roofline of the plain path on the CPU."""
    a = np.ones(nbytes // 8, dtype=np.float64)
    b = np.empty_like(a)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        np.copyto(b, a)
    dt = (time.perf_counter() - t0) / reps
    return 2 * a.nbytes / dt
