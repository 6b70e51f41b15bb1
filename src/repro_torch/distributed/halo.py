"""Halo exchange for block domain decomposition (ImplicitGlobalGrid.jl, C6).

The global grid is split over a :class:`~repro_torch.launch.mesh.RankMesh`
of processes; every rank owns a local tensor that carries ``radius`` ghost
layers per face. ``halo_exchange`` refreshes those ghost layers from the
face-adjacent ranks, one message per (axis, direction), the neighbour
pattern ImplicitGlobalGrid drives through MPI. The reference runs the same
rank-local code under ``shard_map`` with ``lax.ppermute``; here each rank is
a process and the messages are ``torch.distributed`` point-to-point
operations (``batch_isend_irecv``) on the mesh's process group.

Non-periodic boundaries: ranks at the domain edge keep their existing ghost
values (which hold the physical boundary condition); periodic boundaries
wrap to the rank at the opposite edge, and an axis of one rank wraps onto
itself with a local copy.

The exchange writes the ghost layers **in place** and returns the tensors
it was given. Axes are exchanged one after another, so a later axis ships
the ghost cells an earlier axis has just received (the edges and corners
of the ghost ring come out as in the reference). ``begin_exchange`` posts
an exchange without writing anything yet: its :meth:`PendingExchange.
finish` writes the received ghosts on the caller's stream, which is how
``overlap.overlapped_step`` keeps the bulk launch reading the stale ghosts
it has been given. The later axes' messages still carry the earlier
axes' ghosts: each slab is packed with the pending writes it overlaps
pasted into it.

The transport follows the group's backend, which the caller named when it
started the group:

  * ``gloo`` with CPU tensors: the packed slabs go over gloo as they are;
  * ``gloo`` with CUDA tensors: each message is packed on the device into
    one contiguous buffer on a side stream, copied into a pinned host
    buffer, exchanged, copied back and unpacked; gloo never sees a CUDA
    tensor;
  * ``nccl``: device buffers are exchanged directly.

Every wait is bounded by the group's timeout (``init_process_group(
timeout=...)``): a dead peer raises on the ranks that wait for it.

``ExchangeTimer`` splits an exchange's cost into its parts (pack,
device-to-host, send/recv, host-to-device, unpack): CUDA events on the
streams that run them, the host clock for the send/recv.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Mapping, Optional, Sequence

import torch

from .. import telemetry as _telemetry
from . import compression as _comp

__all__ = ["COMPRESS_MODES", "ExchangeTimer", "PendingExchange", "halo_exchange",
           "grouped_halo_exchange", "begin_exchange", "exchange_many",
           "exchange_byte_counts", "global_to_local", "local_block", "local_to_global",
           "owned_slices"]

# Wire formats for ghost payloads. Interiors stay at their dtype while the
# payload ships narrower: "bf16" casts around the message (one bf16
# rounding, relative error <= 2^-8), "int8" block-quantizes through
# ``compression`` (error <= compression.int8_error_bound). Payloads already
# at (or below) the wire width, and non-float payloads, pass through
# uncompressed: compression never widens a message.
COMPRESS_MODES = (None, "bf16", "int8")
PARTS = ("pack", "d2h", "sendrecv", "h2d", "unpack")


def _check_compress(compress):
    if compress not in COMPRESS_MODES:
        raise ValueError(f"compress={compress!r} is not one of {COMPRESS_MODES}")


class ExchangeTimer:
    """Seconds spent in each part of the exchanges it is handed to
    (:data:`PARTS`), summed over them. Device parts are timed with CUDA
    events on the stream that runs them and read at :meth:`seconds`; the
    host's parts with the host clock."""

    def __init__(self):
        self._host = dict.fromkeys(PARTS, 0.0)
        self._events: list = []
        self.exchanges = 0

    @contextlib.contextmanager
    def part(self, name: str, stream=None):
        if stream is None:
            t0 = time.perf_counter()
            yield
            self._host[name] += time.perf_counter() - t0
            return
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        yield
        b.record(stream)
        self._events.append((name, a, b))

    def seconds(self) -> dict[str, float]:
        """Seconds per part so far (waits for the recorded device work)."""
        out = dict(self._host)
        for name, a, b in self._events:
            b.synchronize()
            out[name] += a.elapsed_time(b) / 1e3
        return out


def _part(timer: Optional[ExchangeTimer], name: str, stream=None):
    return contextlib.nullcontext() if timer is None else timer.part(name, stream)


def _axis_depths(depths, radius: int, n_axes: int):
    """Normalize per-axis exchange depths: None -> full radius; an int
    broadcasts; entries are (lo, hi) pairs or ints, within the ghost width
    (the allocation stays ``radius`` layers)."""
    if depths is None:
        return [(radius, radius)] * n_axes
    if isinstance(depths, int):
        depths = [depths] * n_axes
    depths = list(depths)
    if len(depths) != n_axes:
        raise ValueError(
            f"exchange depths {depths} cover {len(depths)} axes but {n_axes} array axes "
            "are decomposed; a short list would silently skip the trailing axes' ghost "
            "refresh")
    out = []
    for d in depths:
        lo, hi = (d, d) if isinstance(d, int) else (int(d[0]), int(d[1]))
        if lo > radius or hi > radius or lo < 0 or hi < 0:
            raise ValueError(f"exchange depth {(lo, hi)} outside the allocated ghost "
                             f"width [0, radius={radius}]")
        out.append((lo, hi))
    return out


def _field_depths(depths, names, radius: int, n_axes: int) -> dict:
    """Normalize a per-field depth mapping (missing fields or None -> full
    radius; entries follow :func:`_axis_depths`)."""
    return {f: _axis_depths(None if depths is None else depths.get(f), radius, n_axes)
            for f in names}


@dataclasses.dataclass
class _Write:
    """New values for the ghost slab ``[start, start + size)`` of a field
    along ``axis`` (the field's full extent on every other axis)."""

    name: str
    axis: int
    start: int
    data: torch.Tensor


@dataclasses.dataclass
class _Message:
    """One message of an axis: the packed slabs ``payload`` to ``dst`` and,
    from ``src``, the ghost slabs ``recv`` = ``[(field, start, shape)]``."""

    dst: Optional[int]
    src: Optional[int]
    payload: Optional[torch.Tensor]
    recv: list
    n: int
    dtype: torch.dtype


def _slab(fields, writes, name: str, axis: int, start: int, size: int) -> torch.Tensor:
    """The slab ``[start, start + size)`` of a field along ``axis``, with the
    pending ghost writes of earlier axes pasted in where they overlap it (a
    copy then; a view otherwise)."""
    s = fields[name].narrow(axis, start, size)
    hits = [w for w in writes if w.name == name and w.axis != axis]
    if not hits:
        return s
    s = s.clone()
    for w in hits:
        s.narrow(w.axis, w.start, w.data.shape[w.axis]).copy_(w.data.narrow(axis, start, size))
    return s


def _wire(compress, is_float: bool, itemsize: int):
    """The format a payload of this dtype ships in under ``compress``:
    compression never widens a message, and non-float payloads pass
    through."""
    if compress == "bf16" and is_float and itemsize > 2:
        return "bf16"
    if compress == "int8" and is_float and itemsize > 1:
        return "int8"
    return None


def _encode(payload: torch.Tensor, compress) -> list[torch.Tensor]:
    fmt = _wire(compress, payload.dtype.is_floating_point, payload.dtype.itemsize)
    if fmt == "bf16":
        return [payload.to(torch.bfloat16)]
    if fmt == "int8":
        q, scale, _ = _comp.quantize_int8(payload)
        return [q, scale]
    return [payload]


def _wire_like(n: int, dtype: torch.dtype, compress, device) -> list[torch.Tensor]:
    fmt = _wire(compress, dtype.is_floating_point, dtype.itemsize)
    if fmt == "bf16":
        return [torch.empty(n, dtype=torch.bfloat16, device=device)]
    if fmt == "int8":
        nb = -(-n // _comp.BLOCK)
        return [torch.empty((nb, _comp.BLOCK), dtype=torch.int8, device=device),
                torch.empty((nb, 1), dtype=torch.float32, device=device)]
    return [torch.empty(n, dtype=dtype, device=device)]


def _decode(wire: list[torch.Tensor], n: int, compress) -> torch.Tensor:
    if len(wire) == 2:
        return _comp.dequantize_int8(wire[0], wire[1], ((n,), (-n) % _comp.BLOCK))
    return wire[0]


_COMM_STREAMS: dict = {}
_PINNED: dict = {}


def _comm_stream(dev: torch.device):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    s = _COMM_STREAMS.get(idx)
    if s is None:
        s = _COMM_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


def _pinned(key, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped as ``like``, reused across calls under
    ``key`` (pinning memory is slow)."""
    key = (key, tuple(like.shape), like.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return buf


def _transport(mesh, msgs: list[_Message], compress, axis: int, dev: torch.device,
               staged: bool, stream, timer) -> list[Optional[torch.Tensor]]:
    """Post every message of one axis as one batch and wait for it; the
    received payloads (None where a message has no source)."""
    import torch.distributed as dist

    sends, recvs = [], []
    with _part(timer, "pack", stream):
        for m in msgs:
            sends.append(_encode(m.payload, compress) if m.dst is not None else None)
            recvs.append(_wire_like(m.n, m.dtype, compress, dev)
                         if m.src is not None else None)
    if staged:
        host_s = [None if w is None else [_pinned(("s", axis, i, j), t) for j, t in enumerate(w)]
                  for i, w in enumerate(sends)]
        host_r = [None if w is None else [_pinned(("r", axis, i, j), t) for j, t in enumerate(w)]
                  for i, w in enumerate(recvs)]
        with _part(timer, "d2h", stream):
            for hs, ws in zip(host_s, sends):
                for h, t in zip(hs or (), ws or ()):
                    h.copy_(t, non_blocking=True)
        stream.synchronize()
        wire_s, wire_r = host_s, host_r
    else:
        wire_s, wire_r = sends, recvs
    ops = []
    for i, (m, ws, wr) in enumerate(zip(msgs, wire_s, wire_r)):
        for j, t in enumerate(ws or ()):
            ops.append(dist.P2POp(dist.isend, t, m.dst, group=mesh.group, tag=4 * i + j))
        for j, t in enumerate(wr or ()):
            ops.append(dist.P2POp(dist.irecv, t, m.src, group=mesh.group, tag=4 * i + j))
    if ops:
        with _part(timer, "sendrecv"):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if staged:
        with _part(timer, "h2d", stream):
            for hr, wr in zip(host_r, recvs):
                for h, t in zip(hr or (), wr or ()):
                    t.copy_(h, non_blocking=True)
    with _part(timer, "unpack", stream):
        return [None if wr is None else _decode(wr, m.n, compress)
                for m, wr in zip(msgs, recvs)]


class PendingExchange:
    """An exchange whose messages have been sent and received, with its
    ghost writes not yet made: :meth:`finish` makes them (on the caller's
    current stream, behind the side stream's work) and returns the
    fields."""

    def __init__(self, fields: dict, writes: list[_Write], event, timer):
        self.fields = fields
        self.writes = writes
        self._event = event
        self._timer = timer

    def finish(self) -> dict:
        cur = None
        if self._event is not None:
            cur = torch.cuda.current_stream(self._event.device)
            cur.wait_event(self._event)
        with _part(self._timer, "unpack", cur):
            for w in self.writes:
                if cur is not None:
                    w.data.record_stream(cur)
                self.fields[w.name].narrow(w.axis, w.start, w.data.shape[w.axis]).copy_(w.data)
        self.writes = []
        return self.fields


def begin_exchange(
    fields: Mapping[str, torch.Tensor],
    names: Sequence[str],
    mesh,
    array_axes: Sequence[int] | None = None,
    radius: int = 1,
    periodic: bool | Sequence[bool] = False,
    depths: Mapping[str, object] | None = None,
    compress: str | None = None,
    grouped: bool = True,
    timer: ExchangeTimer | None = None,
    ready=None,
) -> PendingExchange:
    """Exchange the ghost layers of ``names`` over ``mesh`` (arguments as
    for :func:`grouped_halo_exchange`) and return the writes still to make.

    The mesh's axes are the decomposed ones, in order: mesh axis ``i``
    splits array axis ``array_axes[i]`` (default: the leading axes). With
    ``grouped`` one message per (axis, direction, dtype) carries every
    field's slab; otherwise one message per field. On the card the side
    stream starts behind ``ready`` (a CUDA event recorded where the fields
    are ready), or behind everything queued on the current stream."""
    _check_compress(compress)
    names = list(names)
    n_axes = len(mesh.shape)
    array_axes = list(range(n_axes)) if array_axes is None else [int(a) for a in array_axes]
    if len(array_axes) != n_axes:
        raise ValueError(f"array_axes {array_axes} must name one array axis per mesh axis "
                         f"{mesh.axes}")
    periodic = [periodic] * n_axes if isinstance(periodic, bool) else list(periodic)
    r = int(radius)
    fdep = _field_depths(depths, names, r, n_axes)
    if grouped:
        by_dtype: dict = {}
        for f in names:
            by_dtype.setdefault(fields[f].dtype, []).append(f)
        groups = list(by_dtype.values())
    else:
        groups = [[f] for f in names]
    fields = dict(fields)
    dev = fields[names[0]].device if names else torch.device("cpu")
    cuda = dev.type == "cuda"
    staged = cuda and mesh.backend == "gloo"
    stream = _comm_stream(dev) if cuda else None
    if cuda:
        if ready is None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        else:
            stream.wait_event(ready)
    writes: list[_Write] = []
    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        for i, (ax, per) in enumerate(zip(array_axes, periodic)):
            if mesh.axis_size(i) == 1:
                if per:
                    # self-wrap: the ghost layers come from the rank's own
                    # opposite interior
                    with _part(timer, "unpack", stream):
                        for f in names:
                            (d_lo, d_hi), n = fdep[f][i], fields[f].shape[ax]
                            wrap = [(r - d_lo, n - r - d_lo, d_lo), (n - r, r, d_hi)]
                            writes += [_Write(f, ax, dst, _slab(fields, writes, f, ax, src, d)
                                              .clone()) for dst, src, d in wrap if d]
                continue
            right, left = mesh.neighbor(i, 1, per), mesh.neighbor(i, -1, per)
            msgs = []
            for grp in groups:
                # side 0: my high interior slab -> right neighbour's low ghost;
                # side 1: my low interior slab -> left neighbour's high ghost
                for side, (dst, src) in enumerate(((right, left), (left, right))):
                    sent = [f for f in grp if fdep[f][i][side]]
                    if not sent or (dst is None and src is None):
                        continue
                    slabs, recv = [], []
                    for f in sent:
                        d, n = fdep[f][i][side], fields[f].shape[ax]
                        send_at, recv_at = (n - r - d, r - d) if side == 0 else (r, n - r)
                        shape = list(fields[f].shape)
                        shape[ax] = d
                        recv.append((f, recv_at, tuple(shape)))
                        if dst is not None:
                            slabs.append(_slab(fields, writes, f, ax, send_at, d))
                    payload = None
                    if dst is not None:
                        with _part(timer, "pack", stream):
                            payload = torch.cat([s.reshape(-1) for s in slabs])
                    msgs.append(_Message(dst, src, payload, recv,
                                         sum(math.prod(s) for _, _, s in recv),
                                         fields[sent[0]].dtype))
            received = _transport(mesh, msgs, compress, i, dev, staged, stream, timer)
            with _part(timer, "unpack", stream):
                for m, got in zip(msgs, received):
                    if got is None:
                        continue
                    ofs = 0
                    for f, at, shape in m.recv:
                        k = math.prod(shape)
                        piece = got[ofs:ofs + k].reshape(shape).to(fields[f].dtype)
                        writes.append(_Write(f, ax, at, piece))
                        ofs += k
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(stream)
    if timer is not None:
        timer.exchanges += 1
    return PendingExchange(fields, writes, event, timer)


def halo_exchange(
    local: torch.Tensor,
    mesh,
    array_axes: Sequence[int] | None = None,
    radius: int = 1,
    periodic: bool | Sequence[bool] = False,
    depths=None,
    compress: str | None = None,
    timer: ExchangeTimer | None = None,
) -> torch.Tensor:
    """Refresh the ghost layers of ``local`` along each decomposed axis, in
    place; returns ``local``.

    Args:
      local: rank-local tensor with ``radius`` ghost layers on decomposed axes.
      mesh: the :class:`~repro_torch.launch.mesh.RankMesh`; its axis ``i``
        splits array axis ``array_axes[i]`` (default: the leading axes).
      radius: ghost width (the allocation).
      periodic: global wrap per axis (a bool broadcasts).
      depths: optional per-axis (lo, hi) *exchange* depths <= radius (the
        footprint-inferred read depths): only the innermost ``lo`` cells
        of the low ghost ring / ``hi`` of the high ring are refreshed.
        None refreshes the full ring.
      compress: the ghost payload's wire format, ``"bf16"`` or ``"int8"``
        (:data:`COMPRESS_MODES`). Ghosts land back at the tensor's dtype;
        interiors are untouched. Single-rank self-wraps are local copies
        and stay exact.
      timer: an :class:`ExchangeTimer` to charge the parts to.
    """
    return grouped_halo_exchange({"_": local}, ("_",), mesh, array_axes, radius, periodic,
                                 None if depths is None else {"_": depths}, compress,
                                 timer)["_"]


def grouped_halo_exchange(
    fields: Mapping[str, torch.Tensor],
    names: Sequence[str],
    mesh,
    array_axes: Sequence[int] | None = None,
    radius: int = 1,
    periodic: bool | Sequence[bool] = False,
    depths: Mapping[str, object] | None = None,
    compress: str | None = None,
    timer: ExchangeTimer | None = None,
) -> dict:
    """Refresh the ghost layers of *all* ``names`` (in place) with ONE
    message per (axis, direction, dtype) instead of one per field: the
    per-field face slabs are flattened and concatenated into one payload
    per dtype group, then split and written back. For a coupled system of
    F fields this turns ``2 * ndim * F`` messages into ``2 * ndim``, the
    latency win ImplicitGlobalGrid gets from posting a system's messages
    together. Staggered fields group fine: only their slab sizes differ.

    ``depths`` (per field, per axis (lo, hi) <= radius) shrinks each
    field's slab to what the stencil reads; a field of depth 0 on a side
    adds nothing to that direction's payload. ``compress`` applies to each
    concatenated payload. Returns a dict of the (updated) field tensors."""
    return begin_exchange(fields, names, mesh, array_axes, radius, periodic, depths,
                          compress, True, timer).finish()


def _wire_bytes(n_elems: int, itemsize: int, is_float: bool, compress: str | None) -> int:
    """Wire bytes of one payload of ``n_elems`` homogeneous elements under a
    wire format (bf16 = 2 B/elt when narrowing applies; int8 = BLOCK-padded
    1 B/elt plus one f32 scale per block)."""
    fmt = _wire(compress, is_float, itemsize)
    if fmt == "bf16":
        return n_elems * 2
    if fmt == "int8":
        n_blocks = -(-n_elems // _comp.BLOCK)
        return n_blocks * _comp.BLOCK + n_blocks * 4
    return n_elems * itemsize


def exchange_byte_counts(
    shapes: Mapping[str, Sequence[int]],
    itemsizes: Mapping[str, int],
    float_fields: Mapping[str, bool],
    n_axes: int,
    radius: int = 1,
    depths: Mapping[str, object] | None = None,
    compress: str | None = None,
    grouped: bool = True,
    active: Sequence[bool] | None = None,
    dtype_groups: Sequence[Sequence[str]] | None = None,
) -> dict:
    """Analytic per-rank payload bytes of ONE :func:`exchange_many` call
    (host arithmetic over shapes). Returns ``{"bytes_raw", "bytes_wire",
    "messages"}``: *raw* prices every slab at its storage width, *wire*
    applies the wire format per message (per dtype group when ``grouped``,
    per field otherwise). ``active`` masks axes whose mesh extent is 1
    (no messages). These are the bytes a rank sends; an interior rank
    receives as many, an edge rank of a non-periodic axis sends to and
    receives from one side only."""
    names = list(shapes)
    fdep = _field_depths(depths, names, radius, n_axes)
    if active is None:
        active = [True] * n_axes
    if dtype_groups is None:
        if grouped:
            by_key: dict = {}
            for f in names:
                by_key.setdefault((itemsizes[f], float_fields[f]), []).append(f)
            dtype_groups = list(by_key.values())
        else:
            dtype_groups = [[f] for f in names]
    raw = wire = messages = 0
    for ax in range(n_axes):
        if not active[ax]:
            continue
        for side in (0, 1):
            for grp in dtype_groups:
                sent = [f for f in grp if fdep[f][ax][side]]
                if not sent:
                    continue
                elems = sum(fdep[f][ax][side]
                            * math.prod(s for a, s in enumerate(shapes[f]) if a != ax)
                            for f in sent)
                isz, is_f = itemsizes[sent[0]], float_fields[sent[0]]
                raw += elems * isz
                wire += _wire_bytes(elems, isz, is_f, compress)
                messages += 2 if _wire(compress, is_f, isz) == "int8" else 1
    return {"bytes_raw": int(raw), "bytes_wire": int(wire), "messages": int(messages)}


_TRACED: set = set()


def _emit_exchange_telemetry(col, fields, names, mesh, radius, depths, compress, grouped):
    """Byte accounting of an exchange geometry, emitted once per collector
    and geometry (the reference emits it once per trace), never per step:
    the gauges carry per-exchange bytes; multiply by the exchanges for
    totals. ``mesh`` None counts every axis of the fields' rank as
    active."""
    names = list(names)
    if mesh is None:
        active = None
        n_axes = fields[names[0]].dim()
    else:
        active = [n > 1 for n in mesh.shape]
        n_axes = len(active)
    shp = {f: tuple(fields[f].shape) for f in names}
    isz = {f: fields[f].dtype.itemsize for f in names}
    isf = {f: fields[f].dtype.is_floating_point for f in names}
    key = (id(col), tuple(sorted(shp.items())), tuple(sorted(isz.items())), radius,
           repr(depths), compress, grouped, None if active is None else tuple(active))
    if key in _TRACED:
        return
    _TRACED.add(key)
    counts = exchange_byte_counts(shp, isz, isf, n_axes, radius=radius, depths=depths,
                                  compress=compress, grouped=grouped, active=active)
    col.event("halo.exchange_traced", fields=names, radius=radius, compress=compress,
              grouped=grouped, **counts)
    col.gauge("halo.bytes_raw_per_exchange", counts["bytes_raw"], compress=str(compress))
    col.gauge("halo.bytes_wire_per_exchange", counts["bytes_wire"], compress=str(compress))
    col.count("halo.traced_exchanges", 1)


def exchange_many(
    fields: Mapping[str, torch.Tensor],
    names: Sequence[str],
    mesh,
    radius: int = 1,
    periodic=False,
    grouped: bool = True,
    depths: Mapping[str, object] | None = None,
    compress: str | None = None,
    timer: ExchangeTimer | None = None,
) -> dict:
    """Refresh the ghost layers of several fields, in place; returns a dict
    of the field tensors. ``grouped=True`` sends the whole field group per
    (axis, direction) in one message (:func:`grouped_halo_exchange`);
    ``grouped=False`` one message per field. ``depths`` tightens each
    field's slab to its per-axis (lo, hi) read depth; ``compress`` selects
    the wire format (:func:`halo_exchange`)."""
    return begin_many(fields, names, mesh, radius, periodic, grouped, depths, compress,
                      timer).finish()


def begin_many(fields, names, mesh, radius: int = 1, periodic=False, grouped: bool = True,
               depths=None, compress: str | None = None,
               timer: ExchangeTimer | None = None, ready=None) -> PendingExchange:
    """:func:`exchange_many` with the ghost writes left pending
    (:class:`PendingExchange`; ``ready`` as for :func:`begin_exchange`),
    emitting the same telemetry."""
    _check_compress(compress)
    col = _telemetry.get()
    if col.enabled:
        _emit_exchange_telemetry(col, fields, names, mesh, radius, depths, compress, grouped)
    return begin_exchange(fields, names, mesh, radius=radius, periodic=periodic,
                          depths=depths, compress=compress, grouped=grouped, timer=timer,
                          ready=ready)


def _block_slices(shape, factors: Sequence[int], index: Sequence[int], radius: int):
    r = radius
    sl = []
    for ax, (i, f) in enumerate(zip(index, factors)):
        step = (shape[ax] - 2 * r) // f
        sl.append(slice(i * step, i * step + step + 2 * r))
    return tuple(sl) + (slice(None),) * (len(shape) - len(factors))


def local_block(global_arr: torch.Tensor, factors: Sequence[int], index: Sequence[int],
                radius: int = 1) -> torch.Tensor:
    """The local block (with its ghost layers) of the rank at mesh
    coordinates ``index``, cut from the global tensor (physical boundary
    layers included) as a new contiguous tensor: how a rank builds its
    own block from the global arrays it is given."""
    return global_arr[_block_slices(global_arr.shape, factors, index, radius)].clone()


def global_to_local(global_arr: torch.Tensor, factors: Sequence[int],
                    radius: int = 1) -> list[torch.Tensor]:
    """Split a global tensor (with physical boundary layers) into per-rank
    local blocks with ghost layers, as a flat list in row-major rank
    order."""
    import itertools

    return [local_block(global_arr, factors, idx, radius)
            for idx in itertools.product(*(range(f) for f in factors))]


def owned_slices(shape: Sequence[int], factors: Sequence[int], index: Sequence[int],
                 radius: int = 1) -> tuple[slice, ...]:
    """The part of a local block of ``shape`` that the rank at ``index``
    owns in the global array: its interior, widened to the physical
    boundary layers on the global edges. Over all ranks these parts tile
    the global array once (what :func:`local_to_global` stitches)."""
    r = radius
    sl = [slice(0 if i == 0 else r, n - (0 if i == f - 1 else r))
          for n, i, f in zip(shape, index, factors)]
    return tuple(sl) + (slice(None),) * (len(shape) - len(factors))


def local_to_global(locals_: Sequence[torch.Tensor], factors: Sequence[int],
                    radius: int = 1) -> torch.Tensor:
    """Inverse of :func:`global_to_local` (interior stitching)."""
    import itertools

    r = radius
    sample = locals_[0]
    inner = [s - 2 * r for s in sample.shape[:len(factors)]]
    gshape = [i * f + 2 * r for i, f in zip(inner, factors)] + list(sample.shape[len(factors):])
    g = torch.zeros(gshape, dtype=sample.dtype, device=sample.device)
    for loc, idx in zip(locals_, itertools.product(*(range(f) for f in factors))):
        own = owned_slices(loc.shape, factors, idx, r)
        dst = tuple(slice(i * n + s.start, i * n + s.stop)
                    for i, n, s in zip(idx, inner, own[:len(factors)]))
        g[dst + own[len(factors):]] = loc[own]
    return g
