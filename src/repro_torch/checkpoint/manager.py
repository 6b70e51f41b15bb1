"""Checkpoint manager: atomic, versioned, async.

Layout (one directory per step), the reference package's byte for byte:

    <root>/step_000000123/
        manifest.json            — step, time, extra, and for each tensor
                                   its path, file, shape, dtype and nbytes
        t_000000.npy ...         — one .npy per tensor
    <root>/LATEST                — atomically updated pointer

A tree is a dict (or list, tuple) of tensors; its leaves are named by their
keys joined with ``/`` in sorted key order (``err``, ``fields/T``,
``reds/err``), the reference's paths, so a checkpoint that one package
writes restores in the other by path.

numpy has no bfloat16. A bf16 tensor is written as the reference's files
hold it: its 2-byte records under the ``.npy`` descr ``'<V2'``, with the
manifest's dtype ``"bfloat16"``. numpy reads such a file back as ``|V2``;
restore accepts that where the manifest says bfloat16 and views the bytes
as ``torch.bfloat16``. f16 and f32 are native numpy types.

Properties:
  * atomicity: tensors land in ``step_X.tmp/`` and the directory is
    ``os.replace``'d into place, then LATEST is swapped; every tensor file,
    the manifest AND the parent directory entry are fsync'd before the
    swap, so a crash mid-write never corrupts the previous checkpoint and
    a completed swap is durable;
  * async: ``save(..., blocking=False)`` copies each tensor to host memory
    (page-locked buffers for card tensors, kept and reused from save to
    save) and writes on a background thread, so the solve loop stalls only
    for the device-to-host copy. Each save first waits for the previous
    write, so a snapshot never overwrites buffers a write still reads;
  * validation and fallback: restore verifies the manifest against the
    tensor files and the requested tree (shape, dtype, short read); a
    corrupt or truncated checkpoint raises :class:`CheckpointError` and,
    when the step was implicit (LATEST), restore falls back to the
    previous intact step;
  * keep-k retention that never deletes the step LATEST points at, and
    retry with backoff around every filesystem touch
    (:func:`repro_torch.distributed.fault.retry`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..distributed import fault

__all__ = ["CheckpointError", "CheckpointManager"]

BF16 = "bfloat16"
_BF16_DESCR = "<V2"    # what np.save writes for an ml_dtypes bfloat16 array


class CheckpointError(ValueError):
    """A checkpoint is unreadable, torn, or inconsistent with the requested
    restore tree."""


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's order: dict keys sorted,
    sequence items by index, names joined by ``/``."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, values: Mapping[str, Any], prefix: tuple = ()):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(like, Mapping):
        return {k: _unflatten(v, values, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, prefix + (str(i),))
                          for i, v in enumerate(like))
    return values["/".join(prefix)]


def _host_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor's numpy view and its manifest dtype name."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _save_npy(f, arr: np.ndarray, dtype_name: str) -> None:
    """``np.save``'s bytes (a version 1.0 header, then the data; a bf16
    array under the reference's descr ``'<V2'``), the data written in one
    call that releases the interpreter lock: ``np.save`` keeps it while it
    writes, which held the solve loop's launches up while an async write
    ran (``PERF.md`` §6)."""
    arr = np.require(arr, requirements="C")   # keeps a 0-d array 0-d
    header = np.lib.format.header_data_from_array_1_0(arr)
    if dtype_name == BF16:
        header["descr"] = _BF16_DESCR
    np.lib.format.write_array_header_1_0(f, header)
    f.write(memoryview(arr.reshape(-1)).cast("B"))


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_ok(arr: np.ndarray, dtype_name: str) -> bool:
    if dtype_name == BF16:
        return arr.dtype.kind == "V" and arr.dtype.itemsize == 2   # '<V2' reads back as '|V2'
    return str(arr.dtype) == dtype_name


def _fsync_path(path: str) -> None:
    """fsync a file OR directory entry (durability of the rename)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, retry_attempts: int = 4,
                 retry_backoff_s: float = 0.05):
        self.root = root
        self.keep = keep
        self.retry_attempts = retry_attempts
        self.retry_backoff_s = retry_backoff_s
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # page-locked host buffers of card tensors, by (path, shape, dtype)
        self._pinned: dict[tuple, torch.Tensor] = {}

    def _retry(self, fn):
        return fault.retry(fn, attempts=self.retry_attempts, backoff_s=self.retry_backoff_s)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    # ---------------- save ----------------
    def _snapshot(self, paths, vals) -> list[torch.Tensor]:
        """Host copies of ``vals``: card tensors into this manager's pinned
        buffers (one wait for the copies), host tensors cloned."""
        host, devices = [], set()
        for p, v in zip(paths, vals):
            t = torch.as_tensor(v).detach()
            if t.is_cuda:
                key = (p, tuple(t.shape), t.dtype)
                buf = self._pinned.get(key)
                if buf is None:
                    buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                                          pin_memory=True)
                buf.copy_(t, non_blocking=True)
                devices.add(t.device)
            else:
                buf = t.clone()
            host.append(buf)
        for d in devices:
            torch.cuda.current_stream(d).synchronize()
        return host

    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[dict] = None) -> None:
        """Write checkpoint ``step``. ``blocking=False`` returns as soon as
        the device-to-host snapshot completes; the filesystem write runs on
        a daemon thread and any failure surfaces on the next
        ``save``/``wait`` call."""
        self.wait()
        col = _telemetry.get()
        flat = _flatten(tree)
        paths, vals = [p for p, _ in flat], [v for _, v in flat]
        with col.span("checkpoint.snapshot", step=step):
            host_vals = self._snapshot(paths, vals)
        nbytes = sum(v.numel() * v.element_size() for v in host_vals)

        def write():
            w0, t0 = time.time(), time.perf_counter()
            try:
                self._write(step, paths, host_vals, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e
                return
            if col.enabled:   # emitted from the writer thread when async
                col.span_end("checkpoint.write", w0, time.perf_counter() - t0,
                             {"step": step, "bytes": nbytes, "blocking": blocking})
                col.count("checkpoint.saves", 1)
                col.count("checkpoint.bytes_written", nbytes)

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step, paths, host_vals, extra):
        final = self.step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra, "tensors": []}
        for i, (p, v) in enumerate(zip(paths, host_vals)):
            fn = f"t_{i:06d}.npy"
            fpath = os.path.join(tmp, fn)
            arr, dtype_name = _host_array(v)

            def write_tensor(fpath=fpath, arr=arr, dtype_name=dtype_name):
                fault.FaultPlan.active_on_io(fpath)
                with open(fpath, "wb") as f:
                    _save_npy(f, arr, dtype_name)
                    f.flush()
                    os.fsync(f.fileno())

            self._retry(write_tensor)
            manifest["tensors"].append(
                {"path": p, "file": fn, "shape": list(arr.shape), "dtype": dtype_name,
                 "nbytes": int(arr.nbytes)})

        def write_manifest():
            fault.FaultPlan.active_on_io(tmp)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())

        self._retry(write_manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # durability of the rename itself: fsync the parent dir entry BEFORE
        # LATEST starts pointing at it
        self._retry(lambda: _fsync_path(self.root))
        latest_tmp = os.path.join(self.root, "LATEST.tmp")

        def swap_latest():
            fault.FaultPlan.active_on_io(latest_tmp)
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(final))
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest_tmp, os.path.join(self.root, "LATEST"))
            _fsync_path(self.root)

        self._retry(swap_latest)
        plan = fault.FaultPlan.active()
        if plan is not None:
            plan.after_save(final)
        self._gc()

    def _gc(self):
        """keep-k retention. The step LATEST points at is never deleted, even
        when a fallback restore moved LATEST behind newer (broken) step
        directories."""
        if self.keep <= 0:
            return
        steps = self.list_steps()
        latest = self._latest_pointer()
        for s in steps[: -self.keep]:
            if s == latest:
                continue
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    # ---------------- restore ----------------
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _latest_pointer(self) -> Optional[int]:
        """The step LATEST names (None when absent or dangling)."""
        ptr = os.path.join(self.root, "LATEST")
        if os.path.exists(ptr):
            try:
                with open(ptr) as f:
                    name = f.read().strip()
                if os.path.isdir(os.path.join(self.root, name)):
                    return int(name[5:])
            except (OSError, ValueError):
                return None
        return None

    def latest_step(self) -> Optional[int]:
        step = self._latest_pointer()
        if step is not None:
            return step
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _load_manifest(self, step: int) -> dict:
        mpath = os.path.join(self.step_dir(step), "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError as e:
            raise CheckpointError(f"step {step}: no manifest at {mpath}") from e
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointError(f"step {step}: unreadable manifest ({e})") from e
        for key in ("step", "tensors"):
            if key not in manifest:
                raise CheckpointError(f"step {step}: manifest missing {key!r}")
        return manifest

    def _restore_step(self, step: int, like_tree: Any) -> tuple[Any, dict]:
        d = self.step_dir(step)
        manifest = self._load_manifest(step)
        by_path = {t["path"]: t for t in manifest["tensors"]}
        out = {}
        for p, like in _flatten(like_tree):
            if p not in by_path:
                raise CheckpointError(
                    f"step {step}: tree leaf {p!r} absent from checkpoint "
                    f"(has {sorted(by_path)})")
            t = by_path[p]
            fpath = os.path.join(d, t["file"])
            try:
                arr = self._retry(lambda fpath=fpath: np.load(fpath))
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointError(
                    f"step {step}: tensor {p!r} unreadable/truncated "
                    f"({t['file']}: {e})") from e
            # torn-storage guard: the bytes on disk must match what the
            # manifest recorded at write time
            if tuple(arr.shape) != tuple(t.get("shape", arr.shape)):
                raise CheckpointError(
                    f"step {step}: tensor {p!r} shape {tuple(arr.shape)} "
                    f"!= manifest {tuple(t['shape'])} (torn write?)")
            dtype_name = t.get("dtype", str(arr.dtype))
            if not _dtype_ok(arr, dtype_name):
                raise CheckpointError(
                    f"step {step}: tensor {p!r} dtype {arr.dtype} != manifest {dtype_name}")
            if tuple(arr.shape) != tuple(like.shape):
                raise CheckpointError(
                    f"step {step}: tensor {p!r} shape {tuple(arr.shape)} does not match "
                    f"restore target {tuple(like.shape)}: wrong grid/config for this "
                    "checkpoint?")
            out[p] = _as_tensor(arr, dtype_name).to(device=like.device, dtype=like.dtype)
        return (_unflatten(like_tree, out),
                dict(manifest.get("extra") or {}, step=manifest["step"]))

    def restore(self, like_tree: Any, step: Optional[int] = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like_tree`` (a tree of tensors:
        each leaf gives its restored tensor's shape, dtype and device).

        With ``step=None`` the newest step is used, and a corrupt or
        truncated checkpoint falls back to the previous intact one (the
        torn step is reported in the returned extra dict under
        ``"skipped_corrupt"``). An explicitly requested ``step`` never
        falls back: its :class:`CheckpointError` propagates."""
        if step is not None:
            if not os.path.isdir(self.step_dir(step)):
                raise FileNotFoundError(f"no checkpoint step {step} under {self.root}")
            with _telemetry.get().span("checkpoint.restore", step=step):
                return self._restore_step(step, like_tree)
        candidates = self.list_steps()
        latest = self.latest_step()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        # newest first from LATEST (fallback walks strictly older steps)
        candidates = [s for s in reversed(candidates) if s <= latest]
        skipped: list[tuple[int, str]] = []
        col = _telemetry.get()
        for s in candidates:
            try:
                with col.span("checkpoint.restore", step=s):
                    tree, extra = self._restore_step(s, like_tree)
            except CheckpointError as e:
                skipped.append((s, str(e)))
                col.count("checkpoint.corrupt_skipped", 1)
                continue
            if skipped:
                extra["skipped_corrupt"] = skipped
            if col.enabled:
                col.count("checkpoint.restores", 1)
                col.count("checkpoint.bytes_read",
                          sum(v.numel() * v.element_size() for _, v in _flatten(tree)))
            return tree, extra
        raise CheckpointError(
            f"every checkpoint under {self.root} failed validation: "
            + "; ".join(msg for _, msg in skipped))
