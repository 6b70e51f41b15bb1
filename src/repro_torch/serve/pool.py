"""Multi-process serving: a pool of OS-process workers over a spool.

The thread-based :class:`~repro_torch.serve.server.SimulationServer`
dies with its process; this pool is the serving analogue of the multihost
gang — N :mod:`repro_torch.serve.procworker` child processes drain a
shared filesystem spool, watched by the SAME supervisor primitives the
solve launcher uses (:func:`repro_torch.launch.multihost.kill_process`,
:func:`~repro_torch.launch.multihost.heartbeat_ages`, run-id-namespaced
:class:`~repro_torch.distributed.fault.Heartbeat` files with stale-run
retirement). Each worker serves on ``device`` (``--device``), the card by
default.

Recovery contract: when a worker dies (exit code) or wedges (stale
heartbeat -> SIGKILL), its claimed-but-unfinished request files are
renamed back into ``pending/`` — their original sequence prefix puts
them at the FRONT of the sorted backlog, so recovery never reorders the
waiting requests — and a replacement worker is spawned (up to
``max_worker_restarts``). The dead incarnation's heartbeat file is
retired before the respawn: a replacement starts with NO liveness file
and is not judged stale until after its own first bump, so the seconds
of interpreter/torch startup (and first-request build) can never be
mistaken for a wedge by the leftover, already-stale file of the worker
it replaces. Zero requests are lost; each resolves with a result file
or a typed error file.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import traceback
import uuid
from typing import Optional

from ..distributed import fault
from ..launch.multihost import (ENV_HEARTBEAT_DIR, ENV_PROCESS_ID,
                                ENV_RUN_ID, heartbeat_ages, kill_process)
from .errors import ServerClosed, WorkerDied
from .procworker import CLOSED_MARKER, read_result, write_request

__all__ = ["ProcessWorkerPool", "ProcTicket"]

# the directory holding the repro_torch package, put on each worker's path
_SRC = str(pathlib.Path(__file__).resolve().parents[2])


class ProcTicket:
    """Handle to one spooled request; resolves from the ``done/`` dir."""

    def __init__(self, pool: "ProcessWorkerPool", name: str):
        self._pool = pool
        self.request_id = name

    def result(self, timeout: Optional[float] = None) -> tuple[dict, dict]:
        """Block for ``(fields, meta)``; raises the typed failure a
        worker recorded, or :class:`WorkerDied` if the pool shut down
        with this request unserved."""
        done = os.path.join(self._pool.spool, "done")
        ok = os.path.join(done, self.request_id)
        err = os.path.join(done, self.request_id + ".err.json")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if os.path.exists(ok):
                return read_result(ok)
            if os.path.exists(err):
                with open(err) as f:
                    detail = json.load(f)
                raise WorkerDied(
                    self.request_id,
                    f"request {self.request_id!r} failed in worker "
                    f"{detail.get('rank')}: {detail.get('error')}: "
                    f"{detail.get('detail')}")
            # failed means ONE rank exhausted its restarts; surviving
            # workers keep draining the spool and may still serve this
            # request — only give up once nobody is left to serve it
            if self._pool.failed and not self._pool._procs:
                raise WorkerDied(self.request_id,
                                 f"request {self.request_id!r} unserved: "
                                 "pool exhausted its worker restarts and "
                                 "no live workers remain")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {self.request_id!r} not done in {timeout}s")
            time.sleep(0.01)


class ProcessWorkerPool:
    def __init__(self, spool: str, workers: int = 2, *,
                 kernel: str = "repro_torch.serve.procworker:demo_kernel",
                 device: str = "cuda",
                 heartbeat_timeout_s: float = 30.0,
                 max_worker_restarts: int = 4,
                 grace_s: float = 2.0,
                 poll_s: float = 0.05,
                 run_id: Optional[str] = None,
                 env: Optional[dict] = None):
        self.spool = spool
        self.n_workers = int(workers)
        self.kernel = kernel
        self.device = device
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_worker_restarts = max_worker_restarts
        self.grace_s = grace_s
        self.poll_s = poll_s
        self.run_id = run_id or f"pool{os.getpid()}"
        self.env = dict(env or {})
        self.heartbeat_dir = os.path.join(spool, "hb")
        self.restarts = 0
        self.recovered = 0
        self.failed = False
        self._seq = 0
        self._lock = threading.Lock()
        self._procs: dict[int, subprocess.Popen] = {}
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._closed = False
        for d in ("pending", "done", "claimed", "hb"):
            os.makedirs(os.path.join(spool, d), exist_ok=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ProcessWorkerPool":
        fault.Heartbeat.retire_stale(self.heartbeat_dir)
        marker = os.path.join(self.spool, CLOSED_MARKER)
        if os.path.exists(marker):
            os.unlink(marker)
        for rank in range(self.n_workers):
            self._spawn(rank)
        self._watcher = threading.Thread(target=self._watch,
                                         name="pool-supervisor", daemon=True)
        self._watcher.start()
        return self

    def _spawn(self, rank: int) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH", "")) if p)
        env.pop(fault.PLAN_ENV, None)   # plans reach workers via self.env
        env[ENV_PROCESS_ID] = str(rank)
        env[ENV_RUN_ID] = self.run_id
        env[ENV_HEARTBEAT_DIR] = self.heartbeat_dir
        env.update(self.env)
        self._procs[rank] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.procworker",
             "--spool", self.spool, "--kernel", self.kernel,
             "--device", self.device, "--rank", str(rank)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def _recover_claims(self, rank: int) -> int:
        """Dead worker's claimed requests go BACK to pending (names keep
        their sequence prefix -> front of the sorted backlog)."""
        claimed = os.path.join(self.spool, "claimed", f"rank_{rank}")
        pending = os.path.join(self.spool, "pending")
        n = 0
        if not os.path.isdir(claimed):
            return 0
        for name in sorted(os.listdir(claimed)):
            if not name.endswith(".npz"):
                continue
            try:
                os.rename(os.path.join(claimed, name),
                          os.path.join(pending, name))
                n += 1
            except OSError:
                continue
        return n

    def _retire_heartbeat(self, hb: fault.Heartbeat, rank: int) -> None:
        """Remove a dead incarnation's liveness file (and any torn tmp).
        Without this, the leftover file — already older than
        ``heartbeat_timeout_s`` — would condemn the freshly spawned
        replacement before it finishes interpreter startup, and the
        watcher would kill-loop replacements until the restart budget
        was gone."""
        for path in (hb.path(rank), hb.path(rank) + ".tmp"):
            try:
                os.unlink(path)
            except OSError:
                pass

    def _watch_once(self, hb: fault.Heartbeat) -> bool:
        """One supervision sweep; True when the drain is complete."""
        for rank, proc in list(self._procs.items()):
            rc = proc.poll()
            stale = (rc is None and heartbeat_ages(hb).get(rank, 0.0)
                     > self.heartbeat_timeout_s)
            if rc is None and not stale:
                continue
            if stale:
                kill_process(proc, self.grace_s)
            self._retire_heartbeat(hb, rank)
            if self._closed and proc.returncode == 0:
                del self._procs[rank]   # clean drain exit
                continue
            self.recovered += self._recover_claims(rank)
            if self.restarts >= self.max_worker_restarts:
                self.failed = True
                del self._procs[rank]
                continue
            self.restarts += 1
            # injected fault plans are one-shot: the replacement
            # worker must not inherit the schedule that killed it
            self.env.pop(fault.PLAN_ENV, None)
            self._spawn(rank)
        return self._closed and not self._procs

    def _watch(self) -> None:
        hb = fault.Heartbeat(self.heartbeat_dir,
                             timeout_s=self.heartbeat_timeout_s,
                             run_id=self.run_id)
        while not self._stop.is_set():
            try:
                if self._watch_once(hb):
                    return
            except Exception:   # supervision must not die silently: an
                # unexpected error (e.g. a filesystem hiccup outside the
                # handled paths) is logged and the next sweep retries
                sys.stderr.write("pool-supervisor: sweep failed "
                                 "(continuing)\n" + traceback.format_exc())
            time.sleep(self.poll_s)

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Drain: drop the CLOSED marker, let workers finish the backlog
        and exit, then stop the watcher (force-kill past ``timeout``)."""
        self._closed = True
        with open(os.path.join(self.spool, CLOSED_MARKER), "w") as f:
            f.write(self.run_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._procs:
            if deadline is not None and time.monotonic() > deadline:
                for proc in self._procs.values():
                    kill_process(proc, self.grace_s)
                break
            time.sleep(self.poll_s)
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
        for proc in self._procs.values():
            kill_process(proc, self.grace_s)
        self._procs.clear()

    def __enter__(self) -> "ProcessWorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------------
    def submit(self, fields: dict, scalars: Optional[dict] = None, *,
               tol: float = 0.0, max_iters: int = 100,
               check_every: int = 1) -> ProcTicket:
        if self._closed:
            raise ServerClosed("(pool)")
        with self._lock:
            seq = self._seq
            self._seq += 1
        name = f"{seq:08d}_{uuid.uuid4().hex[:8]}.npz"
        write_request(
            os.path.join(self.spool, "pending", name), fields,
            {"scalars": {k: float(v) for k, v in (scalars or {}).items()},
             "tol": float(tol), "max_iters": int(max_iters),
             "check_every": int(check_every)})
        return ProcTicket(self, name)
