"""Fault tolerance and straggler mitigation for long multi-pod runs.

Pieces that run *around* the step (host-side control plane):

  * StepMonitor — per-step wall-time EWMA + straggler flagging. On a real
    multi-host deployment every host appends its step time to a heartbeat
    file on shared storage; `check_peers` flags hosts whose EWMA exceeds
    the fleet median by `straggler_factor` (the mitigation at scale is to
    checkpoint + evict + restart). Simulated multi-host in tests by
    writing several heartbeat files.

  * Heartbeat — liveness: a host that has not bumped its file within
    `timeout_s` is declared dead -> the launcher triggers restore from the
    last checkpoint on the surviving mesh.

  * retry — transient-failure wrapper for host-side I/O (checkpoint
    writes/reads, heartbeat bumps, autotune cache): exponential backoff
    with deterministic jitter so a thundering herd of 1000 hosts
    retrying a shared filesystem decorrelates.

  * FaultPlan — the deterministic fault-injection harness. A plan is a
    small JSON dict in the ``REPRO_FAULT_PLAN`` env var, so subprocess
    tests and CI can inject *real* failures (the process dies, a
    checkpoint is torn on disk, an open() raises) into unmodified
    ``solve_until`` runs at exactly reproducible points:

        REPRO_FAULT_PLAN='{"kill_at_step": 60}'            # SIGKILL-style death
        REPRO_FAULT_PLAN='{"hang_at_step": 40, "hang_s": 5}'  # straggler/hang
        REPRO_FAULT_PLAN='{"corrupt_checkpoint": 2}'       # tear the 2nd save
        REPRO_FAULT_PLAN='{"io_errors": 3}'                # 3 transient EIOs

    The engine's checkpointing driver calls the plan's hooks at its
    natural boundaries (``on_step`` at reduction-check/save boundaries,
    ``on_io`` before guarded host I/O, ``after_save`` after each
    checkpoint write); a process without the env var pays one cached
    ``None`` check.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Callable, Optional

from .. import telemetry as _telemetry

# exit code of a FaultPlan-injected kill: distinguishable from real crashes
# (tracebacks exit 1) so launchers/tests can assert the *planned* death
KILL_EXIT_CODE = 113


class TransientIOError(OSError):
    """Injected transient I/O failure (FaultPlan.on_io)."""


class RankFailure(RuntimeError):
    """A peer rank stopped heartbeating: checkpoint-restore on the
    surviving mesh is required. Carries ``.dead`` (sorted rank ids)."""

    def __init__(self, dead, msg: Optional[str] = None):
        self.dead = sorted(dead)
        super().__init__(msg or f"dead ranks (stale heartbeats): {self.dead}")


@dataclasses.dataclass
class StepStats:
    ewma_s: float = 0.0
    n: int = 0
    last_s: float = 0.0

    def update(self, dt: float, alpha: float = 0.1) -> None:
        self.last_s = dt
        self.ewma_s = dt if self.n == 0 else (1 - alpha) * self.ewma_s + alpha * dt
        self.n += 1


class Heartbeat:
    """Per-rank liveness file on shared storage.

    ``bump(step)`` atomically rewrites ``host_<rank>.json`` (retried —
    shared filesystems hiccup); ``dead_ranks(expected)`` returns the
    ranks whose file is missing or older than ``timeout_s``. Kept
    separate from :class:`StepMonitor` so a launcher can watch liveness
    without importing any timing state."""

    def __init__(self, directory: str, rank: int = 0, timeout_s: float = 300.0,
                 run_id: Optional[str] = None):
        self.dir = directory
        self.rank = rank
        self.timeout_s = timeout_s
        self.run_id = run_id
        os.makedirs(directory, exist_ok=True)

    def _prefix(self) -> str:
        return f"{self.run_id}." if self.run_id else ""

    def path(self, rank: Optional[int] = None) -> str:
        rank = self.rank if rank is None else rank
        return os.path.join(self.dir, f"{self._prefix()}host_{rank}.json")

    def bump(self, step: int, ewma_s: float = 0.0) -> None:
        def write():
            FaultPlan.active_on_io(self.path())
            tmp = self.path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "t": time.time(), "ewma_s": ewma_s,
                           "run_id": self.run_id}, f)
            os.replace(tmp, self.path())
        retry(write)

    def read_all(self) -> dict[int, dict]:
        """Heartbeats of THIS run only: files are matched by the run-id
        prefix, so liveness left behind by a previous (dead) world in the
        same directory can never vouch for a rank in this one."""
        beats = {}
        prefix = self._prefix() + "host_"
        for fn in os.listdir(self.dir):
            if not (fn.startswith(prefix) and fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dir, fn)) as f:
                    beats[int(fn[len(prefix):-5])] = json.load(f)
            except (json.JSONDecodeError, ValueError, OSError):
                continue  # torn write — treat as missing this round
        return beats

    @staticmethod
    def retire_stale(directory: str,
                     keep_run_id: Optional[str] = None) -> list[str]:
        """Delete heartbeat files in ``directory`` that do not belong to
        ``keep_run_id`` (all of them when None). Launchers call this at
        world startup so a fresh gang never reads a previous run's
        liveness. Concurrent deletion is tolerated; returns the retired
        file names."""
        if not os.path.isdir(directory):
            return []
        keep_prefix = f"{keep_run_id}.host_" if keep_run_id else None
        retired = []
        for fn in os.listdir(directory):
            if "host_" not in fn or not (fn.endswith(".json")
                                         or fn.endswith(".json.tmp")):
                continue
            if keep_prefix is not None and fn.startswith(keep_prefix):
                continue
            try:
                os.unlink(os.path.join(directory, fn))
                retired.append(fn)
            except OSError:
                continue
        return sorted(retired)

    def dead_ranks(self, expected: Optional[list[int]] = None,
                   now: Optional[float] = None) -> list[int]:
        now = time.time() if now is None else now
        beats = self.read_all()
        dead = [h for h, b in beats.items() if now - b["t"] > self.timeout_s]
        if expected is not None:
            dead += [h for h in expected if h not in beats]
        return sorted(set(dead))


class StepMonitor:
    def __init__(self, host_id: int = 0, heartbeat_dir: Optional[str] = None,
                 straggler_factor: float = 1.5, timeout_s: float = 300.0,
                 run_id: Optional[str] = None):
        self.host_id = host_id
        self.dir = heartbeat_dir
        self.factor = straggler_factor
        self.timeout_s = timeout_s
        self.stats = StepStats()
        self.heartbeat = (Heartbeat(heartbeat_dir, rank=host_id,
                                    timeout_s=timeout_s, run_id=run_id)
                          if heartbeat_dir else None)

    def record(self, step: int, dt: float) -> None:
        self.stats.update(dt)
        if self.heartbeat is not None:
            self.heartbeat.bump(step, ewma_s=self.stats.ewma_s)
        col = _telemetry.get()
        if col.enabled:
            col.gauge("fault.ewma_step_s", self.stats.ewma_s,
                      rank=self.host_id)
            col.gauge("fault.last_step_s", dt, rank=self.host_id)

    def check_peers(self, now: Optional[float] = None) -> dict:
        """Returns {"dead": [...], "stragglers": [...], "healthy": n}.

        With telemetry enabled the health verdict is also surfaced as
        gauges (healthy/straggler/dead counts, per-peer heartbeat lag
        and EWMA) — the run reports a straggling rank instead of only
        dying on a dead one."""
        now = time.time() if now is None else now
        if self.heartbeat is None:
            return {"dead": [], "stragglers": [], "healthy": 1}
        beats = self.heartbeat.read_all()
        dead = [h for h, b in beats.items() if now - b["t"] > self.timeout_s]
        alive = {h: b for h, b in beats.items() if h not in dead}
        if alive:
            med = sorted(b["ewma_s"] for b in alive.values())[len(alive) // 2]
            stragglers = [h for h, b in alive.items()
                          if med > 0 and b["ewma_s"] > self.factor * med]
        else:
            stragglers = []
        col = _telemetry.get()
        if col.enabled:
            col.gauge("fault.healthy_ranks", len(alive) - len(stragglers))
            col.gauge("fault.straggler_ranks", len(stragglers))
            col.gauge("fault.dead_ranks", len(dead))
            for h, b in beats.items():
                col.gauge("fault.heartbeat_lag_s", now - b["t"], rank=h)
                col.gauge("fault.peer_ewma_step_s", b.get("ewma_s", 0.0),
                          rank=h)
        return {"dead": sorted(dead), "stragglers": sorted(stragglers),
                "healthy": len(alive) - len(stragglers)}

    def snapshot(self) -> dict[int, dict[str, float]]:
        """Per-rank EWMA step stats: this rank's live :class:`StepStats`
        plus every peer's last heartbeat. This is what
        :class:`~repro_torch.core.iterate.SolveResult.step_stats` carries
        out of a monitored solve."""
        out = {self.host_id: {"ewma_s": self.stats.ewma_s,
                              "last_s": self.stats.last_s,
                              "n": self.stats.n}}
        if self.heartbeat is not None:
            for h, b in self.heartbeat.read_all().items():
                if h != self.host_id:
                    out[h] = {"ewma_s": b.get("ewma_s", 0.0),
                              "last_s": b.get("ewma_s", 0.0),
                              "n": b.get("step", 0)}
        col = _telemetry.get()
        if col.enabled:
            for h, s in out.items():
                col.gauge("fault.ewma_step_s", s["ewma_s"], rank=h)
        return out


def retry(fn: Callable, attempts: int = 4, backoff_s: float = 0.05,
          exceptions=(OSError, IOError), max_backoff_s: float = 2.0,
          jitter: float = 0.25, seed: Optional[int] = None,
          sleep: Callable[[float], None] = time.sleep):
    """Run fn(), retrying transient host-side failures with exponential
    backoff + jitter.

    The wait before attempt ``i+1`` is ``backoff_s * 2**i`` (capped at
    ``max_backoff_s``), scaled by a uniform factor in ``[1 - jitter,
    1 + jitter]`` so simultaneous retries across a fleet decorrelate.
    ``seed`` makes the jitter sequence deterministic (tests); ``sleep``
    is injectable for the same reason. The last failure propagates."""
    rng = random.Random(seed)
    for i in range(attempts):
        try:
            return fn()
        except exceptions:
            _telemetry.get().count("fault.io_retries", 1)
            if i == attempts - 1:
                raise
            wait = min(backoff_s * (2 ** i), max_backoff_s)
            if jitter:
                wait *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
            sleep(wait)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------
PLAN_ENV = "REPRO_FAULT_PLAN"
_active_plan: Optional["FaultPlan"] = None
_active_loaded = False


@dataclasses.dataclass
class FaultPlan:
    """Deterministic failure schedule for one process.

    ``kill_at_step``/``hang_at_step`` fire in :meth:`on_step` when the
    driver's completed-iteration counter reaches them (the driver calls
    the hook after each save, once that save's write has completed, and
    before the next block: a planned kill at a save step leaves LATEST on
    that step). ``corrupt_checkpoint`` tears the N-th completed
    checkpoint on disk (1-based; truncates one tensor file), modelling a
    partially-flushed save that atomic-rename cannot catch.
    ``io_errors`` makes the next N guarded I/O operations raise
    :class:`TransientIOError` (consumed by :meth:`on_io`), exercising
    the retry paths. ``kill_at_io`` dies mid-write: the N-th guarded
    I/O operation (1-based) ``os._exit``s the process INSIDE the write
    path — the window where a SIGKILL tears an in-flight checkpoint.
    ``kill_at_rendezvous`` dies on entry to the N-th rendezvous attempt
    (consumed by :meth:`on_rendezvous` in the multihost launcher's
    ``initialize``): the mid-init death that leaves peers waiting on the
    coordinator.

    Serving-path injections (consumed by ``repro_torch.serve``):
    ``nan_at_step`` poisons sample ``nan_sample`` of every submitted batch
    with NaN once its step counter passes the threshold (the quarantine
    path); ``reject_after`` makes the request queue shed every admission
    after the N-th (backpressure without real overload);
    ``kill_worker_after`` kills the worker process after it completes N
    batches (a spool worker: N requests); ``batch_errors`` makes the next N
    batch executions raise :class:`TransientIOError` before touching the
    device (the batch retry path); ``wedge_worker_after`` stops the worker
    cold after N completed batches: the process stays alive but never
    progresses or bumps its heartbeat again, the stale-heartbeat recovery
    path that an exit-code watcher alone cannot see."""

    kill_at_step: Optional[int] = None
    hang_at_step: Optional[int] = None
    hang_s: float = 5.0
    rank: int = 0                 # rank this plan applies to (default all == 0)
    kill_at_rendezvous: Optional[int] = None  # die entering the N-th rendezvous attempt
    corrupt_checkpoint: Optional[int] = None
    io_errors: int = 0
    kill_at_io: Optional[int] = None
    nan_at_step: Optional[int] = None
    nan_sample: int = 0
    reject_after: Optional[int] = None
    kill_worker_after: Optional[int] = None
    wedge_worker_after: Optional[int] = None
    batch_errors: int = 0
    _saves_seen: int = dataclasses.field(default=0, repr=False)
    _killed: bool = dataclasses.field(default=False, repr=False)
    _io_seen: int = dataclasses.field(default=0, repr=False)
    _submits_seen: int = dataclasses.field(default=0, repr=False)
    _batches_done: int = dataclasses.field(default=0, repr=False)

    # ---------------- construction ----------------
    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        raw = (environ or os.environ).get(PLAN_ENV)
        if not raw:
            return None
        try:
            d = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"{PLAN_ENV} is not valid JSON: {raw!r}") from e
        if not isinstance(d, dict):
            raise ValueError(f"{PLAN_ENV} must be a JSON object, got {raw!r}")
        known = {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"{PLAN_ENV} has unknown keys {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**d)

    def to_env(self) -> str:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if not f.name.startswith("_")}
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        return json.dumps({k: v for k, v in d.items() if v != defaults[k]})

    @classmethod
    def active(cls) -> Optional["FaultPlan"]:
        """The process-wide plan parsed once from the environment (None
        when no plan is set — the common case costs one global check)."""
        global _active_plan, _active_loaded
        if not _active_loaded:
            _active_plan = cls.from_env()
            _active_loaded = True
        return _active_plan

    @classmethod
    def reset_active(cls) -> None:
        global _active_plan, _active_loaded
        _active_plan, _active_loaded = None, False

    @classmethod
    def active_on_io(cls, path: str = "") -> None:
        plan = cls.active()
        if plan is not None:
            plan.on_io(path)

    # ---------------- hooks ----------------
    def fires_at(self, step: int, rank: int = 0) -> bool:
        """Whether :meth:`on_step` at ``step`` kills or hangs this process:
        the driver drains an async write only before such a step."""
        if rank != self.rank:
            return False
        return ((self.hang_at_step is not None and step >= self.hang_at_step)
                or (self.kill_at_step is not None and not self._killed
                    and step >= self.kill_at_step))

    def on_step(self, step: int, rank: int = 0) -> None:
        """Called by drivers with the completed-iteration counter at each
        check/save boundary. Kills or hangs the process when scheduled."""
        if rank != self.rank:
            return
        if (self.hang_at_step is not None and step >= self.hang_at_step):
            t, self.hang_at_step = self.hang_s, None  # hang once
            time.sleep(t)
        if (self.kill_at_step is not None and not self._killed
                and step >= self.kill_at_step):
            self._killed = True
            # a real preemption does not unwind the stack or flush
            # buffers; os._exit is the closest in-process equivalent
            os._exit(KILL_EXIT_CODE)

    def on_rendezvous(self, attempt: int, rank: int = 0) -> None:
        """Called by the multihost launcher's ``initialize`` on entry to
        each rendezvous attempt (1-based). ``kill_at_rendezvous`` dies
        there: a process killed mid bring-up, leaving its peers to hit
        the rendezvous timeout."""
        if rank != self.rank:
            return
        if self.kill_at_rendezvous is not None and attempt >= self.kill_at_rendezvous:
            os._exit(KILL_EXIT_CODE)

    def on_io(self, path: str = "") -> None:
        """Raise a transient error while the injection budget lasts, or
        die outright on the scheduled guarded operation (``kill_at_io``
        models SIGKILL landing mid-write: no unwind, no flush)."""
        self._io_seen += 1
        if self.kill_at_io is not None and self._io_seen >= self.kill_at_io:
            os._exit(KILL_EXIT_CODE)
        if self.io_errors > 0:
            self.io_errors -= 1
            raise TransientIOError(f"injected transient I/O error ({path})")

    # ---------------- serving-path hooks ----------------
    def on_submit(self) -> bool:
        """Called by the request queue per admission attempt. True: shed
        this request (deterministic overload)."""
        self._submits_seen += 1
        return self.reject_after is not None and self._submits_seen > self.reject_after

    def on_batch(self) -> None:
        """Called by the batch engine before each batch execution; burns
        the transient-batch-failure budget (the retry path)."""
        if self.batch_errors > 0:
            self.batch_errors -= 1
            raise TransientIOError("injected transient batch failure")

    def serve_nan_due(self, step: int) -> Optional[int]:
        """The sample index to poison with NaN once a batch's step counter
        passes ``nan_at_step`` (None: no injection)."""
        if self.nan_at_step is not None and step >= self.nan_at_step:
            return self.nan_sample
        return None

    def worker_batch_done(self) -> None:
        """Called by the worker after each completed batch; dies when the
        scheduled batch count is reached (the worker-kill injection), or
        wedges: alive but never progressing or heartbeating again, so only
        staleness detection can recover the worker."""
        self._batches_done += 1
        if self.kill_worker_after is not None and self._batches_done >= self.kill_worker_after:
            os._exit(KILL_EXIT_CODE)
        if self.wedge_worker_after is not None and self._batches_done >= self.wedge_worker_after:
            while True:
                time.sleep(60)

    def after_save(self, ckpt_dir: str) -> None:
        """Called after each completed checkpoint write with its final
        directory; tears the scheduled one (truncates a tensor file so
        restore sees a short read)."""
        self._saves_seen += 1
        if self.corrupt_checkpoint != self._saves_seen:
            return
        victims = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npy"))
        if victims:
            path = os.path.join(ckpt_dir, victims[0])
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))


@dataclasses.dataclass
class FailurePolicy:
    """What a launcher does per health verdict."""
    checkpoint_every: int = 100
    on_dead: str = "restore_elastic"   # restore last ckpt on surviving mesh
    on_straggler: str = "flag"          # flag -> operator / scheduler eviction
    max_restarts: int = 10
