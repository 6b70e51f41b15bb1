"""Multi-process operation: launcher, rendezvous, gang supervisor.

Everything below runs the SAME ``elastic_solve_until`` that the tests run,
across separate OS processes joined by ``torch.distributed``. Three
layers:

  * :func:`initialize`, the per-process entry: resolves rank, world and
    coordinator from arguments or the ``REPRO_*`` environment, probes the
    coordinator's TCP port, meets its peers in a ``TCPStore`` (rank 0
    serves it) with bounded, retried attempts through
    :func:`repro_torch.distributed.fault.retry`, then starts the process
    group with the backend the caller names (``gloo`` or ``nccl``; nothing
    switches one for the other). A coordinator that is down, a joiner past
    the deadline, or a peer that died mid-init surface as a pointed
    :class:`RendezvousError` within the configured budget, never a hang;
    ``FaultPlan.kill_at_rendezvous`` injects the mid-init death. NCCL
    refuses two ranks on one card, so ``initialize`` refuses them first,
    with an error that says so.

  * :class:`Supervisor`, the gang watcher: spawns one worker process per
    rank (fresh interpreters, never forked: the parent may hold a CUDA
    context), namespaces their heartbeat files by a per-attempt run id
    (and retires stale files of earlier runs), and polls two liveness
    signals, exit codes and heartbeat staleness. One failed rank gets the
    stragglers SIGTERMed, then SIGKILLed (peers wedge inside collectives
    when a rank dies mid-step); the world is re-planned to the largest
    checkpoint-compatible size and the gang relaunched. The workers' own
    checkpoint/resume logic carries the solve across.

  * the CLI: ``python -m repro_torch.launch.multihost`` launches the
    built-in demo solve (``--demo``) or any per-rank command::

        python -m repro_torch.launch.multihost --demo --world 4 \\
            --backend gloo --kill-rank 1 --kill-at 20     # recovery drill
        python -m repro_torch.launch.multihost --world 4 -- \\
            python my_worker.py                            # your own worker

Worker processes see ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` / ``REPRO_RUN_ID`` / ``REPRO_HEARTBEAT_DIR`` and call
:func:`initialize` with no arguments but the backend.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import ipaddress
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from ..distributed import fault

__all__ = [
    "RendezvousError", "DistContext", "Supervisor", "SuperviseOutcome",
    "initialize", "shutdown", "free_port", "default_coordinator", "kill_process",
    "heartbeat_ages",
    "demo_supervisor", "main", "BACKENDS",
    "ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "ENV_RUN_ID",
    "ENV_HEARTBEAT_DIR", "ENV_LOCAL_WORLD", "ENV_LOCAL_RANK", "STALE_EXIT_CODE", "DEADLINE_EXIT_CODE",
]

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_RUN_ID = "REPRO_RUN_ID"
ENV_HEARTBEAT_DIR = "REPRO_HEARTBEAT_DIR"
ENV_LOCAL_WORLD = "REPRO_LOCAL_WORLD_SIZE"
ENV_LOCAL_RANK = "REPRO_LOCAL_RANK"
BACKENDS = ("gloo", "nccl")

# supervisor-assigned exit reasons for ranks IT terminated (real worker
# exits keep their own codes; fault.KILL_EXIT_CODE marks planned kills)
STALE_EXIT_CODE = 114      # heartbeat went stale -> SIGKILLed as wedged
DEADLINE_EXIT_CODE = 115   # attempt exceeded its wall-clock deadline


class RendezvousError(RuntimeError):
    """The process group's bring-up failed within the configured budget:
    coordinator unreachable, a joiner missed the deadline, a peer died
    mid-init, or the gang cannot run on this machine as asked. Carries
    enough context to act on (who we dialed, as which rank, how long we
    tried)."""


def free_port() -> int:
    """An OS-assigned free TCP port (racy by nature: callers pick a fresh
    coordinator per attempt, so a rare collision costs one retry)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_coordinator() -> str:
    return f"127.0.0.1:{free_port()}"


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What :func:`initialize` hands the worker: its place in the gang,
    the transport and card it runs on, and the liveness plumbing the
    supervisor watches."""

    rank: int
    world: int
    coordinator: Optional[str]
    run_id: Optional[str]
    heartbeat_dir: Optional[str]
    backend: Optional[str] = None      # None: a world of one, no process group
    device: Optional[str] = None       # "cuda:<i>" under nccl

    def monitor(self, timeout_s: float = 30.0,
                straggler_factor: float = 1.5) -> Optional[fault.StepMonitor]:
        """A run-id-namespaced :class:`~repro_torch.distributed.fault.
        StepMonitor` bumping this rank's heartbeat (None when the launcher
        gave no heartbeat dir)."""
        if not self.heartbeat_dir:
            return None
        return fault.StepMonitor(host_id=self.rank, heartbeat_dir=self.heartbeat_dir,
                                 straggler_factor=straggler_factor, timeout_s=timeout_s,
                                 run_id=self.run_id)


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def _split(coordinator: str) -> tuple[str, int]:
    host, _, port = coordinator.rpartition(":")
    return host, int(port)


def _await_coordinator(coordinator: str, deadline_s: float, probe_s: float = 1.0) -> None:
    """Block until something listens at ``coordinator`` or raise
    :class:`ConnectionError` after ``deadline_s``: the coordinator-down
    failure mode stays a plain, retryable exception."""
    host, port = _split(coordinator)
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            with socket.create_connection((host, port), timeout=probe_s):
                return
        except OSError as e:
            if time.monotonic() >= deadline:
                raise ConnectionError(f"nothing listening at coordinator {coordinator} "
                                      f"within {deadline_s:.0f}s") from e
            time.sleep(min(probe_s, 0.2))


def _check_backend(backend: str, ranks_here: int) -> Optional[str]:
    """The card a rank uses under ``nccl`` (None under gloo); raises
    :class:`RendezvousError` where NCCL would refuse the gang: more ranks
    on this machine (``ranks_here``) than it has cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return None
    import torch

    if not torch.cuda.is_available():
        raise RendezvousError("backend='nccl' runs on CUDA cards, but torch.cuda.is_available() "
                              "is false; name backend='gloo' for a CPU gang")
    cards = torch.cuda.device_count()
    if ranks_here > cards:
        raise RendezvousError(
            f"backend='nccl' with {ranks_here} ranks on this machine, which has {cards} "
            f"CUDA card(s): ranks would share a card, and NCCL refuses two ranks on one "
            "device ('Duplicate GPU detected'). Run at most one rank per card, or name "
            "backend='gloo' (halos staged through host memory)")
    return "cuda"


def _is_loopback(host: str) -> bool:
    """Whether ``host`` (a literal address or ``localhost``) names this
    machine; no name is looked up."""
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _local_placement(coordinator: Optional[str], num_processes: int, process_id: int,
                     local_world: Optional[int]) -> Optional[tuple[int, int]]:
    """``(ranks on this machine, this rank's index among them)`` where it
    is known before the rendezvous: from ``local_world`` (argument or
    ``REPRO_LOCAL_WORLD_SIZE``, with ``REPRO_LOCAL_RANK``, default the rank
    modulo it), or all ranks when the coordinator is a loopback address
    (no other machine can reach it). None: only the rendezvous can tell
    (:func:`_hosts_via_store`)."""
    local_world = local_world if local_world is not None else _env_int(ENV_LOCAL_WORLD)
    if local_world is not None:
        local_rank = _env_int(ENV_LOCAL_RANK)
        return local_world, local_rank if local_rank is not None else process_id % local_world
    if coordinator is None or _is_loopback(_split(coordinator)[0]):
        return num_processes, process_id
    return None


def _hosts_via_store(store, rank: int, world: int,
                     hostname: Optional[str] = None) -> tuple[int, int]:
    """``(ranks on this machine, this rank's index among them)``, counted
    through the rendezvous store: every rank posts its host name and reads
    all of them."""
    hostname = hostname or socket.gethostname()
    store.set(f"repro/host/{rank}", hostname)
    keys = [f"repro/host/{r}" for r in range(world)]
    store.wait(keys)
    here = [r for r, k in enumerate(keys) if store.get(k).decode() == hostname]
    return len(here), here.index(rank)


class _Refused(Exception):
    """A refusal found during the rendezvous: not retried."""


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: str = "gloo",
               timeout_s: float = 60.0,
               attempts: int = 2,
               backoff_s: float = 0.5,
               collective_timeout_s: float = 120.0,
               local_world: Optional[int] = None) -> DistContext:
    """Join the gang: a bounded, retried rendezvous, then
    ``torch.distributed.init_process_group(backend)``. Arguments default
    from the ``REPRO_*`` environment (set by :class:`Supervisor`); with no
    world configured this is a no-op returning a single-process context
    (no process group is started).

    Each attempt is bounded by ``timeout_s`` (the coordinator probe and
    the store's wait for every rank); failures back off through
    :func:`fault.retry` and, once ``attempts`` are spent, raise a pointed
    :class:`RendezvousError`. Every collective of the started group is
    bounded by ``collective_timeout_s``: a peer that dies mid-run raises on
    the ranks waiting for it. Under ``nccl`` each rank takes the card of
    its index among the ranks on its machine, and a machine with more
    ranks than cards is refused (:func:`_check_backend`): before the
    rendezvous where the count is known (``local_world``, the environment,
    a loopback coordinator: :func:`_local_placement`), else from the host
    names the ranks post to the rendezvous store."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR) or None
    num_processes = num_processes if num_processes is not None else _env_int(ENV_NUM_PROCESSES)
    process_id = process_id if process_id is not None else _env_int(ENV_PROCESS_ID)
    run_id = os.environ.get(ENV_RUN_ID) or None
    hb_dir = os.environ.get(ENV_HEARTBEAT_DIR) or None

    if coordinator is None and (num_processes is None or num_processes <= 1):
        _check_backend(backend, 1)
        _rank_telemetry(0)
        return DistContext(rank=0, world=1, coordinator=None, run_id=run_id,
                           heartbeat_dir=hb_dir)
    if coordinator is None or num_processes is None or process_id is None:
        raise RendezvousError(
            "incomplete rendezvous config: need coordinator, num_processes and process_id "
            f"(got {coordinator!r}, {num_processes!r}, {process_id!r}); set "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} or pass them explicitly")
    place = _local_placement(coordinator, num_processes, process_id, local_world)
    card = _check_backend(backend, place[0] if place is not None else 1)

    import torch
    import torch.distributed as dist

    plan = fault.FaultPlan.active()
    state = {"attempt": 0, "device": None}
    host, port = _split(coordinator)

    def attempt_once():
        state["attempt"] += 1
        if plan is not None:
            # plans arrive through this rank's own environment: no rank filter
            plan.on_rendezvous(state["attempt"])
        if process_id != 0:
            # rank 0 serves the store; everyone else checks it is up first
            _await_coordinator(coordinator, deadline_s=timeout_s)
        store = dist.TCPStore(host, port, num_processes, process_id == 0,
                              timeout=datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=True)
        if card is not None:
            here, index = place or _hosts_via_store(store, process_id, num_processes)
            try:
                _check_backend(backend, here)
            except RendezvousError as e:
                raise _Refused(str(e)) from None
            torch.cuda.set_device(index)
            state["device"] = f"cuda:{index}"
        dist.init_process_group(
            backend, store=store, rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=collective_timeout_s),
            **({"device_id": torch.device(state["device"])} if state["device"] else {}))

    try:
        fault.retry(attempt_once, attempts=max(int(attempts), 1), backoff_s=backoff_s,
                    max_backoff_s=10.0,
                    exceptions=(RuntimeError, OSError, ValueError, ConnectionError))
    except _Refused as e:
        raise RendezvousError(str(e)) from None
    except Exception as e:
        raise RendezvousError(
            f"rank {process_id}/{num_processes} failed to rendezvous with coordinator "
            f"{coordinator} after {state['attempt']} attempt(s) x {timeout_s:.0f}s: "
            f"{type(e).__name__}: {e}; check that the coordinator process is up, the "
            f"address is reachable, and all {num_processes} processes launched within "
            "the timeout") from e

    _rank_telemetry(process_id)
    return DistContext(rank=process_id, world=num_processes, coordinator=coordinator,
                       run_id=run_id, heartbeat_dir=hb_dir, backend=backend,
                       device=state["device"])


def shutdown() -> None:
    """Leave the gang: a barrier, then ``destroy_process_group`` (a no-op
    without a process group). A rank that exits with its gloo group still
    up can abort in the group's threads at interpreter exit; every worker
    calls this last."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _rank_telemetry(rank: int) -> None:
    """Split the env-enabled telemetry stream per rank (rank-stamped
    records into ``rank_<i>.jsonl``)."""
    from .. import telemetry

    telemetry.configure_rank(rank)


# ---------------------------------------------------------------------------
# process plumbing
# ---------------------------------------------------------------------------
def kill_process(proc: subprocess.Popen, grace_s: float = 3.0) -> int:
    """SIGTERM, wait up to ``grace_s``, then SIGKILL. Returns the exit code
    (negative: died by a signal)."""
    if proc.poll() is None:
        try:
            proc.terminate()
        except OSError:
            pass
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            try:
                proc.kill()
            except OSError:
                pass
            proc.wait()
    return proc.returncode


def heartbeat_ages(hb: fault.Heartbeat, now: Optional[float] = None) -> dict[int, float]:
    """Seconds since each rank's last bump (ranks that never bumped are
    absent: cover them with an attempt deadline, not staleness)."""
    now = time.time() if now is None else now
    return {r: now - b["t"] for r, b in hb.read_all().items()}


@dataclasses.dataclass
class AttemptReport:
    attempt: int
    world: int
    run_id: str
    exit_codes: dict[int, int]
    reason: str
    duration_s: float


@dataclasses.dataclass
class SuperviseOutcome:
    restarts: int
    final_world: int
    exit_codes: list[int]          # per-attempt root-cause codes
    reports: list[AttemptReport]


class Supervisor:
    """Spawn-and-watch loop for one gang of worker processes.

    ``build_cmd(rank, world, attempt)`` returns the argv of one worker;
    ``rank_env(rank, world, attempt)`` optional per-rank environment extras
    (fault-plan injection lives here). Each attempt gets a fresh
    coordinator port and run id (``<run_id>-a<attempt>``), so heartbeats
    of a dead attempt never vouch for the new one; stale files are retired
    before spawning. Each worker's output goes to
    ``<heartbeat_dir>/<run_id>-a<attempt>.rank<r>.log``.

    Failure handling per attempt: the first nonzero exit code, or a
    heartbeat older than ``heartbeat_timeout_s`` (the wedged rank is
    SIGKILLed and charged :data:`STALE_EXIT_CODE`), terminates the
    stragglers after ``grace_s`` and ends the attempt;
    ``attempt_deadline_s`` bounds everything else (rendezvous hangs,
    never-bumped ranks). :meth:`run` then re-plans the world via
    ``replan(world, rc)`` and relaunches, up to ``max_restarts``."""

    def __init__(self, build_cmd: Callable[[int, int, int], list[str]], world: int, *,
                 heartbeat_dir: str,
                 run_id: Optional[str] = None,
                 heartbeat_timeout_s: float = 30.0,
                 grace_s: float = 3.0,
                 attempt_deadline_s: float = 600.0,
                 poll_s: float = 0.05,
                 env: Optional[dict] = None,
                 rank_env: Optional[Callable[[int, int, int], dict]] = None,
                 replan: Optional[Callable[[int, int], int]] = None,
                 max_restarts: int = 3,
                 verbose: bool = False):
        self.build_cmd = build_cmd
        self.world = int(world)
        self.heartbeat_dir = heartbeat_dir
        self.run_id = run_id or f"run{os.getpid()}"
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.grace_s = grace_s
        self.attempt_deadline_s = attempt_deadline_s
        self.poll_s = poll_s
        self.env = dict(env or {})
        self.rank_env = rank_env
        self.replan = replan
        self.max_restarts = max_restarts
        self.verbose = verbose
        self.reports: list[AttemptReport] = []
        os.makedirs(heartbeat_dir, exist_ok=True)

    def _say(self, msg: str) -> None:
        if self.verbose:
            print(f"[supervisor] {msg}", flush=True)

    def log_path(self, attempt: int, rank: int) -> str:
        return os.path.join(self.heartbeat_dir, f"{self.run_id}-a{attempt}.rank{rank}.log")

    def _base_env(self, attempt_run_id: str, coordinator: str, world: int) -> dict:
        env = dict(os.environ)
        env.pop(fault.PLAN_ENV, None)   # plans are per rank, through rank_env
        env[ENV_COORDINATOR] = coordinator
        env[ENV_NUM_PROCESSES] = str(world)
        env[ENV_RUN_ID] = attempt_run_id
        env[ENV_HEARTBEAT_DIR] = self.heartbeat_dir
        env.update(self.env)
        return env

    def run_attempt(self, attempt: int, world: int) -> int:
        """One gang launch to completion or first failure. Returns the
        attempt's root-cause exit code (0: every rank exited 0)."""
        attempt_run_id = f"{self.run_id}-a{attempt}"
        fault.Heartbeat.retire_stale(self.heartbeat_dir)
        coordinator = default_coordinator()
        base = self._base_env(attempt_run_id, coordinator, world)
        t0 = time.monotonic()
        procs: dict[int, subprocess.Popen] = {}
        logs = []
        rcs: dict[int, int] = {}
        reason = "not started"
        try:
            for rank in range(world):
                env = dict(base)
                env[ENV_PROCESS_ID] = str(rank)
                if self.rank_env is not None:
                    env.update(self.rank_env(rank, world, attempt) or {})
                log = open(self.log_path(attempt, rank), "wb")
                logs.append(log)
                procs[rank] = subprocess.Popen(self.build_cmd(rank, world, attempt), env=env,
                                               stdout=log, stderr=subprocess.STDOUT)
            self._say(f"attempt {attempt}: world={world} coordinator={coordinator} "
                      f"run_id={attempt_run_id}")
            rcs, reason = self._watch(procs, attempt_run_id)
        finally:
            for rank, proc in procs.items():
                code = kill_process(proc, self.grace_s)
                rcs.setdefault(rank, code)
            for log in logs:
                log.close()
        root = self._root_cause(rcs)
        self.reports.append(AttemptReport(attempt=attempt, world=world, run_id=attempt_run_id,
                                          exit_codes=rcs, reason=reason,
                                          duration_s=time.monotonic() - t0))
        self._say(f"attempt {attempt}: rc={root} codes={rcs} ({reason})")
        return root

    def _watch(self, procs: dict[int, subprocess.Popen],
               attempt_run_id: str) -> tuple[dict[int, int], str]:
        hb = fault.Heartbeat(self.heartbeat_dir, timeout_s=self.heartbeat_timeout_s,
                             run_id=attempt_run_id)
        deadline = time.monotonic() + self.attempt_deadline_s
        rcs: dict[int, int] = {}
        while True:
            for rank, proc in procs.items():
                if rank not in rcs and proc.poll() is not None:
                    rcs[rank] = proc.returncode
            live = [r for r in procs if r not in rcs]
            failed = sorted(r for r, c in rcs.items() if c != 0)
            if failed:
                reason = (f"rank(s) {failed} exited {[rcs[r] for r in failed]}; "
                          f"terminating {len(live)} straggler(s)")
                for rank in live:
                    rcs[rank] = kill_process(procs[rank], self.grace_s)
                return rcs, reason
            if not live:
                return rcs, "all ranks exited 0"
            ages = heartbeat_ages(hb)
            stale = sorted(r for r in live if ages.get(r, 0.0) > self.heartbeat_timeout_s)
            if stale:
                reason = (f"rank(s) {stale} heartbeat stale "
                          f"(> {self.heartbeat_timeout_s:.0f}s): SIGKILL")
                for rank in stale:
                    try:
                        procs[rank].kill()
                    except OSError:
                        pass
                    procs[rank].wait()
                    rcs[rank] = STALE_EXIT_CODE
                for rank in live:
                    if rank not in rcs:
                        rcs[rank] = kill_process(procs[rank], self.grace_s)
                return rcs, reason
            if time.monotonic() > deadline:
                reason = (f"attempt deadline {self.attempt_deadline_s:.0f}s exceeded: "
                          "terminating the gang")
                for rank in live:
                    kill_process(procs[rank], self.grace_s)
                    rcs[rank] = DEADLINE_EXIT_CODE
                return rcs, reason
            time.sleep(self.poll_s)

    @staticmethod
    def _root_cause(rcs: dict[int, int]) -> int:
        """The attempt's exit code: a planned kill first, then the first
        positive code (a real worker failure), then any nonzero
        (supervisor-terminated stragglers exit by signal: negative)."""
        codes = [rcs[r] for r in sorted(rcs)]
        if all(c == 0 for c in codes):
            return 0
        if fault.KILL_EXIT_CODE in codes:
            return fault.KILL_EXIT_CODE
        for c in codes:
            if c > 0:
                return c
        return next(c for c in codes if c != 0)

    def run(self) -> SuperviseOutcome:
        """The full supervised loop (the restart policy is
        :func:`repro_torch.distributed.elastic.supervise`)."""
        from ..distributed import elastic

        restarts, final_world, codes = elastic.supervise(
            self.run_attempt, self.world, replan=self.replan, max_restarts=self.max_restarts)
        return SuperviseOutcome(restarts=restarts, final_world=final_world, exit_codes=codes,
                                reports=self.reports)


# ---------------------------------------------------------------------------
# built-in demo worker: a real kill, replan and resume
# ---------------------------------------------------------------------------
DEMO_CHECK_EVERY = 4


def demo_kernel(ps):
    """The demo's Fig. 1-style diffusion step with its fused error."""
    from ..core import fd3d

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                 reductions={"err": "max_abs_diff(T2, T)"})
    def kern(T2, T, dt):
        return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}

    return kern


def demo_initial(n: int, seed: int = 0):
    """The demo's seeded initial field (numpy's generator, on the host)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return torch.from_numpy(np.asarray(rng.rand(n, n, n), np.float32))


def _demo_worker() -> int:
    """One rank of the demo solve: rendezvous, then the diffusion
    ``elastic_solve_until``, checkpointing globally so any later (smaller)
    world resumes it. ``REPRO_DEMO_DEVICE`` (``cuda`` or ``cpu``) and
    ``REPRO_DEMO_BACKEND`` name the card and the transport."""
    ctx = initialize(backend=os.environ.get("REPRO_DEMO_BACKEND", "gloo"),
                     timeout_s=float(os.environ.get("REPRO_DEMO_RDV_S", 20)))

    import numpy as np
    import torch

    from ..core import init_parallel_stencil, iterate
    from ..core.device import default_backend, resolve_device
    from ..distributed import elastic
    from ..kernels import stencil

    device = resolve_device(ctx.device or os.environ.get("REPRO_DEMO_DEVICE", "cuda"))
    torch.set_num_threads(int(os.environ.get("REPRO_DEMO_THREADS", 1)))
    n = int(os.environ.get("REPRO_DEMO_N", 18))
    max_iters = int(os.environ.get("REPRO_DEMO_ITERS", 40))
    hb_timeout = float(os.environ.get("REPRO_DEMO_HB_S", 30))

    ps = init_parallel_stencil(backend=default_backend(device), device=device)
    kern = demo_kernel(ps)
    factors = elastic.plan_factors(ctx.world, 1)
    elastic.validate_stencil_factors((n, n, n), factors, radius=1)
    T0 = demo_initial(n).to(device)
    ck = iterate.Checkpointing(os.environ["REPRO_DEMO_CKPT"], save_every=1, blocking=True,
                               monitor=ctx.monitor(timeout_s=hb_timeout))

    def launches(done: int) -> None:
        # this rank's launches of the generated kernel so far, by grid shape,
        # after each chunk: a rank killed later has printed its count
        print(f"LAUNCHES {done} " + json.dumps(
            {f"{label}@{'x'.join(map(str, shape))}": k
             for (label, shape), k in stencil.shape_launches.items()}), flush=True)

    res = elastic.elastic_solve_until(
        kern, dict(T2=T0, T=T0), dict(dt=1e-3), factors=factors, tol=0.0,
        max_iters=max_iters, exchange=("T",), check_every=DEMO_CHECK_EVERY, checkpoint=ck,
        gather_to=0, on_chunk=launches)
    if ctx.rank == 0 and os.environ.get("REPRO_DEMO_OUT"):
        np.save(os.environ["REPRO_DEMO_OUT"], res.fields["T"].cpu().numpy())
    print(f"DONE rank={ctx.rank} world={ctx.world} iters={res.iters} "
          f"resumed_from={res.resumed_from} device={device} backend={ctx.backend}",
          flush=True)
    shutdown()
    return 0


def demo_supervisor(world: int, workdir: str, *,
                    n: int = 18, max_iters: int = 40,
                    device: str = "cuda", backend: str = "gloo",
                    kill_rank: Optional[int] = None,
                    kill_at: Optional[int] = None,
                    kill_at_rendezvous: Optional[int] = None,
                    heartbeat_timeout_s: float = 30.0,
                    attempt_deadline_s: float = 240.0,
                    rendezvous_timeout_s: float = 20.0,
                    max_restarts: int = 3,
                    run_id: Optional[str] = None,
                    verbose: bool = True) -> Supervisor:
    """The supervised demo gang: optionally kills ``kill_rank`` at iteration
    ``kill_at`` (or on entry to rendezvous attempt ``kill_at_rendezvous``)
    on attempt 0 through ``REPRO_FAULT_PLAN``, and re-plans with
    :func:`~repro_torch.distributed.elastic.plan_compatible` so the shrunken
    world still divides the grid. The workers run on ``device`` over
    ``backend``."""
    from ..distributed import elastic

    shape = (n, n, n)
    world, _ = _compatible_or_raise(shape, world)
    _check_backend(backend, world)

    def build_cmd(rank: int, w: int, attempt: int) -> list[str]:
        return [sys.executable, "-m", "repro_torch.launch.multihost", "--worker"]

    def rank_env(rank: int, w: int, attempt: int) -> dict:
        env = {
            "REPRO_DEMO_N": str(n),
            "REPRO_DEMO_ITERS": str(max_iters),
            "REPRO_DEMO_HB_S": str(heartbeat_timeout_s),
            "REPRO_DEMO_RDV_S": str(rendezvous_timeout_s),
            "REPRO_DEMO_DEVICE": device,
            "REPRO_DEMO_BACKEND": backend,
            "REPRO_DEMO_CKPT": os.path.join(workdir, "ckpt"),
            "REPRO_DEMO_OUT": os.path.join(workdir, "out.npy"),
        }
        if attempt == 0 and kill_rank == rank:
            if kill_at is not None:
                env[fault.PLAN_ENV] = fault.FaultPlan(kill_at_step=kill_at).to_env()
            elif kill_at_rendezvous is not None:
                env[fault.PLAN_ENV] = fault.FaultPlan(
                    kill_at_rendezvous=kill_at_rendezvous).to_env()
        return env

    def replan(w: int, rc: int) -> int:
        return elastic.plan_compatible(shape, 1, max(w - 1, 1))[0]

    return Supervisor(build_cmd, world, heartbeat_dir=os.path.join(workdir, "hb"),
                      run_id=run_id, heartbeat_timeout_s=heartbeat_timeout_s,
                      attempt_deadline_s=attempt_deadline_s, rank_env=rank_env,
                      replan=replan, max_restarts=max_restarts, verbose=verbose)


def _compatible_or_raise(shape: Sequence[int], world: int) -> tuple[int, tuple]:
    from ..distributed import elastic

    w, factors = elastic.plan_compatible(shape, 1, world)
    if w != world:
        raise ValueError(f"world {world} does not decompose grid {tuple(shape)} (radius 1); "
                         f"largest compatible world is {w}")
    return w, factors


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.multihost",
                                 description="multi-process launcher/supervisor "
                                             "(see the module docstring)")
    ap.add_argument("--worker", action="store_true",
                    help="internal: run one demo worker rank (environment-driven)")
    ap.add_argument("--demo", action="store_true", help="run the supervised demo solve")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--workdir", default="multihost_demo")
    ap.add_argument("--n", type=int, default=18)
    ap.add_argument("--max-iters", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="demo: where each rank computes")
    ap.add_argument("--backend", default="gloo", choices=BACKENDS,
                    help="demo: the process group's transport")
    ap.add_argument("--kill-rank", type=int, default=None,
                    help="demo: kill this rank on attempt 0 ...")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="... at this iteration (exercises recovery)")
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--deadline", type=float, default=240.0,
                    help="per-attempt wall-clock bound (s)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--run-id", default=None)
    ap.add_argument("cmd", nargs="*", help="worker argv (after --) for non-demo gangs")
    args = ap.parse_args(argv)

    if args.worker:
        return _demo_worker()

    if args.demo:
        sup = demo_supervisor(
            args.world, args.workdir, n=args.n, max_iters=args.max_iters,
            device=args.device, backend=args.backend, kill_rank=args.kill_rank,
            kill_at=args.kill_at, heartbeat_timeout_s=args.heartbeat_timeout,
            attempt_deadline_s=args.deadline, max_restarts=args.max_restarts,
            run_id=args.run_id)
        out = sup.run()
        print(json.dumps({"restarts": out.restarts, "final_world": out.final_world,
                          "exit_codes": out.exit_codes,
                          "attempts": [dataclasses.asdict(r) for r in out.reports]},
                         indent=2))
        return 0

    if not args.cmd:
        ap.error("pass --demo, --worker, or a worker command after --")
    sup = Supervisor(lambda rank, world, attempt: list(args.cmd), args.world,
                     heartbeat_dir=os.path.join(args.workdir, "hb"), run_id=args.run_id,
                     heartbeat_timeout_s=args.heartbeat_timeout,
                     attempt_deadline_s=args.deadline, max_restarts=args.max_restarts,
                     verbose=True)
    out = sup.run()
    print(json.dumps({"restarts": out.restarts, "final_world": out.final_world,
                      "exit_codes": out.exit_codes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
