"""The port's fault tolerance (``repro_torch.distributed.fault``): retry with
backoff, deterministic fault injection, heartbeats and step monitoring, and
real process death followed by a resume, mirroring ``tests/test_fault.py``.

Comparison contract: a killed run resumed on the same machine replays the
same launches from the checkpointed carry, so it is compared BITWISE with
the uninterrupted run. Process-death tests run real subprocesses:
``REPRO_FAULT_PLAN`` makes an unmodified ``solve_until`` die through
``os._exit(113)`` at an exact point, the parent asserts the planned exit
code, and a second launch resumes from the atomic checkpoint.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import fd3d, init_parallel_stencil, iterate
from repro_torch.distributed import fault

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def run_proc(code: str, env_extra: dict | None = None,
             timeout: int = 300) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter with the port importable and no
    fault plan unless ``env_extra`` sets one."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop(fault.PLAN_ENV, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture()
def active_plan(monkeypatch):
    """Install a FaultPlan as the process-wide active plan; restores the
    no-plan state afterwards."""
    def install(plan: fault.FaultPlan):
        monkeypatch.setenv(fault.PLAN_ENV, plan.to_env())
        fault.FaultPlan.reset_active()
        return fault.FaultPlan.active()
    yield install
    fault.FaultPlan.reset_active()


def diffusion_kernel():
    ps = init_parallel_stencil(backend="torch", device="cpu")

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                 reductions={"err": "max_abs_diff(T2, T)"})
    def kern(T2, T, dt):
        return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}

    return kern


def spike(n=12):
    T = torch.zeros((n, n, n), dtype=torch.float32)
    T[n // 2, n // 2, n // 2] = 1.0
    return T


# ---------------------------------------------------------------------------
# retry with backoff and jitter
# ---------------------------------------------------------------------------
def test_retry_backoff_schedule_and_jitter_bounds():
    waits: list[float] = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise OSError("transient")
        return "ok"

    out = fault.retry(flaky, attempts=4, backoff_s=0.1, max_backoff_s=0.3, jitter=0.25,
                      seed=7, sleep=waits.append)
    assert out == "ok" and calls["n"] == 4
    assert len(waits) == 3
    for i, w in enumerate(waits):
        nominal = min(0.1 * 2 ** i, 0.3)
        assert nominal * 0.75 <= w <= nominal * 1.25, (i, w, nominal)


def test_retry_jitter_deterministic_with_seed():
    def seq(seed):
        waits, calls = [], {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 4:
                raise OSError()
            return 1

        fault.retry(flaky, attempts=4, backoff_s=0.05, jitter=0.5, seed=seed,
                    sleep=waits.append)
        return waits

    assert seq(3) == seq(3)
    assert seq(3) != seq(4)


@pytest.mark.parametrize("case", ["exhausts", "unlisted"])
def test_retry_exhaustion_and_unlisted_exceptions(case):
    waits = []
    if case == "exhausts":
        with pytest.raises(OSError, match="persistent"):
            fault.retry(lambda: (_ for _ in ()).throw(OSError("persistent")), attempts=3,
                        backoff_s=0.01, sleep=waits.append)
        assert len(waits) == 2  # no sleep after the final attempt
    else:
        with pytest.raises(KeyError):
            fault.retry(lambda: {}["missing"], attempts=4, sleep=waits.append)
        assert waits == []


# ---------------------------------------------------------------------------
# FaultPlan parsing and hooks
# ---------------------------------------------------------------------------
def test_fault_plan_env_roundtrip():
    plan = fault.FaultPlan(kill_at_step=60, io_errors=2)
    again = fault.FaultPlan.from_env({fault.PLAN_ENV: plan.to_env()})
    assert again.kill_at_step == 60 and again.io_errors == 2
    assert json.loads(plan.to_env()) == {"kill_at_step": 60, "io_errors": 2}
    assert fault.FaultPlan.from_env({}) is None
    assert fault.PLAN_ENV == "REPRO_FAULT_PLAN" and fault.KILL_EXIT_CODE == 113


@pytest.mark.parametrize("raw,match", [('{"kill_at": 3}', "unknown keys"),
                                       # the serving injections are known keys
                                       # (repro_torch.serve consumes them); an
                                       # unknown key beside one is refused
                                       ('{"reject_after": 1, "reject_afterr": 1}',
                                        "unknown keys"),
                                       ('{"kill_worker_after": 1, "kill_workers": 1}',
                                        "unknown keys"),
                                       ("{nope", "not valid JSON"),
                                       ("[1, 2]", "JSON object")])
def test_fault_plan_rejects_bad_env(raw, match):
    with pytest.raises(ValueError, match=match):
        fault.FaultPlan.from_env({fault.PLAN_ENV: raw})


def test_fault_plan_io_budget():
    plan = fault.FaultPlan(io_errors=2)
    for path in ("/a", "/b"):
        with pytest.raises(fault.TransientIOError):
            plan.on_io(path)
    plan.on_io("/c")  # budget spent: no raise


def test_fault_plan_on_step_respects_rank():
    plan = fault.FaultPlan(hang_at_step=5, hang_s=0.01, rank=1)
    t0 = time.perf_counter()
    plan.on_step(10, rank=0)           # not this plan's rank: no-op
    assert time.perf_counter() - t0 < 0.005
    plan.on_step(10, rank=1)           # hangs once
    assert plan.hang_at_step is None   # consumed


def test_fault_plan_fires_at():
    plan = fault.FaultPlan(kill_at_step=30, rank=1)
    assert not plan.fires_at(20, rank=1) and not plan.fires_at(30, rank=0)
    assert plan.fires_at(30, rank=1) and plan.fires_at(40, rank=1)
    assert fault.FaultPlan(hang_at_step=5).fires_at(5)
    assert not fault.FaultPlan(io_errors=3, corrupt_checkpoint=1).fires_at(10 ** 6)


class _WaitLog(CheckpointManager):
    """Records the driver's saves and the waits it makes between them (a
    save's own wait for the previous write is not the driver's)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.calls, self._saving = [], False

    def save(self, step, *a, **k):
        self.calls.append(step)
        self._saving = True
        try:
            super().save(step, *a, **k)
        finally:
            self._saving = False

    def wait(self):
        if not self._saving:
            self.calls.append("wait")
        super().wait()


@pytest.mark.parametrize("plan,waits_after", [
    (fault.FaultPlan(io_errors=3), ()),
    (fault.FaultPlan(corrupt_checkpoint=2), ()),
    (fault.FaultPlan(hang_at_step=30, hang_s=0.0), (30,)),
])
def test_async_saves_stay_overlapped_under_a_plan(tmp_path, active_plan, plan, waits_after):
    """The driver drains an async write only before a step at which the
    plan kills or hangs; under any other plan the writes overlap the next
    chunk, and the solve still equals the plain one bitwise."""
    active = active_plan(plan)
    mgr = _WaitLog(str(tmp_path), keep=3, retry_backoff_s=0.001)
    T0 = spike()
    kw = dict(tol=0.0, max_iters=60, check_every=5)
    res = iterate.solve_until(diffusion_kernel(), dict(T2=T0, T=T0), dict(dt=1e-3), **kw,
                              checkpoint=iterate.Checkpointing(mgr, save_every=2))
    want = []
    for step in range(10, 61, 10):
        want += [step, "wait"] if step in waits_after else [step]
    assert mgr.calls == want + ["wait"]          # and the final drain
    assert active.io_errors == 0                 # the writer thread retried through them
    plain = iterate.solve_until(diffusion_kernel(), dict(T2=T0, T=T0), dict(dt=1e-3), **kw)
    assert res.iters == plain.iters == 60 and torch.equal(res.fields["T"], plain.fields["T"])


def test_fault_plan_policy_defaults():
    pol = fault.FailurePolicy()
    assert pol.checkpoint_every == 100 and pol.max_restarts == 10
    s = fault.StepStats()
    s.update(2.0)
    s.update(1.0, alpha=0.5)
    assert (s.n, s.last_s, s.ewma_s) == (2, 1.0, 1.5)


def test_kill_at_step_exits_with_planned_code():
    code = """
from repro_torch.distributed import fault
plan = fault.FaultPlan(kill_at_step=3)
for step in range(10):
    plan.on_step(step)
print("UNREACHABLE")
"""
    p = run_proc(code)
    assert p.returncode == fault.KILL_EXIT_CODE, (p.stdout, p.stderr)
    assert "UNREACHABLE" not in p.stdout


# ---------------------------------------------------------------------------
# heartbeats, stragglers, monitored solves
# ---------------------------------------------------------------------------
def test_heartbeat_dead_and_straggler_flagging(tmp_path):
    d = str(tmp_path)
    now = time.time()
    # ranks 0/3 healthy, rank 1 a straggler (slow EWMA), rank 2 dead
    fault.Heartbeat(d, rank=0).bump(100, ewma_s=0.10)
    fault.Heartbeat(d, rank=3).bump(98, ewma_s=0.12)
    fault.Heartbeat(d, rank=1).bump(80, ewma_s=1.0)
    with open(os.path.join(d, "host_2.json"), "w") as f:
        json.dump({"step": 40, "t": now - 1000.0, "ewma_s": 0.1}, f)

    hb = fault.Heartbeat(d, rank=0, timeout_s=300.0)
    assert hb.dead_ranks(now=now) == [2]
    assert hb.dead_ranks(expected=[0, 1, 2, 3, 4], now=now) == [2, 4]

    mon = fault.StepMonitor(host_id=0, heartbeat_dir=d, straggler_factor=1.5, timeout_s=300.0)
    health = mon.check_peers(now=now)
    assert health["dead"] == [2] and health["stragglers"] == [1]


def test_heartbeat_ignores_torn_files_and_other_runs(tmp_path):
    d = str(tmp_path)
    fault.Heartbeat(d, rank=0).bump(10)
    with open(os.path.join(d, "host_1.json"), "w") as f:
        f.write('{"step": 5, "t":')  # torn mid-write
    assert list(fault.Heartbeat(d).read_all()) == [0]
    fault.Heartbeat(d, rank=5, run_id="new").bump(1)
    assert list(fault.Heartbeat(d, run_id="new").read_all()) == [5]
    assert fault.Heartbeat.retire_stale(d, keep_run_id="new") == ["host_0.json",
                                                                  "host_1.json"]
    assert sorted(os.listdir(d)) == ["new.host_5.json"]


def test_solve_with_monitor_raises_rank_failure(tmp_path):
    hb_dir = str(tmp_path / "hb")
    os.makedirs(hb_dir)
    with open(os.path.join(hb_dir, "host_3.json"), "w") as f:
        json.dump({"step": 1, "t": time.time() - 1000.0, "ewma_s": 0.1}, f)
    mon = fault.StepMonitor(host_id=0, heartbeat_dir=hb_dir, timeout_s=300.0)
    ck = iterate.Checkpointing(str(tmp_path / "ck"), save_every=1, blocking=True, monitor=mon)
    T0 = spike()
    with pytest.raises(fault.RankFailure) as ei:
        iterate.solve_until(diffusion_kernel(), dict(T2=T0, T=T0), dict(dt=1e-3), tol=0.0,
                            max_iters=20, check_every=2, checkpoint=ck)
    assert ei.value.dead == [3]
    # our own heartbeat was bumped before the check
    assert 0 in fault.Heartbeat(hb_dir).read_all()


def test_monitored_solve_reports_step_stats(tmp_path):
    mon = fault.StepMonitor(host_id=0, heartbeat_dir=str(tmp_path / "hb"))
    ck = iterate.Checkpointing(str(tmp_path / "ck"), save_every=1, blocking=True, monitor=mon)
    T0 = spike()
    res = iterate.solve_until(diffusion_kernel(), dict(T2=T0, T=T0), dict(dt=1e-3), tol=0.0,
                              max_iters=6, check_every=2, checkpoint=ck)
    assert res.iters == 6 and res.saved_steps == (2, 4, 6)
    assert res.step_stats[0]["n"] == 3 and res.step_stats[0]["ewma_s"] > 0


# ---------------------------------------------------------------------------
# process death and resume (real subprocesses, real os._exit)
# ---------------------------------------------------------------------------
_SOLVE_CHILD = r"""
import os, numpy as np, torch
from repro_torch.core import fd3d, init_parallel_stencil, iterate

ps = init_parallel_stencil(backend="torch", device="cpu")

@ps.parallel(outputs=("T2",), rotations={"T2": "T"},
             reductions={"err": "max_abs_diff(T2, T)"})
def kern(T2, T, dt):
    return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}

n = 12
T0 = torch.zeros((n, n, n)); T0[n // 2, n // 2, n // 2] = 1.0
ck = iterate.Checkpointing(os.environ["CKPT_DIR"], save_every=2,
                           blocking=os.environ["BLOCKING"] == "1")
res = iterate.solve_until(kern, dict(T2=T0, T=T0), dict(dt=1e-3), tol=0.0, max_iters=60,
                          check_every=5, checkpoint=ck)
np.save(os.environ["OUT_NPY"], res.fields["T"].numpy())
print("DONE", res.iters, res.resumed_from)
"""


def _uninterrupted(tmp_path):
    """The child's solve, uninterrupted, in this process: the same torch
    operations on the same machine give the same bits."""
    T0 = spike()
    res = iterate.solve_until(diffusion_kernel(), dict(T2=T0, T=T0), dict(dt=1e-3), tol=0.0,
                              max_iters=60, check_every=5)
    assert res.iters == 60
    return res.fields["T"].numpy()


@pytest.mark.parametrize("blocking", ["1", "0"])
def test_kill_at_step_then_resume_completes_bitwise(tmp_path, blocking):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.npy")
    env = {"CKPT_DIR": ck, "OUT_NPY": out, "BLOCKING": blocking}
    # attempt 1: the plan kills the process at iteration 30, a save boundary;
    # the kill lands after that save has completed, async or not
    plan = fault.FaultPlan(kill_at_step=30)
    p = run_proc(_SOLVE_CHILD, dict(env, **{fault.PLAN_ENV: plan.to_env()}))
    assert p.returncode == fault.KILL_EXIT_CODE, (p.stdout, p.stderr)
    assert not os.path.exists(out)
    assert CheckpointManager(ck).latest_step() == 30
    # attempt 2 (no plan): resumes from step 30 and completes
    p = run_proc(_SOLVE_CHILD, env)
    assert p.returncode == 0, (p.stdout, p.stderr)
    assert "DONE 60 30" in p.stdout
    np.testing.assert_array_equal(np.load(out), _uninterrupted(tmp_path))


def test_kill_during_async_save_leaves_latest_good_and_resumes_bitwise(tmp_path):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.npy")
    env = {"CKPT_DIR": ck, "OUT_NPY": out, "BLOCKING": "0"}
    # each save guards 6 I/O operations (4 tensors, the manifest, the LATEST
    # swap); operation 8 is the 2nd tensor write of the SECOND save, so the
    # process dies inside the async writer with step_20 still a .tmp dir
    plan = fault.FaultPlan(kill_at_io=8)
    p = run_proc(_SOLVE_CHILD, dict(env, **{fault.PLAN_ENV: plan.to_env()}))
    assert p.returncode == fault.KILL_EXIT_CODE, (p.stdout, p.stderr)
    assert not os.path.exists(out)
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == 10          # LATEST: the previous good step
    assert mgr.list_steps() == [10]         # the torn step is not listed
    assert os.path.isdir(mgr.step_dir(20) + ".tmp")
    # the storage layer may yet promote the torn step (write reordering on a
    # power cut): restore walks past it, and the solve resumes bitwise
    os.rename(mgr.step_dir(20) + ".tmp", mgr.step_dir(20))
    with open(os.path.join(ck, "LATEST"), "w") as f:
        f.write(os.path.basename(mgr.step_dir(20)))
    assert mgr.latest_step() == 20
    p = run_proc(_SOLVE_CHILD, env)
    assert p.returncode == 0, (p.stdout, p.stderr)
    assert "DONE 60 10" in p.stdout
    np.testing.assert_array_equal(np.load(out), _uninterrupted(tmp_path))
