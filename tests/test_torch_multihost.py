"""The port's multi-process launcher (``repro_torch.launch.multihost``):
rendezvous bounds, run-id heartbeats, the pointed refusals, and the gang
supervisor's kill, replan and resume loop, mirroring
``tests/test_multihost.py`` (its serving-pool tests aside).

Every gang here is real OS processes joined by ``torch.distributed`` over
gloo on the CPU. The acceptance scenario: a 4-process ``elastic_solve_until``
loses one rank to a planned kill mid-solve; the supervisor sees its exit,
terminates the stragglers, re-plans the world to the largest grid-compatible
size (4 -> 2: 3 does not divide the interior) and resumes from the last
global checkpoint, equal to the uninterrupted 1-process run (the reference's
test holds it to atol 1e-5; the port's ranks compute each cell as one
process does, so it is asserted bitwise as well).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.distributed import elastic, fault
from repro_torch.launch import multihost
from torch_gang import PRELUDE, SRC, run_gang


@pytest.fixture()
def src_path(monkeypatch):
    """Worker processes the supervisor spawns import the port from here."""
    monkeypatch.setenv("PYTHONPATH", os.path.abspath(SRC))
    monkeypatch.delenv(fault.PLAN_ENV, raising=False)


def run_child(code: str, timeout: int = 120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop(fault.PLAN_ENV, None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)


# ---------------------------------------------------------------------------
# run-id heartbeat namespacing and stale retirement
# ---------------------------------------------------------------------------
def test_heartbeat_run_id_namespacing(tmp_path):
    d = str(tmp_path)
    old = fault.Heartbeat(d, rank=0, run_id="dead-run")
    old.bump(99)
    new = fault.Heartbeat(d, rank=1, run_id="live-run")
    new.bump(5)
    assert list(new.read_all()) == [1]          # a fresh run never reads the last one's
    assert old.read_all()[0]["run_id"] == "dead-run"
    fault.Heartbeat(d, rank=2).bump(1)          # un-namespaced: invisible to namespaced
    assert list(new.read_all()) == [1]


def test_heartbeat_retire_stale(tmp_path):
    d = str(tmp_path)
    fault.Heartbeat(d, rank=0, run_id="a").bump(1)
    fault.Heartbeat(d, rank=1, run_id="b").bump(1)
    fault.Heartbeat(d, rank=2).bump(1)
    assert fault.Heartbeat.retire_stale(d, keep_run_id="b") == ["a.host_0.json", "host_2.json"]
    assert os.path.exists(os.path.join(d, "b.host_1.json"))
    assert fault.Heartbeat.retire_stale(d) == ["b.host_1.json"]
    assert fault.Heartbeat.retire_stale(d) == []


def test_dead_rank_detection_ignores_foreign_run(tmp_path):
    d = str(tmp_path)
    fault.Heartbeat(d, rank=0, run_id="old").bump(1)
    hb = fault.Heartbeat(d, rank=1, run_id="new", timeout_s=10.0)
    hb.bump(1)
    assert hb.dead_ranks(expected=[0, 1]) == [0]   # rank 0 of THIS run never beat


def test_context_monitor_run_id_passthrough(tmp_path):
    ctx = multihost.DistContext(rank=3, world=4, coordinator=None, run_id="r7",
                                heartbeat_dir=str(tmp_path))
    mon = ctx.monitor(timeout_s=5.0)
    mon.record(1, 0.01)
    assert os.path.exists(os.path.join(str(tmp_path), "r7.host_3.json"))
    assert mon.check_peers()["dead"] == []
    assert multihost.DistContext(0, 1, None, None, None).monitor() is None


def test_fault_plan_kill_at_rendezvous_round_trip():
    plan = fault.FaultPlan.from_env({fault.PLAN_ENV: '{"kill_at_rendezvous": 2, "rank": 1}'})
    assert plan.kill_at_rendezvous == 2 and json.loads(plan.to_env()) == {
        "rank": 1, "kill_at_rendezvous": 2}
    plan.on_rendezvous(5, rank=0)          # another rank's plan: no-op
    plan.on_rendezvous(1, rank=1)          # before the scheduled attempt: no-op
    p = run_child("from repro_torch.distributed import fault\n"
                  "plan = fault.FaultPlan(kill_at_rendezvous=2)\n"
                  "for a in (1, 2, 3):\n"
                  "    plan.on_rendezvous(a)\n"
                  "    print('ATTEMPT', a, flush=True)\n")
    assert p.returncode == fault.KILL_EXIT_CODE and p.stdout.split() == ["ATTEMPT", "1"]


# ---------------------------------------------------------------------------
# rendezvous failure modes are pointed and bounded
# ---------------------------------------------------------------------------
_RDV = r"""
import sys
from repro_torch.launch import multihost
try:
    multihost.initialize(coordinator={coord!r}, num_processes=2, process_id={rank},
                         timeout_s={timeout}, attempts={attempts})
except multihost.RendezvousError as e:
    print("RENDEZVOUS_ERROR:", e)
    sys.exit(7)
print("JOINED")
"""


@pytest.mark.parametrize("rank,attempts", [(1, 2), (0, 1)])
def test_rendezvous_failures_are_pointed_not_a_hang(rank, attempts):
    """Rank 1 dials a coordinator nobody serves; rank 0 serves one and waits
    for a rank 1 that never comes. Both raise RendezvousError naming the
    coordinator within their budget (5 s per attempt)."""
    coord = multihost.default_coordinator()
    t0 = time.monotonic()
    p = run_child(_RDV.format(coord=coord, rank=rank, timeout=5, attempts=attempts))
    took = time.monotonic() - t0
    assert p.returncode == 7, (p.stdout, p.stderr)
    assert "RENDEZVOUS_ERROR" in p.stdout and coord in p.stdout
    assert f"after {attempts} attempt(s)" in p.stdout
    assert took < 60, f"rendezvous failure took {took:.0f}s: not bounded"


def test_initialize_single_process_shortcut_and_config_errors(monkeypatch):
    for name in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
                 multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    ctx = multihost.initialize()          # no world configured: a no-op
    assert (ctx.rank, ctx.world, ctx.backend) == (0, 1, None)
    assert not torch.distributed.is_initialized()
    with pytest.raises(multihost.RendezvousError, match="incomplete"):
        multihost.initialize(coordinator="127.0.0.1:1", num_processes=4)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize(backend="mpi")


def test_nccl_refusals_are_pointed(monkeypatch):
    """NCCL refuses two ranks on one card; ``initialize`` refuses first,
    before any rendezvous, and never falls back to gloo."""
    if not torch.cuda.is_available():
        with pytest.raises(multihost.RendezvousError, match="is_available"):
            multihost.initialize(backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    t0 = time.monotonic()
    with pytest.raises(multihost.RendezvousError, match="share a card"):
        multihost.initialize(coordinator=multihost.default_coordinator(), num_processes=2,
                             process_id=0, backend="nccl", timeout_s=30)
    assert time.monotonic() - t0 < 1.0          # refused before the rendezvous
    with pytest.raises(multihost.RendezvousError, match="share a card"):
        multihost.demo_supervisor(2, "/nonexistent", backend="nccl")


def test_nccl_counts_the_ranks_of_each_machine(monkeypatch):
    """The NCCL refusal counts the ranks on this machine, not the gang's:
    2 machines with 1 card each and a rank on each are no refusal. A
    coordinator on another machine leaves the count to the rendezvous
    store; ``local_world`` or ``REPRO_LOCAL_WORLD_SIZE`` name it before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv(multihost.ENV_LOCAL_WORLD, raising=False)
    monkeypatch.delenv(multihost.ENV_LOCAL_RANK, raising=False)
    # no address here is dialled: the placement reads only its arguments
    assert multihost._local_placement("10.0.0.7:29500", 2, 1, None) is None
    assert multihost._local_placement("127.0.0.1:29500", 2, 1, None) == (2, 1)
    assert multihost._local_placement("localhost:29500", 2, 1, None) == (2, 1)
    assert multihost._local_placement("10.0.0.7:29500", 8, 5, 4) == (4, 1)
    monkeypatch.setenv(multihost.ENV_LOCAL_WORLD, "1")
    assert multihost._local_placement("10.0.0.7:29500", 2, 1, None) == (1, 0)
    monkeypatch.setenv(multihost.ENV_LOCAL_RANK, "0")
    assert multihost._local_placement("10.0.0.7:29500", 2, 1, None) == (1, 0)
    assert multihost._check_backend("nccl", 1) == "cuda"      # 2 hosts x 1 card
    with pytest.raises(multihost.RendezvousError, match="share a card"):
        multihost._check_backend("nccl", 2)                   # 1 host, 2 ranks, 1 card


@pytest.mark.parametrize("hosts, want", [
    (("a", "b"), [(1, 0), (1, 0)]),
    (("a", "a"), [(2, 0), (2, 1)]),
    (("a", "b", "a", "b"), [(2, 0), (2, 0), (2, 1), (2, 1)]),
])
def test_hosts_counted_through_the_store(hosts, want):
    """Each rank posts its host name to the rendezvous store and counts the
    ranks that share it, and its own index among them (its card)."""
    import datetime
    import threading

    import torch.distributed as dist

    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=20))
    got = [None] * len(hosts)

    def rank(r):
        got[r] = multihost._hosts_via_store(store, r, len(hosts), hosts[r])

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert got == want


_DEAD_PEER = r"""
import time
from repro_torch.distributed import halo
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2,), ("x",))
torch.distributed.barrier()          # both ranks are up ...
if ctx.rank == 1:
    os._exit(3)                      # ... and rank 1 dies before its first message
t0 = time.monotonic()
try:
    halo.halo_exchange(torch.zeros(6, 4), mesh, radius=1)
except Exception as e:
    print("RESULT", json.dumps({"raised": type(e).__name__, "after_s": time.monotonic() - t0}),
          flush=True)
    os._exit(9)                      # the group's peer is gone: no shutdown
"""


def test_dead_peer_raises_within_the_collective_timeout():
    out = run_gang(_DEAD_PEER, 2, timeout=90, check=False,
                   prelude=PRELUDE.replace("collective_timeout_s=60", "collective_timeout_s=10"))
    assert out[1][0] == 3
    assert out[0][0] == 9, out[0][1]
    (r,) = [json.loads(line[7:]) for line in out[0][1].splitlines()
            if line.startswith("RESULT ")]
    assert r["after_s"] < 30


# ---------------------------------------------------------------------------
# the acceptance scenario: 4 processes, one killed, replan, resume
# ---------------------------------------------------------------------------
def _reference_run(tmp_path) -> np.ndarray:
    ref = multihost.demo_supervisor(1, str(tmp_path / "ref"), device="cpu", run_id="ref",
                                    verbose=False).run()
    assert ref.exit_codes == [0]
    return np.load(str(tmp_path / "ref" / "out.npy"))


def test_four_process_kill_replan_resume(tmp_path, src_path):
    work = str(tmp_path / "gang")
    sup = multihost.demo_supervisor(4, work, device="cpu", kill_rank=1, kill_at=20,
                                    attempt_deadline_s=150.0, run_id="accept", verbose=False)
    out = sup.run()
    assert out.exit_codes[0] == fault.KILL_EXIT_CODE and out.exit_codes[-1] == 0
    assert out.restarts == 1 and out.final_world == 2     # 3 does not divide 16
    assert out.reports[0].exit_codes[1] == fault.KILL_EXIT_CODE
    assert "rank(s) [1] exited" in out.reports[0].reason
    with open(sup.log_path(1, 0)) as f:
        tail = f.read()
    assert "resumed_from=20" in tail and "device=cpu backend=gloo" in tail, tail
    got, want = np.load(os.path.join(work, "out.npy")), _reference_run(tmp_path)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, want)


def test_mid_init_death_triggers_supervised_restart(tmp_path, src_path):
    """Rank 1 dies entering the rendezvous; rank 0's store times out; the
    supervisor catches the planned exit, replans to 1 and completes."""
    work = str(tmp_path / "gang")
    sup = multihost.demo_supervisor(2, work, device="cpu", kill_rank=1, kill_at_rendezvous=1,
                                    rendezvous_timeout_s=5.0, attempt_deadline_s=60.0,
                                    run_id="midinit", verbose=False)
    t0 = time.monotonic()
    out = sup.run()
    assert out.exit_codes[0] == fault.KILL_EXIT_CODE and out.exit_codes[-1] == 0
    assert out.final_world == 1
    assert time.monotonic() - t0 < 90
    assert os.path.exists(os.path.join(work, "out.npy"))


def test_supervisor_replan_respects_divisibility():
    assert elastic.plan_compatible((18, 18, 18), 1, 3) == (2, (2,))
    assert elastic.plan_compatible((18, 18, 18), 1, 4) == (4, (4,))
    assert elastic.plan_compatible((130, 130, 130), 1, 3) == (2, (2,))
    with pytest.raises(ValueError, match="largest compatible world"):
        multihost.demo_supervisor(3, "/nonexistent")


def test_cli_demo_smoke(tmp_path, src_path):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--demo", "--world", "2",
         "--device", "cpu", "--workdir", str(tmp_path / "w"), "--max-iters", "8",
         "--deadline", "60"],
        capture_output=True, text=True, timeout=120, env=dict(os.environ))
    assert p.returncode == 0, (p.stdout, p.stderr)
    lines = p.stdout.splitlines()
    report = json.loads("\n".join(lines[lines.index("{"):]))
    assert report["restarts"] == 0 and report["final_world"] == 2
    assert report["attempts"][0]["reason"] == "all ranks exited 0"
