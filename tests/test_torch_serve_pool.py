"""The port's multi-process serving pool on CPU worker processes.

The counterparts of ``tests/test_multihost.py::test_process_pool_*``:
``ProcessWorkerPool`` workers (``python -m repro_torch.serve.procworker
--device cpu``) drain a filesystem spool; a worker killed by the fault
plan, or wedged (alive but no longer beating), is replaced, its claimed
requests go back to the front of the backlog, and every request resolves.
Each ticket waits at most 90 s (its own timeout). Each result must equal
the port's solo ``solve_until`` of the request bitwise: a worker solves in
heartbeat-sized chunks of whole checks, which the per-step arithmetic
never sees.
"""
import numpy as np
import torch

from repro_torch.core import iterate
from repro_torch.distributed import fault
from repro_torch.serve import ProcessWorkerPool
from repro_torch.serve.procworker import (_solve_beating, demo_kernel, read_request,
                                          write_request)


def _inits(seed, count, n=10):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.rand(n, n, n), np.float32) for _ in range(count)]


def _assert_solo(results, inits, **kw):
    kern = demo_kernel("cpu")
    for a, (fields, meta) in zip(inits, results):
        t = torch.from_numpy(a)
        ref = iterate.solve_until(kern, {"T2": t, "T": t.clone()}, {"dt": 1e-3}, **kw)
        assert meta["iters"] == ref.iters and meta["err"] == ref.err
        for f in ("T", "T2"):
            np.testing.assert_array_equal(fields[f], ref.fields[f].numpy())


def test_process_pool_survives_worker_kills(tmp_path):
    inits = _inits(3, 4)
    # every first-generation worker dies after ONE served request; the pool
    # recovers the claims and respawns until all four resolve
    plan = fault.FaultPlan(kill_worker_after=1)
    pool = ProcessWorkerPool(str(tmp_path / "spool"), workers=2, device="cpu",
                             heartbeat_timeout_s=60.0, max_worker_restarts=4,
                             env={fault.PLAN_ENV: plan.to_env()})
    with pool:
        tickets = [pool.submit({"T2": a, "T": a}, {"dt": 1e-3}, tol=0.0, max_iters=8,
                               check_every=4) for a in inits]
        results = [t.result(timeout=90.0) for t in tickets]
    assert pool.restarts >= 1 and not pool.failed
    assert all(meta["iters"] == 8 for _, meta in results)
    _assert_solo(results, inits, tol=0.0, max_iters=8, check_every=4)


def test_process_pool_recovers_wedged_worker_without_kill_loop(tmp_path):
    """A worker that wedges (alive, never beating again) is killed and its
    heartbeat file retired before the respawn, so the replacement's
    start-up is not judged by the dead incarnation's stale file."""
    inits = _inits(7, 3)
    plan = fault.FaultPlan(wedge_worker_after=1)
    pool = ProcessWorkerPool(str(tmp_path / "spool"), workers=1, device="cpu",
                             heartbeat_timeout_s=6.0, max_worker_restarts=2,
                             env={fault.PLAN_ENV: plan.to_env()})
    with pool:
        tickets = [pool.submit({"T2": a, "T": a}, {"dt": 1e-3}, tol=0.0, max_iters=8,
                               check_every=4) for a in inits]
        results = [t.result(timeout=90.0) for t in tickets]
    assert pool.restarts >= 1
    assert not pool.failed, "replacement was kill-looped by the stale file"
    _assert_solo(results, inits, tol=0.0, max_iters=8, check_every=4)


def test_spool_wire_format_and_chunked_solve_bitwise(tmp_path):
    """The request file round-trips, and the heartbeat-chunked solve equals
    the unchunked one bitwise (iterations, error, fields)."""
    (a,) = _inits(11, 1, n=9)
    path = str(tmp_path / "00000000_x.npz")
    write_request(path, {"T2": a, "T": a}, {"scalars": {"dt": 0.08}, "tol": 1e-6,
                                             "max_iters": 300, "check_every": 4})
    fields, meta = read_request(path)
    np.testing.assert_array_equal(fields["T"], a)

    class Beats:
        n = 0

        def bump(self, served):
            Beats.n += 1

    kern = demo_kernel("cpu")
    out, iters, err = _solve_beating(kern, fields, meta, Beats(), 0, chunk_target_s=0.0)
    t = torch.from_numpy(a)
    ref = iterate.solve_until(kern, {"T2": t, "T": t.clone()}, {"dt": 0.08}, tol=1e-6,
                              max_iters=300, check_every=4)
    assert iters == ref.iters and err == ref.err and Beats.n > 4
    for f in ("T", "T2"):
        np.testing.assert_array_equal(out[f], ref.fields[f].numpy())
