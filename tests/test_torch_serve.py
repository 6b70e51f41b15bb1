"""The port's simulation server (``repro_torch.serve``) and its batched
solver on the CPU, beside the JAX package's.

The counterparts of ``tests/test_serve.py`` and
``tests/test_serve_properties.py``: the batch-axis solver, the queue
(buckets, shedding, expiry, requeue order, ``reject_after``), the server's
robustness (retries, breaker and supervisor restart, batch timeout,
continuous refill, dead slots frozen, NaN quarantine) and the demo's
outcomes. Within the port the batched solve must equal the solo
``solve_until`` bitwise, a sample refilled mid-batch included. Against the
reference's ``solve_batch`` and ``SimulationServer`` (``jnp`` backend) the
iterations must be equal and the fields within ``FIELD_ATOL`` (two
frameworks' elementwise operators over some hundred steps); each request's
tolerance is asserted to lie more than ``TOL_MARGIN`` (relative) from the
error of the check that stopped it, so the iterations cannot flip on a
last-bit difference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as r_serve
from repro.core import fd3d as r_fd3d, init_parallel_stencil as r_init, iterate as r_iterate
from repro_torch import telemetry
from repro_torch.core import fd3d, init_parallel_stencil, iterate
from repro_torch.distributed import fault
from repro_torch.serve import (BudgetExhausted, DeadlineExceeded, QueueFull, RequestQueue,
                               SampleQuarantined, ServePolicy, ServerClosed, SimulationServer,
                               SolveRequest, bucket_key, errors)
from repro_torch.serve.engine import BatchEngine

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FIELD_ATOL = 1e-6       # port against reference, fields of amplitude <= 2.5
TOL_MARGIN = 1e-3       # the stopping check's error stays this far from tol


def run_proc(code: str, env_extra: dict | None = None, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop(fault.PLAN_ENV, None)
    env.pop("REPRO_TELEMETRY", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture()
def active_plan(monkeypatch):
    def install(plan: fault.FaultPlan):
        monkeypatch.setenv(fault.PLAN_ENV, plan.to_env())
        fault.FaultPlan.reset_active()
        return fault.FaultPlan.active()
    yield install
    fault.FaultPlan.reset_active()


@pytest.fixture()
def collector():
    col = telemetry.configure(path=None)
    yield col
    telemetry.reset()


def diffusion(T2, T, dt):
    return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}


def r_diffusion(T2, T, dt):
    return {"T2": r_fd3d.inn(T) + dt * (r_fd3d.d2_xi(T) + r_fd3d.d2_yi(T)
                                        + r_fd3d.d2_zi(T))}


def diffusion_kernel(reductions=None):
    ps = init_parallel_stencil(backend="torch", device="cpu")
    return ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                       reductions=reductions or {"err": "max_abs_diff(T2, T)"})(diffusion)


def reference_kernel():
    return r_init(backend="jnp", ndims=3).parallel(
        outputs=("T2",), rotations={"T2": "T"},
        reductions={"err": "max_abs_diff(T2, T)"})(r_diffusion)


def spike(n=12, amp=1.0):
    T = np.zeros((n, n, n), np.float32)
    T[n // 2, n // 2, n // 2] = amp
    return T


def req(n=12, amp=1.0, dt=0.08, tol=1e-5, max_iters=600, **kw):
    return SolveRequest(fields={"T": spike(n, amp), "T2": spike(n, amp)},
                        scalars={"dt": dt}, tol=tol, max_iters=max_iters, **kw)


def solo(kern, n=12, amp=1.0, dt=0.08, tol=1e-5, max_iters=600, check_every=4):
    T = torch.from_numpy(spike(n, amp))
    return iterate.solve_until(kern, {"T": T, "T2": T.clone()}, {"dt": dt}, tol=tol,
                               max_iters=max_iters, check_every=check_every)


def assert_same_as_solo(out: dict, ref: iterate.SolveResult):
    assert out["iters"] == ref.iters and out["err"] == ref.err
    for f in ("T", "T2"):
        assert torch.equal(out["fields"][f], ref.fields[f]), f


# ---------------------------------------------------------------------------
# the batch-axis solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("check_every", [3, 4])
def test_solve_batch_matches_solo_bitwise(check_every):
    kern = diffusion_kernel()
    dts = np.array([0.08, 0.10, 0.12, 0.09], np.float32)
    amps = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    T0 = np.stack([spike(12, a) for a in amps])
    res = iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": dts}, tol=1e-5,
                              max_iters=500, check_every=check_every)
    assert bool(res.converged.all()) and not bool(res.bad.any())
    for b in range(4):
        ref = solo(kern, amp=float(amps[b]), dt=float(dts[b]), max_iters=500,
                   check_every=check_every)
        assert int(res.iters[b]) == ref.iters and float(res.err[b]) == ref.err
        for f in ("T", "T2"):
            assert torch.equal(res.fields[f][b], ref.fields[f])
        assert torch.equal(res.output(kern)[b], ref.output(kern))


def test_solve_batch_quarantines_nan_and_respects_budget():
    kern = diffusion_kernel()
    dts = np.array([0.08, 5.0, 0.10], np.float32)
    T0 = np.stack([spike() for _ in range(3)])
    res = iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": dts}, tol=1e-5,
                              max_iters=np.array([500, 500, 8]), check_every=4)
    assert bool(res.converged[0]) and not bool(res.bad[0])
    assert bool(res.bad[1]) and not bool(res.converged[1])
    assert bool(res.expired[2]) and int(res.iters[2]) == 8
    ref = solo(kern, max_iters=500)
    assert torch.equal(res.fields["T"][0], ref.fields["T"])   # the neighbour did not leak


def test_solve_batch_until_above_and_error_callable():
    kern = diffusion_kernel({"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)"})
    T0 = np.stack([spike(10, 1.0), spike(10, 2.0)])
    res = iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": 0.1}, tol=0.05, max_iters=200,
                              check_every=2, error=lambda r: r["mx"], until="below")
    for b, amp in enumerate((1.0, 2.0)):
        T = torch.from_numpy(spike(10, amp))
        ref = iterate.solve_until(kern, {"T": T, "T2": T.clone()}, {"dt": 0.1}, tol=0.05,
                                  max_iters=200, check_every=2, error="mx")
        assert int(res.iters[b]) == ref.iters and float(res.err[b]) == ref.err
    up = iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": 0.1}, tol=10.0, max_iters=40,
                             check_every=2, error="err", until="above")
    assert bool(up.expired.all()) and int(up.iters.max()) == 40


def test_solve_batch_chunks_equal_one_call():
    """Two calls of 16 steps each equal one of 32 bitwise (the serving
    engine's chunks), the state carried between them."""
    kern = diffusion_kernel()
    T0 = np.stack([spike(10, a) for a in (1.0, 1.7, 0.4)])
    solver = iterate.batched_solver(kern, check_every=4)
    assert solver is iterate.batched_solver(kern, check_every=4)        # memoized
    scal, tol, budget = {"dt": [0.08, 0.1, 0.09]}, np.full(3, 1e-9), np.full(3, 1000)
    one = solver(iterate.init_batch_carry(kern, {"T": T0, "T2": T0}), scal, tol, budget, 32)
    two = iterate.init_batch_carry(kern, {"T": T0, "T2": T0})
    for _ in range(2):
        two = solver(two, scal, tol, budget, 16)
    assert torch.equal(one.steps, two.steps) and torch.equal(one.err, two.err)
    assert torch.equal(one.odd, two.odd) and not bool(one.odd.any())  # 32 steps: parity 0
    for f in ("T", "T2"):
        assert torch.equal(one.fields[f], two.fields[f])


@pytest.mark.parametrize("check_every", [4, 5])
def test_solve_batch_matches_reference(check_every):
    dts = np.array([0.08, 0.11, 0.095, 0.085, 0.1], np.float32)
    amps = np.array([1.0, 2.3, 0.6, 1.4, 1.9], np.float32)
    T0 = np.stack([spike(12, a) for a in amps])
    tol = 1e-5
    port = iterate.solve_batch(diffusion_kernel(), {"T": T0, "T2": T0}, {"dt": dts}, tol=tol,
                               max_iters=600, check_every=check_every)
    ref = r_iterate.solve_batch(reference_kernel(), {"T": jnp.asarray(T0), "T2": jnp.asarray(T0)},
                                {"dt": jnp.asarray(dts)}, tol=tol, max_iters=600,
                                check_every=check_every)
    assert bool(port.converged.all()) and bool(np.asarray(ref.converged).all())
    r_err = np.asarray(ref.err)
    assert (np.abs(r_err - tol) / tol > TOL_MARGIN).all(), r_err
    np.testing.assert_array_equal(port.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(port.err.numpy(), r_err, rtol=1e-4)
    for f in ("T", "T2"):
        np.testing.assert_allclose(port.fields[f].numpy(), np.asarray(ref.fields[f]),
                                   rtol=0, atol=FIELD_ATOL)


def test_solve_batch_requires_reductions_and_rotations():
    ps = init_parallel_stencil(backend="torch", device="cpu")
    no_reds = ps.parallel(outputs=("T2",), rotations={"T2": "T"})(diffusion)
    no_rot = ps.parallel(outputs=("T2",), reductions={"err": "max_abs_diff(T2, T)"})(diffusion)
    T0 = np.stack([spike(), spike()])
    with pytest.raises(ValueError, match="fused reductions"):
        iterate.solve_batch(no_reds, {"T": T0, "T2": T0}, {"dt": 0.1}, tol=1e-5, max_iters=10)
    with pytest.raises(ValueError, match="rotations"):
        iterate.solve_batch(no_rot, {"T": T0, "T2": T0}, {"dt": 0.1}, tol=1e-5, max_iters=10)
    with pytest.raises(ValueError, match="batch extent"):
        iterate.init_batch_carry(diffusion_kernel(), {"T": T0, "T2": T0[:1]})


def test_guard_name_reserved():
    kern = diffusion_kernel({iterate.GUARD_NAME: "max_abs(T2)"})
    T0 = np.stack([spike()])
    with pytest.raises(ValueError, match="reserved"):
        iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": 0.1}, tol=1e-5, max_iters=10,
                            error=iterate.GUARD_NAME)


def test_marched_kernel_batches_all_parallel():
    kern = diffusion_kernel().marched(0)
    assert iterate.batchable_kernel(kern).march_axis is None
    T0 = np.stack([spike(10, 1.0), spike(10, 1.5)])
    res = iterate.solve_batch(kern, {"T": T0, "T2": T0}, {"dt": 0.09}, tol=1e-5,
                              max_iters=300, check_every=4)
    ref = solo(diffusion_kernel(), n=10, amp=1.5, dt=0.09, max_iters=300)
    assert int(res.iters[1]) == ref.iters and torch.equal(res.fields["T"][1], ref.fields["T"])


# ---------------------------------------------------------------------------
# queue: backpressure, shed, deadlines, requeue
# ---------------------------------------------------------------------------
def test_queue_sheds_at_capacity_with_typed_error(collector):
    q = RequestQueue(capacity=2)
    q.submit(req())
    q.submit(req())
    with pytest.raises(QueueFull) as ei:
        q.submit(req())
    assert ei.value.capacity == 2 and ei.value.reason == "queue_full"
    assert collector.counters[("serve.admitted", ())] == 2
    assert collector.counters[("serve.shed", ())] == 1


def test_queue_rejects_after_close_and_fails_on_drop(collector):
    q = RequestQueue(capacity=4)
    t = q.submit(req())
    q.close(drain=False)
    with pytest.raises(ServerClosed):
        q.submit(req())
    with pytest.raises(ServerClosed):
        t.result(timeout=1.0)


def test_queue_expires_stale_requests_at_dispatch(collector):
    q = RequestQueue(capacity=4)
    t1 = q.submit(req(deadline_s=0.001))
    t2 = q.submit(req())
    time.sleep(0.01)
    batch = q.take_batch(4, timeout=0.1)
    assert [t is t2 for t in batch] == [True]
    with pytest.raises(DeadlineExceeded) as ei:
        t1.result(timeout=1.0)
    assert ei.value.where == "queued"


def test_queue_buckets_by_grid_and_scalar_names():
    q = RequestQueue(capacity=8)
    a1 = q.submit(req(n=12))
    a2 = q.submit(req(n=12))
    b1 = q.submit(req(n=16))
    c1 = q.submit(SolveRequest(fields={"T": spike(), "T2": spike()}, scalars={"h": 1.0}))
    assert {id(t) for t in q.take_batch(8, timeout=0.1)} == {id(a1), id(a2)}
    assert [id(t) for t in q.take_batch(8, timeout=0.1)] == [id(b1)]
    assert [id(t) for t in q.take_batch(8, timeout=0.1)] == [id(c1)]


def test_bucket_key_same_for_numpy_and_torch():
    a = spike()
    t = torch.from_numpy(a.copy())
    assert bucket_key({"T": a, "T2": a}) == bucket_key({"T": t, "T2": t})
    assert bucket_key({"T": a}) != bucket_key({"T": t.double()})
    assert bucket_key({"T": a}) != bucket_key({"T": t[:-1]})
    assert (SolveRequest(fields={"T": a}).bucket == SolveRequest(fields={"T": t}).bucket)


def test_requeue_goes_to_front():
    q = RequestQueue(capacity=8)
    t1, t2 = q.submit(req()), q.submit(req())
    assert q.take_batch(2, timeout=0.1) == [t1, t2]
    t3 = q.submit(req())
    q.requeue([t1, t2])
    assert q.take_batch(3, timeout=0.1) == [t1, t2, t3]


def test_fault_plan_reject_after_sheds(collector, active_plan):
    active_plan(fault.FaultPlan(reject_after=2))
    q = RequestQueue(capacity=100)
    q.submit(req())
    q.submit(req())
    with pytest.raises(QueueFull):
        q.submit(req())


def test_fault_plan_serving_keys_round_trip():
    plan = fault.FaultPlan(nan_at_step=8, nan_sample=1, reject_after=3, kill_worker_after=2,
                           wedge_worker_after=4, batch_errors=5)
    back = fault.FaultPlan.from_env({fault.PLAN_ENV: plan.to_env()})
    assert back == plan
    assert json.loads(plan.to_env())["batch_errors"] == 5
    assert back.serve_nan_due(7) is None and back.serve_nan_due(8) == 1
    with pytest.raises(fault.TransientIOError):
        back.on_batch()
    assert [back.on_submit() for _ in range(4)] == [False, False, False, True]


# queue ordering invariants over randomized schedules (the counterparts of
# tests/test_serve_properties.py)
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

SETTINGS = dict(max_examples=30, deadline=None)
FIELD = {"T": np.zeros((4, 4), np.float32)}


def _submit(q, expired: bool):
    return q.submit(SolveRequest(fields=FIELD, deadline_s=0.0 if expired else None))


def _drain(q, max_batch: int) -> list:
    out = []
    while batch := q.take_batch(max_batch, timeout=0.0):
        out += batch
    return out


@settings(**SETTINGS)
@given(expired_mask=st.lists(st.booleans(), min_size=1, max_size=24),
       max_batch=st.integers(min_value=1, max_value=6))
def test_expired_never_occupy_slots_and_fifo_survives(expired_mask, max_batch):
    q = RequestQueue(capacity=64)
    tickets = [_submit(q, e) for e in expired_mask]
    assert _drain(q, max_batch) == [t for t, e in zip(tickets, expired_mask) if not e]
    for t in (t for t, e in zip(tickets, expired_mask) if e):
        with pytest.raises(errors.DeadlineExceeded) as ei:
            t.result(timeout=0)
        assert ei.value.request_id == t.request.request_id
    assert len(q) == 0


@settings(**SETTINGS)
@given(n_waiting=st.integers(min_value=0, max_value=12),
       n_inflight=st.integers(min_value=1, max_value=12),
       max_batch=st.integers(min_value=1, max_value=5))
def test_front_requeue_preserves_both_orders(n_waiting, n_inflight, max_batch):
    q = RequestQueue(capacity=64)
    inflight = [_submit(q, False) for _ in range(n_inflight)]
    assert q.take_batch(n_inflight, timeout=0.0) == inflight
    waiting = [_submit(q, False) for _ in range(n_waiting)]
    q.requeue(inflight)
    assert _drain(q, max_batch) == inflight + waiting


@settings(**SETTINGS)
@given(resolved_mask=st.lists(st.booleans(), min_size=1, max_size=10))
def test_requeue_skips_resolved_tickets(resolved_mask):
    q = RequestQueue(capacity=64)
    inflight = [_submit(q, False) for _ in resolved_mask]
    q.take_batch(len(inflight), timeout=0.0)
    for t, done in zip(inflight, resolved_mask):
        if done:
            t.resolve({"ok": True})
    q.requeue(inflight)
    assert _drain(q, 4) == [t for t, done in zip(inflight, resolved_mask) if not done]


# ---------------------------------------------------------------------------
# the server: end-to-end robustness
# ---------------------------------------------------------------------------
POLICY = ServePolicy(max_batch=4, chunk_steps=16, check_every=4, collect_window_s=0.01,
                     queue_capacity=64)


def test_server_solves_and_matches_direct_bitwise(collector):
    kern = diffusion_kernel()
    with SimulationServer(kern, POLICY) as server:
        out = server.solve(req(dt=0.08), timeout=120.0)
    assert_same_as_solo(out, solo(kern))


def test_server_matches_reference_server():
    """The same seeded requests through the reference's server (``jnp``)
    and the port's: iterations equal, fields within FIELD_ATOL."""
    rng = np.random.RandomState(25)
    amps, dts = 0.5 + 2 * rng.rand(6), 0.08 + 0.03 * rng.rand(6)
    r_pol = r_serve.ServePolicy(max_batch=4, chunk_steps=16, check_every=4,
                                collect_window_s=0.01)
    with r_serve.SimulationServer(reference_kernel(), r_pol) as server:
        ts = [server.submit(r_serve.SolveRequest(
            fields={"T": spike(12, a), "T2": spike(12, a)}, scalars={"dt": float(d)},
            tol=1e-5, max_iters=600)) for a, d in zip(amps, dts)]
        want = [t.result(timeout=120.0) for t in ts]
    with SimulationServer(diffusion_kernel(), POLICY) as server:
        ts = [server.submit(req(amp=a, dt=float(d))) for a, d in zip(amps, dts)]
        got = [t.result(timeout=120.0) for t in ts]
    for g, w in zip(got, want):
        assert abs(w["err"] - 1e-5) / 1e-5 > TOL_MARGIN
        assert g["iters"] == w["iters"]
        for f in ("T", "T2"):
            np.testing.assert_allclose(g["fields"][f].numpy(), w["fields"][f], rtol=0,
                                       atol=FIELD_ATOL)


def test_mixed_batch_zero_lost_requests(collector):
    """Healthy + NaN-diverging + deadline-expired + out-of-budget requests
    in one serving run: healthy complete (bitwise to their solo solves),
    degraded fail with pointed typed errors, zero requests lost."""
    kern = diffusion_kernel()
    with SimulationServer(kern, POLICY) as server:
        healthy = [(1.0 + 0.3 * i, 0.08 + 0.005 * (i % 3)) for i in range(6)]
        tickets = [server.submit(req(amp=a, dt=d)) for a, d in healthy]
        nan_req = server.submit(req(dt=5.0))
        late_req = server.submit(req(tol=1e-12, max_iters=10**6, deadline_s=0.03))
        budget_req = server.submit(req(tol=1e-12, max_iters=8))
        for (a, d), t in zip(healthy, tickets):
            assert_same_as_solo(t.result(timeout=120.0), solo(kern, amp=a, dt=d))
        with pytest.raises(SampleQuarantined) as qi:
            nan_req.result(timeout=120.0)
        assert qi.value.step > 0 and "NaN/Inf guard" in str(qi.value)
        with pytest.raises(DeadlineExceeded) as di:
            late_req.result(timeout=120.0)
        assert di.value.where in ("queued", "in_batch")
        with pytest.raises(BudgetExhausted) as bi:
            budget_req.result(timeout=120.0)
        assert bi.value.iters >= 8
    c = collector.counters
    assert c[("serve.admitted", ())] == 9
    resolved = (c.get(("serve.completed", ()), 0) + c.get(("serve.quarantined", ()), 0)
                + c.get(("serve.budget_exhausted", ()), 0)
                + sum(v for (n, _), v in c.items() if n == "serve.expired"))
    assert resolved == 9, f"lost requests: {dict(c)}"
    spans = [r for r in collector.records if r["kind"] == "span" and r["name"] == "serve.request"]
    assert len(spans) == 9
    chunks = [r for r in collector.records if r["kind"] == "span" and r["name"] == "serve.chunk"]
    assert c[("serve.host_syncs", ())] == len(chunks)       # one read a chunk


def test_nan_at_step_fault_injection_quarantines(collector, active_plan):
    active_plan(fault.FaultPlan(nan_at_step=8, nan_sample=0))
    kern = diffusion_kernel()
    with SimulationServer(kern, POLICY) as server:
        t0, t1 = server.submit(req(dt=0.08)), server.submit(req(dt=0.09))
        with pytest.raises(SampleQuarantined):
            t0.result(timeout=120.0)
        assert_same_as_solo(t1.result(timeout=120.0), solo(kern, dt=0.09))
    ev = [r for r in collector.records if r["kind"] == "event"
          and r["name"] == "serve.fault_injected"]
    assert len(ev) == 1 and ev[0]["attrs"]["kind"] == "nan"


def test_poison_reaches_the_slots_current_buffers(active_plan):
    """After an odd number of steps a slot's fields lie in its partner
    buffers: the injected NaN must land in the buffers it reads."""
    active_plan(fault.FaultPlan(nan_at_step=1, nan_sample=1))
    kern = diffusion_kernel()
    pol = ServePolicy(max_batch=2, chunk_steps=3, check_every=3)
    eng, q = BatchEngine(kern, pol), RequestQueue(4)
    tickets = [q.submit(req(dt=0.08)), q.submit(req(dt=0.09))]
    state = eng.start(tickets)
    eng.run_chunk(state)
    assert state.carry.odd.tolist() == [True, True]
    eng.harvest(state)                       # poisons slot 1
    eng.run_chunk(state)
    eng.harvest(state)
    with pytest.raises(SampleQuarantined) as ei:
        tickets[1].result(timeout=1.0)
    assert ei.value.step == 6
    assert not tickets[0].done


def test_transient_batch_failures_are_retried(collector, active_plan):
    active_plan(fault.FaultPlan(batch_errors=2))
    pol = ServePolicy(max_batch=2, chunk_steps=16, check_every=4, retry_attempts=3,
                      retry_backoff_s=0.001)
    with SimulationServer(diffusion_kernel(), pol) as server:
        out = server.solve(req(dt=0.08), timeout=120.0)
    assert out["iters"] > 0
    assert collector.counters[("serve.batch_retries", ())] == 2


def test_retry_replays_only_what_precedes_the_first_launch(collector, active_plan):
    # the solver moves the carry's buffers in place: the two planned failures
    # before the first launch are retried and the solver runs once, while a
    # transient failure after its launches propagates instead of replaying
    active_plan(fault.FaultPlan(batch_errors=2))
    kern = diffusion_kernel()
    pol = ServePolicy(max_batch=2, chunk_steps=600, check_every=4, retry_attempts=3,
                      retry_backoff_s=0.001)
    eng = BatchEngine(kern, pol)
    solver, calls = eng._solver, []
    eng._solver = lambda *a: calls.append(1) or solver(*a)
    state = eng.start([RequestQueue(4).submit(req(dt=0.08))])
    eng.run_chunk(state)
    assert len(calls) == 1 and collector.counters[("serve.batch_retries", ())] == 2
    host = eng.read_state(state)
    ref = solo(kern)
    assert int(host["steps"][0]) == ref.iters and float(host["err"][0]) == ref.err

    def fails_after_launching(*a):
        calls.append(1)
        solver(*a)
        raise fault.TransientIOError("after the launches")

    eng._solver = fails_after_launching
    with pytest.raises(fault.TransientIOError):
        eng.run_chunk(eng.start([RequestQueue(4).submit(req(dt=0.08))]))
    assert len(calls) == 2


def test_breaker_trips_and_supervisor_restarts_worker(collector, active_plan):
    # 7 transient failures against 2 attempts a batch: each batch exhausts its
    # retries (a strike), threshold 2 trips the worker, the supervisor
    # restarts one, and the request still completes
    active_plan(fault.FaultPlan(batch_errors=7))
    kern = diffusion_kernel()
    pol = ServePolicy(max_batch=2, chunk_steps=16, check_every=4, retry_attempts=2,
                      retry_backoff_s=0.001, breaker_threshold=2, max_worker_restarts=2)
    with SimulationServer(kern, pol) as server:
        out = server.solve(req(dt=0.08), timeout=120.0)
    assert_same_as_solo(out, solo(kern))
    assert collector.counters[("serve.worker_restarts", ())] >= 1
    assert [r for r in collector.records
            if r["kind"] == "event" and r["name"] == "serve.breaker_tripped"]
    assert collector.counters[("serve.requeued", ())] >= 1


def test_batch_timeout_fails_stragglers_pointedly(collector):
    pol = ServePolicy(max_batch=2, chunk_steps=8, check_every=4, batch_timeout_s=0.05)
    with SimulationServer(diffusion_kernel(), pol) as server:
        t = server.submit(req(tol=1e-13, max_iters=10**7))
        with pytest.raises(DeadlineExceeded) as ei:
            t.result(timeout=120.0)
    assert ei.value.where == "batch_timeout"


def test_continuous_refill_bitwise_to_solo(collector):
    """Six requests through two slots: later ones join freed slots mid-batch
    (refill), and each result equals its solo solve bitwise."""
    kern = diffusion_kernel()
    pol = ServePolicy(max_batch=2, chunk_steps=8, check_every=4, collect_window_s=0.01)
    amps = [1.0 + 0.2 * i for i in range(6)]
    with SimulationServer(kern, pol) as server:
        tickets = [server.submit(req(amp=a)) for a in amps]
        outs = [t.result(timeout=120.0) for t in tickets]
    assert collector.counters.get(("serve.refilled", ()), 0) >= 1
    for a, out in zip(amps, outs):
        assert_same_as_solo(out, solo(kern, amp=a))


def test_engine_bind_resets_one_slot_and_refill_is_bitwise(collector):
    kern = diffusion_kernel()
    pol = ServePolicy(max_batch=3, chunk_steps=12, check_every=4)
    eng, q = BatchEngine(kern, pol), RequestQueue(8)
    first = [q.submit(req(amp=1.0, max_iters=12, tol=1e-12)), q.submit(req(amp=2.0))]
    state = eng.start(q.take_batch(3, timeout=0.1))
    eng.run_chunk(state)
    freed = eng.harvest(state)               # the budget-12 request is done
    assert freed == [0]
    with pytest.raises(BudgetExhausted):
        first[0].result(timeout=1.0)
    before = {n: v[1:].clone() for n, v in state.carry.bufs.items()}
    late = q.submit(req(amp=1.3, dt=0.1))
    state.bind(0, q.take_batch(1, timeout=0.1)[0])
    for n, v in state.carry.bufs.items():    # the other slots untouched
        assert torch.equal(v[1:], before[n])
    assert state.carry.steps.tolist()[0] == 0 and not bool(state.carry.odd[0])
    while state.n_live:
        eng.run_chunk(state)
        eng.harvest(state)
    assert_same_as_solo(late.result(timeout=1.0), solo(kern, amp=1.3, dt=0.1))
    assert_same_as_solo(first[1].result(timeout=1.0), solo(kern, amp=2.0))
    assert state.host_syncs == state.chunks


def test_engine_partial_batch_dead_slots_frozen(collector):
    pol = ServePolicy(max_batch=4, chunk_steps=16, check_every=4)
    eng = BatchEngine(diffusion_kernel(), pol)
    q = RequestQueue(8)
    t = q.submit(req(dt=0.08))
    state = eng.start([t])
    assert state.n_live == 1
    state.carry.bufs["T"][2].fill_(3.0)        # a dead slot's two buffers
    state.carry.bufs["T2"][2].fill_(-1.0)
    dead = {n: v[2].clone() for n, v in state.carry.bufs.items()}
    while state.n_live:
        eng.run_chunk(state)
        eng.harvest(state)
    assert t.result(timeout=1.0)["iters"] > 0
    for n, v in state.carry.bufs.items():
        assert torch.equal(v[2], dead[n]), n


def test_demo_outcomes_and_launch_forward(capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.__main__ import main

    assert main(["--demo", "--device", "cpu", "--n", "10", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "(expected)" in out and "quarantined" in out and "deadline" in out
    assert "OK: 3 healthy + 1 quarantine + 1 deadline (cpu)" in out
    assert launch_serve.main(["--device", "cpu", "--demo", "--n", "8", "--requests", "2"]) == 0
    assert "OK: 2 healthy" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# worker kill: a real process death (a subprocess; in-process threads cannot
# survive it)
# ---------------------------------------------------------------------------
KILL_WORKER_CODE = r"""
import json
import numpy as np
from repro_torch.serve import ServePolicy, SimulationServer, SolveRequest
from repro_torch.serve.procworker import demo_kernel

def spike(n=10):
    T = np.zeros((n, n, n), np.float32); T[5, 5, 5] = 1.0
    return T

pol = ServePolicy(max_batch=2, chunk_steps=16, check_every=4)
with SimulationServer(demo_kernel("cpu"), pol) as server:
    ts = [server.submit(SolveRequest(fields={"T": spike(), "T2": spike()}, scalars={"dt": 0.08},
                                     tol=1e-5, max_iters=600)) for _ in range(3)]
    outs = [t.result(timeout=120.0) for t in ts]
print(json.dumps({"iters": [o["iters"] for o in outs]}))
"""


@pytest.mark.parametrize("planned", [False, True])
def test_worker_kill_injection(planned):
    plan = fault.FaultPlan(kill_worker_after=1)
    r = run_proc(KILL_WORKER_CODE, {fault.PLAN_ENV: plan.to_env()} if planned else None)
    if planned:     # the injection is real: the process dies with the plan's code
        assert r.returncode == fault.KILL_EXIT_CODE, r.stderr
    else:
        assert r.returncode == 0, r.stderr
        assert all(i > 0 for i in json.loads(r.stdout.strip().splitlines()[-1])["iters"])
