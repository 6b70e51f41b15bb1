"""One OS-process serving worker draining a filesystem spool.

``python -m repro_torch.serve.procworker --spool DIR [--kernel mod:factory]
[--device cuda|cpu]``

The thread-based :class:`~repro_torch.serve.worker.Worker` shares its
process (and its failures) with the server; this worker is the
multi-process analogue used by :class:`~repro_torch.serve.pool.
ProcessWorkerPool` — a child that can be SIGKILLed without taking the pool
down. The wire protocol is files (the spool survives a dead worker by
construction):

  * ``pending/<seq>_<id>.npz`` — a request: field arrays plus a
    ``__meta__`` JSON blob (scalars, tol, max_iters, check_every);
  * claim = atomic ``os.rename`` into ``claimed/rank_<r>/`` (exactly one
    winner per request, no locks);
  * ``done/<name>.npz`` (result fields + ``__result__`` JSON) or
    ``done/<name>.err.json`` (typed failure) — written via tmp+rename so
    readers never see a torn file;
  * a crashed worker leaves its claims in ``claimed/rank_<r>/``; the
    pool's supervisor renames them back to ``pending/`` (the original
    ``<seq>`` prefix keeps recovered requests at the FRONT of the
    sorted-name order — recovery never reorders the unexpired backlog).

Liveness: the worker bumps a run-id-namespaced
:class:`~repro_torch.distributed.fault.Heartbeat` every loop (idle
included) AND between solve chunks — a claimed request is solved in
adaptively-sized blocks of ``check_every`` iterations with a bump at
every block boundary, so a legitimately long solve keeps beating and a
stale heartbeat always means wedged, never busy or idle.
``FaultPlan.kill_worker_after`` dies after N completed requests;
``wedge_worker_after`` stops progressing (and bumping) while staying
alive — the injections the pool's exit-code and stale-heartbeat
recovery tests drive.

A kernel factory takes the worker's ``device``: the built-in
:func:`demo_kernel` runs the generated CUDA kernels on ``cuda`` (the
default) and the plain ``torch`` backend on ``cpu``.
"""
from __future__ import annotations

import argparse
import importlib
import io
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from ..distributed import fault
from ..launch.multihost import ENV_HEARTBEAT_DIR, ENV_PROCESS_ID, ENV_RUN_ID

__all__ = ["demo_kernel", "write_request", "read_request",
           "write_result", "read_result", "serve_spool", "main"]

CLOSED_MARKER = "CLOSED"


# -- spool wire format -------------------------------------------------------
def write_request(path: str, fields: dict, meta: dict) -> None:
    """Atomically write one request/result npz (tmp + rename)."""
    buf = io.BytesIO()
    arrays = {f"field::{k}": np.asarray(v) for k, v in fields.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_request(path: str) -> tuple[dict, dict]:
    with np.load(path) as z:
        fields = {k[len("field::"):]: z[k] for k in z.files if k.startswith("field::")}
        meta = json.loads(bytes(z["__meta__"]).decode())
    return fields, meta


write_result = write_request
read_result = read_request


def demo_kernel(device="cuda", backend=None):
    """The built-in kernel factory (3-D diffusion with its
    ``max_abs_diff(T2, T)`` check, the serving demo's), so the pool works
    out of the box: the generated CUDA kernel on ``cuda``, the plain
    ``torch`` backend on ``cpu`` (or where ``backend="torch"``)."""
    from ..core import fd3d, init_parallel_stencil
    from ..core.device import default_backend, resolve_device

    dev = resolve_device(device)
    ps = init_parallel_stencil(backend=backend or default_backend(dev), ndims=3, device=dev)

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                 reductions={"err": "max_abs_diff(T2, T)"})
    def diffusion(T2, T, dt):
        return {"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}

    return diffusion


def _resolve_kernel(spec: str, device: str):
    mod, _, attr = spec.partition(":")
    factory = getattr(importlib.import_module(mod), attr or "demo_kernel")
    return factory(device=device)


def _claim(pending: str, claimed: str) -> Optional[str]:
    """Oldest unclaimed request, atomically moved into our claim dir
    (rename races lose silently — another worker won)."""
    for name in sorted(os.listdir(pending)):
        if not name.endswith(".npz"):
            continue
        src, dst = os.path.join(pending, name), os.path.join(claimed, name)
        try:
            os.rename(src, dst)
            return dst
        except OSError:
            continue
    return None


def _solve_beating(kernel, fields: dict, meta: dict, hb, served: int, *,
                   chunk_target_s: float = 1.0):
    """Solve one request in heartbeat-sized chunks.

    Each chunk is a plain ``solve_until`` call capped at a multiple of
    ``check_every``: the per-step arithmetic never sees the chunk
    boundary, so the result is bitwise the unchunked solve's. Between
    chunks the worker's heartbeat is bumped, so a request whose solve
    outlasts the pool's ``heartbeat_timeout_s`` is not killed as wedged,
    requeued, and killed again (a poison-pill livelock). The chunk starts
    at one check and doubles while chunks complete faster than
    ``chunk_target_s``. Returns ``(fields, total_iters, err)``, the fields
    as numpy arrays."""
    import torch

    from ..core import iterate

    scalars = meta.get("scalars") or {}
    tol = float(meta.get("tol", 0.0))
    max_iters = int(meta.get("max_iters", 100))
    check_every = int(meta.get("check_every", 1))
    cur = {k: torch.as_tensor(np.asarray(v)).to(kernel.ps.device) for k, v in fields.items()}
    if hb is None or max_iters <= check_every:
        res = iterate.solve_until(kernel, cur, scalars, tol=tol, max_iters=max_iters,
                                  check_every=check_every)
        cur, done, err = res.fields, int(res.iters), float(res.err)
    else:
        done, err, chunk = 0, float("inf"), check_every
        while done < max_iters:
            hb.bump(served)
            take = min(chunk, max_iters - done)
            t0 = time.perf_counter()
            res = iterate.solve_until(kernel, cur, scalars, tol=tol, max_iters=take,
                                      check_every=check_every)
            dt = time.perf_counter() - t0
            cur, err = res.fields, float(res.err)
            done += int(res.iters)
            hb.bump(served)
            if int(res.iters) < take or not iterate._keep_going(err, iterate._f32(tol), "below"):
                break
            if dt < chunk_target_s:
                chunk *= 2
            elif dt > 2 * chunk_target_s and chunk > check_every:
                chunk = max(check_every, chunk // 2)
    return {k: v.cpu().numpy() for k, v in cur.items()}, done, err


def serve_spool(spool: str, kernel, *, rank: int = 0, run_id: Optional[str] = None,
                heartbeat_dir: Optional[str] = None, idle_sleep_s: float = 0.02) -> int:
    """The worker loop: claim -> solve -> publish, until the pool drops
    the ``CLOSED`` marker and the backlog drains."""
    pending = os.path.join(spool, "pending")
    claimed = os.path.join(spool, "claimed", f"rank_{rank}")
    done = os.path.join(spool, "done")
    for d in (pending, claimed, done):
        os.makedirs(d, exist_ok=True)
    hb = fault.Heartbeat(heartbeat_dir, rank=rank, run_id=run_id) if heartbeat_dir else None
    plan = fault.FaultPlan.active()
    served = 0
    while True:
        if hb is not None:
            hb.bump(served)
        path = _claim(pending, claimed)
        if path is None:
            if os.path.exists(os.path.join(spool, CLOSED_MARKER)):
                return 0
            time.sleep(idle_sleep_s)
            continue
        name = os.path.basename(path)
        try:
            fields, meta = read_request(path)
            out, iters, err = _solve_beating(kernel, fields, meta, hb, served)
            write_result(os.path.join(done, name), out, {"iters": iters, "err": err, "rank": rank})
        except Exception as e:  # typed failure file — the request is
            # answered, never lost silently
            err = {"error": type(e).__name__, "detail": str(e)[:500], "rank": rank}
            tmp = os.path.join(done, name + ".err.json.tmp")
            with open(tmp, "w") as f:
                json.dump(err, f)
            os.replace(tmp, os.path.join(done, name + ".err.json"))
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
        served += 1
        if hb is not None:
            hb.bump(served)
        if plan is not None:
            plan.worker_batch_done()


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.procworker")
    ap.add_argument("--spool", required=True)
    ap.add_argument("--kernel", default="repro_torch.serve.procworker:demo_kernel",
                    help="kernel factory as module:callable, called with device=")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=int(os.environ.get(ENV_PROCESS_ID, 0)))
    args = ap.parse_args(argv)
    return serve_spool(
        args.spool, _resolve_kernel(args.kernel, args.device), rank=args.rank,
        run_id=os.environ.get(ENV_RUN_ID) or None,
        heartbeat_dir=os.environ.get(ENV_HEARTBEAT_DIR) or None)


if __name__ == "__main__":
    sys.exit(main())
