"""``python -m repro_torch.serve --demo``: a self-contained serving smoke.

Spins up a SimulationServer over the 3-D diffusion kernel, submits a
mixed workload — healthy requests, one with an unstable dt (NaN
quarantine), one with a hopeless deadline — and prints the per-request
outcomes plus the serving counters. Exits non-zero if any healthy
request fails, so it doubles as a CI smoke. ``--device cuda`` (the
default) runs the batched CUDA kernel; ``--device cpu`` the plain path.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def spike(n: int, amp: float = 1.0) -> np.ndarray:
    T = np.zeros((n, n, n), np.float32)
    T[n // 2, n // 2, n // 2] = amp
    return T


def demo(n: int = 16, requests: int = 10, device="cuda") -> int:
    from .. import telemetry
    from . import (DeadlineExceeded, SampleQuarantined, ServePolicy, SimulationServer,
                   SolveRequest)
    from .procworker import demo_kernel

    col = telemetry.configure(path=None)
    kernel = demo_kernel(device)
    pol = ServePolicy(max_batch=4, chunk_steps=32, check_every=4,
                      queue_capacity=64)
    outcomes: dict[str, str] = {}
    failures = 0
    with SimulationServer(kernel, pol) as server:
        tickets = []
        for i in range(requests):
            healthy = SolveRequest(
                fields={"T": spike(n, 1.0 + 0.2 * i),
                        "T2": spike(n, 1.0 + 0.2 * i)},
                scalars={"dt": 0.08 + 0.005 * (i % 4)},
                tol=1e-5, max_iters=600)
            tickets.append(server.submit(healthy))
        # one unstable request: dt far over the diffusion CFL -> NaN
        bad = server.submit(SolveRequest(
            fields={"T": spike(n), "T2": spike(n)},
            scalars={"dt": 5.0}, tol=1e-5, max_iters=600))
        # one hopeless deadline
        late = server.submit(SolveRequest(
            fields={"T": spike(n), "T2": spike(n)},
            scalars={"dt": 0.08}, tol=1e-12, max_iters=10**6,
            deadline_s=0.05))
        for t in tickets:
            try:
                r = t.result(timeout=60.0)
                outcomes[t.request.request_id] = (
                    f"converged in {r['iters']} steps (err {r['err']:.2e})")
            except Exception as e:
                outcomes[t.request.request_id] = f"FAILED: {e}"
                failures += 1
        for t, want in ((bad, SampleQuarantined), (late, DeadlineExceeded)):
            try:
                t.result(timeout=60.0)
                outcomes[t.request.request_id] = (
                    f"UNEXPECTED success (wanted {want.__name__})")
                failures += 1
            except want as e:
                outcomes[t.request.request_id] = f"(expected) {e}"
            except Exception as e:
                outcomes[t.request.request_id] = f"WRONG failure: {e}"
                failures += 1
    for rid, line in outcomes.items():
        print(f"  {rid:10s} {line}")
    print("\nserving counters:")
    for (name, labels), v in sorted(col.counters.items()):
        if name.startswith("serve."):
            tag = name + (str(dict(labels)) if labels else "")
            print(f"  {tag:40s} = {v}")
    print(f"\n{'OK' if failures == 0 else 'FAILED'}: "
          f"{requests} healthy + 1 quarantine + 1 deadline ({kernel.ps.device})")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Hardened simulation serving (see repro_torch/serve).")
    ap.add_argument("--demo", action="store_true",
                    help="run the self-contained serving demo/smoke")
    ap.add_argument("--n", type=int, default=16, help="demo grid extent")
    ap.add_argument("--requests", type=int, default=10,
                    help="healthy demo requests")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.demo:
        return demo(n=args.n, requests=args.requests, device=args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
