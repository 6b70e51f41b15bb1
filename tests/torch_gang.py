"""Helpers for the port's multi-process CPU tests: a gang of fresh
interpreters joined by ``repro_torch.launch.multihost.initialize`` into one
gloo process group.

Every gang has its own timeout and is killed on expiry: a dead peer wedges
the others inside gloo, and a hang would cost the whole suite. Ranks run
one thread each (``torch.set_num_threads(1)``).
"""
import os
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

PRELUDE = """
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import multihost
ctx = multihost.initialize(backend="gloo", timeout_s=30, collective_timeout_s=60)
"""


# every rank leaves the gang last: a gloo group left up can abort at exit
POSTLUDE = """
multihost.shutdown()
"""


def rank_env(world: int, rank: int, coordinator: str, extra: dict | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               REPRO_COORDINATOR=coordinator, REPRO_NUM_PROCESSES=str(world),
               REPRO_PROCESS_ID=str(rank))
    env.pop("REPRO_FAULT_PLAN", None)
    env.update(extra or {})
    return env


def run_gang(code: str, world: int, timeout: float = 60.0, env: dict | None = None,
             prelude: str = PRELUDE, check: bool = True) -> list[tuple[int, str]]:
    """Run ``prelude + code`` as ranks 0..world-1 of one gang; returns
    ``[(exit code, output)]`` by rank, and (with ``check``) asserts every
    rank exited 0. The gang is killed when ``timeout`` seconds pass."""
    from repro_torch.launch.multihost import default_coordinator

    coord = default_coordinator()
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as td:
        try:
            for rank in range(world):
                log = open(os.path.join(td, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", prelude + code + POSTLUDE], stdout=log,
                    stderr=subprocess.STDOUT, text=True, env=rank_env(world, rank, coord, env)))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    raise AssertionError(f"gang of {world} still running after {timeout}s: "
                                         + _tails(logs))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for p, log in zip(procs, logs):
            log.seek(0)
            out.append((p.returncode, log.read()))
            log.close()
    if check:
        bad = [(r, rc, text) for r, (rc, text) in enumerate(out) if rc != 0]
        assert not bad, "\n".join(f"rank {r} exited {rc}:\n{text}" for r, rc, text in bad)
    return out


def _tails(logs) -> str:
    parts = []
    for r, log in enumerate(logs):
        log.flush()
        log.seek(0)
        parts.append(f"--- rank {r}:\n{log.read()[-2000:]}")
    return "\n".join(parts)


def results(out: list[tuple[int, str]], tag: str = "RESULT") -> list:
    """The JSON objects each rank printed on lines ``<tag> {...}``, by rank."""
    import json

    return [[json.loads(line[len(tag) + 1:]) for line in text.splitlines()
             if line.startswith(tag + " ")] for _, text in out]
