"""The port stands alone: it imports neither ``jax`` nor the JAX package
``repro``, and state crosses between the two only through numpy
(``repro_torch.interop``)."""
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.interop import fields_from_numpy, fields_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["repro"] = None        # and so does any `import repro...`
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import torch
from repro_torch.configs import Diffusion3DConfig
from repro_torch.examples import quickstart
r = quickstart.run(Diffusion3DConfig(nx=8, ny=8, nz=8, nt=1), device="cpu",
                   max_iters=1, check_every=1)
assert torch.equal(r.T, r.T_explicit) and bool(torch.isfinite(r.T).all())
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m in sys.modules if sys.modules[m] is not None)
print("imported", len(names), "modules")
"""


def test_port_imports_and_steps_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "imported" in p.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE)


def test_no_jax_or_repro_imports_in_the_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("import repro.core") and _FORBIDDEN.search("from jax import x")
    assert not _FORBIDDEN.search("from repro_torch import core")


def test_interop_round_trip(rng):
    arrays = {"T": rng.rand(5, 6, 7).astype(np.float32),
              "Ci": np.asarray(jnp.asarray(rng.rand(5, 6, 7), jnp.float32))}
    fields = fields_from_numpy(arrays, device="cpu")
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in fields.values())
    back = fields_to_numpy(fields)
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a)
    fields["T"][0, 0, 0] = -1.0          # the tensors own their storage
    assert arrays["T"][0, 0, 0] != -1.0
    f64 = fields_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert f64["T"].dtype == torch.float64
