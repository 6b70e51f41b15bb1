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
from repro_torch.core import boundary
from repro_torch.examples import gross_pitaevskii, porosity_waves
from repro_torch.ir import bc
p = porosity_waves.solve(porosity_waves.PorosityConfig(n=12, nt=2, device="cpu",
                                                       flux_split=True))
g = gross_pitaevskii.solve(gross_pitaevskii.GPConfig(n=8, nt=2, device="cpu",
                                                     bc="neumann"))
assert bool(torch.isfinite(p["phi"]).all()) and bool(torch.isfinite(g["re"]).all())
assert torch.equal(bc.BoundaryCondition("periodic").apply(g["re"]),
                   boundary.periodic(g["re"]))
import repro_torch.serve
from repro_torch.serve.__main__ import main as serve_main
assert serve_main(["--demo", "--device", "cpu", "--n", "8", "--requests", "2"]) == 0
import repro_torch.kernels.autotune, repro_torch.launch.roofline, repro_torch.data.physics
from repro_torch.core import Grid, init_parallel_stencil
from repro_torch.data import physics
from repro_torch.kernels import autotune
from repro_torch.launch import roofline
kern = autotune.diffusion3d_kernel(init_parallel_stencil(backend="torch", device="cpu"))
f = {n: (8, 8, 16) for n in ("T2", "T", "Ci")}
sc = dict(lam=1.0, dt=1e-4, _dx=7.0, _dy=7.0, _dz=15.0)
assert autotune.tile_candidates(kern, f, sc, 2, None, 3)[0] == kern.compiled(nsteps=2, **f, **sc).shape
assert roofline.stencil_roofline(kern.cost_model(**f, **sc))["dominant"] == "memory"
assert physics.random_porosity(torch.Generator().manual_seed(0), Grid((6, 5)), device="cpu").shape == (6, 5)
import repro_torch.models.transformer, repro_torch.models.moe, repro_torch.models.encdec
from repro_torch import configs
from repro_torch.models import build as build_lm, synth_batch
assert len(configs.ARCH_IDS) == 10
families = set()
for a in configs.ARCH_IDS:
    cfg = configs.get_arch(a)
    if cfg.family in families:
        continue
    families.add(cfg.family)
    lm = build_lm(configs.get_smoke(a), device="cpu")
    lp = lm.init(torch.Generator().manual_seed(0))
    logits, cache = lm.prefill(lp, synth_batch(lm, torch.Generator().manual_seed(1), 8, 1), 9)
    logits, cache = lm.decode_step(lp, logits.argmax(-1), cache, 8)
    assert logits.shape == (1, 256) and bool(torch.isfinite(logits).all())
assert families == {"dense", "moe", "ssm", "vlm", "encdec", "hybrid"}, families
import repro_torch.optim, repro_torch.data.tokens, repro_torch.launch.train
from repro_torch.launch import train as lm_train
_, opt, hist = lm_train.train("mamba2-130m", lm_train.TrainLoopConfig(
    steps=2, seq_len=16, global_batch=2, log_every=100), smoke=True, device="cpu",
    log_fn=lambda *a: None)
assert len(hist) == 2 and all(h == h for h in hist) and int(opt["count"]) == 2
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
