"""The port's elastic runtime (``repro_torch.distributed.elastic``): the
decomposition policy against the JAX package's, and the distributed
``elastic_solve_until`` on gloo gangs of CPU processes.

Comparison contract: every cell's arithmetic is the single-process step's
and the check folds each rank's owned cells, so a gang's gathered fields,
iterations and max-kind error equal the port's single-process
``solve_until`` bitwise; a run killed on one gang and resumed on a smaller
or larger one equals the uninterrupted run bitwise too. Against the
reference's own elastic solve (``shard_map`` on fake CPU devices) the
fields agree to atol 1e-5, the reference's cross-mesh tolerance.
"""
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro.distributed import elastic as r_elastic
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import init_parallel_stencil, iterate
from repro_torch.distributed import elastic, fault
from repro_torch.launch import multihost
from torch_gang import results, run_gang


# ---------------------------------------------------------------------------
# the decomposition policy, against the reference's functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,ndims", [(8, 1), (8, 2), (7, 2), (12, 3), (4, 2), (6, 3), (1, 2)])
def test_plan_factors_match_reference(n, ndims):
    assert elastic.plan_factors(n, ndims) == r_elastic.plan_factors(n, ndims)
    assert int(np.prod(elastic.plan_factors(n, ndims))) == n


@pytest.mark.parametrize("shape,radius,world,ndims", [
    ((18, 18, 18), 1, 3, 1), ((18, 18, 18), 1, 4, 1), ((512, 512, 512), 1, 4, 2),
    ((512, 512, 512), 1, 4, 1), ((130, 130, 130), 1, 3, 1), ((512, 512, 512), 2, 2, 1)])
def test_plan_compatible_matches_reference(shape, radius, world, ndims):
    assert (elastic.plan_compatible(shape, radius, world, ndims)
            == r_elastic.plan_compatible(shape, radius, world, ndims))


def test_validate_and_plan_errors_are_pointed():
    elastic.validate_stencil_factors((18, 18, 18), (4,), radius=1)
    with pytest.raises(ValueError, match="does not divide"):
        elastic.validate_stencil_factors((18, 18, 18), (5,), radius=1)
    with pytest.raises(ValueError, match="thinner than the ghost ring"):
        elastic.validate_stencil_factors((12, 12, 12), (8,), radius=2)
    with pytest.raises(ValueError, match="thinner than one ghost ring"):
        elastic.plan_compatible((3, 3, 3), 2, 4)
    # FIG1's 510 interior splits 2 x 2 but not 4 ways along one axis
    assert elastic.plan_compatible((512, 512, 512), 1, 4, 2) == (4, (2, 2))
    with pytest.raises(ValueError, match="does not divide"):
        elastic.validate_stencil_factors((512, 512, 512), (4,), radius=1)


def test_decompose_gather_roundtrip_matches_reference(rng):
    g = rng.rand(18, 10).astype(np.float32)
    st = elastic.decompose_fields({"T": torch.from_numpy(g)}, (4,), radius=1)
    want = r_elastic.decompose_fields({"T": g}, (4,), radius=1)
    np.testing.assert_array_equal(st["T"].numpy(), want["T"])
    back = elastic.gather_fields(st, (4,), radius=1)
    np.testing.assert_array_equal(back["T"].numpy(), g)


def test_supervise_replans_world_and_succeeds():
    seen = []

    def attempt(i, world):
        seen.append((i, world))
        return fault.KILL_EXIT_CODE if i < 2 else 0

    attempts, final_world, codes = elastic.supervise(attempt, 4)
    assert (attempts, final_world) == (2, 2)
    assert codes == [fault.KILL_EXIT_CODE, fault.KILL_EXIT_CODE, 0]
    assert seen == [(0, 4), (1, 3), (2, 2)]
    assert elastic.supervise(attempt, 4) == r_elastic.supervise(
        lambda i, w: fault.KILL_EXIT_CODE if i < 2 else 0, 4)


def test_supervise_gives_up_after_max_restarts():
    with pytest.raises(RuntimeError, match="gave up"):
        elastic.supervise(lambda i, w: 1, 4, max_restarts=2)


# ---------------------------------------------------------------------------
# elastic: a kill on one gang, a resume on another
# ---------------------------------------------------------------------------
_ELASTIC = r"""
from repro_torch.core import init_parallel_stencil, iterate
from repro_torch.distributed import elastic
from repro_torch.launch.multihost import demo_initial, demo_kernel
kern = demo_kernel(init_parallel_stencil(backend="torch", device="cpu"))
T0 = demo_initial(18)      # interior 16: divides over 1, 2 and 4 ranks
ck = iterate.Checkpointing(os.environ["CKPT"], save_every=1, blocking=True)
res = elastic.elastic_solve_until(
    kern, dict(T2=T0, T=T0), dict(dt=1e-3), factors=(ctx.world,), tol=0.0,
    max_iters=int(os.environ["ITERS"]), exchange=("T",), check_every=4, checkpoint=ck)
if ctx.rank == 0:
    np.save(os.environ["OUT"], res.fields["T"].numpy())
print("RESULT", json.dumps({"iters": res.iters, "resumed_from": res.resumed_from,
                            "saved": list(res.saved_steps), "err": res.err}))
"""

_REF_ELASTIC = r"""
import numpy as np, jax
from repro.core import fd3d, init_parallel_stencil, iterate
from repro.distributed import elastic
ps = init_parallel_stencil(backend="jnp", ndims=3)

@ps.parallel(outputs=("T2",), rotations={{"T2": "T"}},
             reductions={{"err": "max_abs_diff(T2, T)"}})
def kern(T2, T, dt):
    return {{"T2": fd3d.inn(T) + dt * (fd3d.d2_xi(T) + fd3d.d2_yi(T) + fd3d.d2_zi(T))}}

T0 = np.asarray(np.random.RandomState(0).rand(18, 18, 18), np.float32)
res = elastic.elastic_solve_until(kern, dict(T2=T0, T=T0), dict(dt=1e-3), factors=(4,),
                                  tol=0.0, max_iters=40, exchange=("T",), check_every=4,
                                  checkpoint=iterate.Checkpointing({ck!r}, save_every=1,
                                                                   blocking=True))
np.save({out!r}, np.asarray(res.fields["T"]))
print("REF_OK", int(res.iters))
"""


def _uninterrupted(tmp_path) -> np.ndarray:
    """The same solve on one rank in this process (no process group)."""
    kern = multihost.demo_kernel(init_parallel_stencil(backend="torch", device="cpu"))
    T0 = multihost.demo_initial(18)
    res = elastic.elastic_solve_until(kern, dict(T2=T0, T=T0), dict(dt=1e-3), factors=(1,),
                                      tol=0.0, max_iters=40, exchange=("T",), check_every=4,
                                      checkpoint=str(tmp_path / "one"))
    plain = iterate.solve_until(kern, dict(T2=T0, T=T0), dict(dt=1e-3), tol=0.0,
                                max_iters=40, check_every=4)
    assert res.iters == plain.iters == 40 and res.err == plain.err
    assert torch.equal(res.fields["T"], plain.fields["T"])
    return res.fields["T"].numpy()


@pytest.mark.parametrize("first,then", [(4, 2), (2, 4)])
def test_elastic_kill_then_resume_on_another_gang(first, then, tmp_path):
    """4 ranks die at iteration 20 (after the save at 20) and 2 resume, or
    2 ranks run to 20 and 4 resume; both equal the uninterrupted run."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.npy")
    env = {"CKPT": ck, "OUT": out, "ITERS": "40"}
    if first == 4:
        killed = run_gang(_ELASTIC, 4, timeout=90, check=False,
                          env=dict(env, REPRO_FAULT_PLAN=fault.FaultPlan(
                              kill_at_step=20).to_env()))
        assert [rc for rc, _ in killed] == [fault.KILL_EXIT_CODE] * 4, killed
    else:
        capped = results(run_gang(_ELASTIC, 2, timeout=90, env=dict(env, ITERS="20")))
        assert capped[0][0]["iters"] == 20
    assert CheckpointManager(ck).latest_step() == 20
    resumed = results(run_gang(_ELASTIC, then, timeout=90, env=env))
    for r in resumed:
        assert r[0]["iters"] == 40 and r[0]["resumed_from"] == 20
        assert r[0]["saved"] == [24, 28, 32, 36, 40]
    np.testing.assert_array_equal(np.load(out), _uninterrupted(tmp_path))
    if first == 4:
        ref = str(tmp_path / "ref.npy")
        assert "REF_OK 40" in run_subprocess(
            _REF_ELASTIC.format(ck=str(tmp_path / "rck"), out=ref), n_devices=4, timeout=240)
        np.testing.assert_allclose(np.load(out), np.load(ref), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the overlapped elastic solve on 2 x 2 ranks against solve_until
# ---------------------------------------------------------------------------
_OVERLAPPED = r"""
from repro_torch.core import fd3d, init_parallel_stencil
from repro_torch.distributed import elastic, halo
exec(os.environ["FIG1_SRC"])
ps = init_parallel_stencil(backend="torch", device="cpu")
kern = ps.parallel(outputs=("T2",), rotations={"T2": "T"},
                   reductions={"err": "max_abs_diff(T2, T)"})(fig1)
d = {k: torch.from_numpy(v) for k, v in np.load(os.environ["INP"]).items()}
sc = json.loads(os.environ["SC"])
tol = float(os.environ["TOL"])
timer = halo.ExchangeTimer()
res = {}
for step, to in (("overlapped", 0), ("sequential", None)):
    r = elastic.elastic_solve_until(
        kern, dict(T2=d["T"], T=d["T"], Ci=d["Ci"]), sc, factors=(2, 2), tol=tol,
        max_iters=60, exchange=("T",), check_every=4, step=step, gather_to=to,
        timer=timer if step == "overlapped" else None)
    res[step] = {"iters": r.iters, "err": r.err, "syncs": r.host_syncs,
                 "fields": sorted(r.fields)}
    if r.fields:
        np.save(os.environ["OUT"] + f"_{step}_{ctx.rank}.npy", r.fields["T"].numpy())
sec = timer.seconds()
res["timer"] = {"exchanges": timer.exchanges, "parts": sorted(k for k, v in sec.items() if v > 0)}
print("RESULT", json.dumps(res))
"""


def test_overlapped_elastic_solve_equals_solve_until(tmp_path, rng):
    from test_torch_overlap import SC, _fig1_src, _kernel

    T = rng.rand(18, 18, 8).astype(np.float32)
    Ci = (rng.rand(18, 18, 8) + 0.5).astype(np.float32)
    kern = _kernel({"err": "max_abs_diff(T2, T)"})
    f = {"T2": torch.from_numpy(T), "T": torch.from_numpy(T), "Ci": torch.from_numpy(Ci)}
    # tol: the error at the third check, so both must stop exactly there
    tol = iterate.solve_until(kern, f, SC, tol=0.0, max_iters=12, check_every=4).err
    want = iterate.solve_until(kern, f, SC, tol=tol, max_iters=60, check_every=4)
    assert want.iters == 12
    inp, out = str(tmp_path / "inp.npz"), str(tmp_path / "T")
    np.savez(inp, T=T, Ci=Ci)
    res = [r[0] for r in results(run_gang(
        _OVERLAPPED, 4, timeout=90, env={"INP": inp, "OUT": out, "SC": json.dumps(SC),
                                         "TOL": repr(tol), "FIG1_SRC": _fig1_src()}))]
    for rank, r in enumerate(res):
        for step in ("overlapped", "sequential"):
            assert r[step]["iters"] == 12 and r[step]["err"] == want.err
            assert r[step]["syncs"] == 3
            got = np.load(f"{out}_{step}_{rank}.npy") if r[step]["fields"] else None
            if got is not None:
                np.testing.assert_array_equal(got, want.fields["T"].numpy())
        assert r["overlapped"]["fields"] == (["Ci", "T", "T2"] if rank == 0 else [])
        assert r["sequential"]["fields"] == ["Ci", "T", "T2"]
        assert r["timer"]["exchanges"] == 12
        assert r["timer"]["parts"] == ["pack", "sendrecv", "unpack"]    # no host staging on CPU
