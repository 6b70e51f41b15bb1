"""The port's checkpoints (``repro_torch.checkpoint``) and the checkpointed
``solve_until``, mirroring ``tests/test_fault.py``, and held against the JAX
package's checkpoints on disk.

Contracts: a checkpointed solve and a resume from ``LATEST`` equal the plain,
uninterrupted solve BITWISE (the same torch operations in the same order).
The on-disk format is the reference's: a checkpoint that either package
writes restores in the other by path, bitwise, for f32 and f16; the
reference's bf16 files restore bitwise in the port, and the port writes bf16
files byte for byte as the reference does (the reference cannot restore its
own bf16 files: numpy reads them back as ``|V2``). Solves of the two
packages agree as ``tests/test_torch_iterate.py`` holds them: the same
iterations, fields to atol 1e-5, the error to rtol 1e-5.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.core import init_parallel_stencil as r_init, iterate as r_iterate
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import fd3d, init_parallel_stencil, iterate
from repro_torch.distributed import fault

ERR = {"err": "max_abs_diff(T2, T)"}


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def kernels(dtype=torch.float32):
    port = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype).parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=ERR)(fig1)
    ref = r_init(backend="jnp").parallel(outputs=("T2",), rotations={"T2": "T"},
                                         reductions=ERR)(fig1)
    return port, ref


def setup(rng, shape=(12, 12, 12)):
    T = rng.rand(*shape).astype(np.float32)
    Ci = (rng.rand(*shape) + 0.5).astype(np.float32)
    return {"T2": T, "T": T, "Ci": Ci}, dict(lam=1.0, dt=0.05, _dx=1.0, _dy=1.0, _dz=1.0)


def torch_fields(arrays, dtype=torch.float32):
    return {n: torch.from_numpy(a.copy()).to(dtype) for n, a in arrays.items()}


def _tree(v=0.0, n=4):
    return {"fields": {"T": torch.full((n, n), v)}, "err": torch.tensor(v)}


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# durability
# ---------------------------------------------------------------------------
def test_checkpoint_atomic_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree(float(s)))
    assert mgr.list_steps() == [30, 40]
    assert mgr.latest_step() == 40
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    tree, extra = mgr.restore(_tree())
    assert extra["step"] == 40 and float(tree["err"]) == 40.0


def test_keep_k_never_deletes_latest_pointed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (10, 20, 30):
        mgr.save(s, _tree(float(s)))
    # crash-recovery state: a newer dir landed but the LATEST swap never
    # happened, so LATEST still names an old step
    with open(os.path.join(tmp_path, "LATEST"), "w") as f:
        f.write("step_%09d" % 10)
    mgr.keep = 1
    mgr._gc()
    assert os.path.isdir(mgr.step_dir(10)), "LATEST-pointed step deleted"
    assert not os.path.isdir(mgr.step_dir(20))
    assert os.path.isdir(mgr.step_dir(30))
    _, extra = mgr.restore(_tree())      # follows the pointer, not the newest dir
    assert extra["step"] == 10


def test_restore_explicit_step_and_shape_validation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(10, _tree(1.0), extra={"iters": 10})
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(), step=99)
    with pytest.raises(CheckpointError, match="does not match restore"):
        mgr.restore({"fields": {"T": torch.zeros(8, 8)}, "err": torch.tensor(0.0)}, step=10)
    with pytest.raises(CheckpointError, match="absent from checkpoint"):
        mgr.restore({"fields": {"Q": torch.zeros(4, 4)}, "err": torch.tensor(0.0)}, step=10)
    tree, extra = mgr.restore(_tree(), step=10)
    assert extra == {"iters": 10, "step": 10} and float(tree["err"]) == 1.0
    # sequences name their items by index; restore casts to the target dtype
    mgr.save(11, [torch.arange(3.0), {"b": torch.ones(2), "a": torch.zeros(1)}])
    got, _ = mgr.restore([torch.zeros(3, dtype=torch.float16),
                          {"a": torch.ones(1), "b": torch.zeros(2)}], step=11)
    man = json.load(open(os.path.join(mgr.step_dir(11), "manifest.json")))
    assert [t["path"] for t in man["tensors"]] == ["0", "1/a", "1/b"]
    assert got[0].dtype == torch.float16 and torch.equal(got[0], torch.arange(3.0).half())
    assert torch.equal(got[1]["a"], torch.zeros(1)) and torch.equal(got[1]["b"], torch.ones(2))


def test_corrupt_checkpoint_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(10, _tree(1.0))
    mgr.save(20, _tree(2.0))
    # tear the newest step's first tensor (a short read on restore)
    d = mgr.step_dir(20)
    victim = os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(CheckpointError):        # an explicit step never falls back
        mgr.restore(_tree(), step=20)
    tree, extra = mgr.restore(_tree())
    assert extra["step"] == 10 and [s for s, _ in extra["skipped_corrupt"]] == [20]
    assert float(tree["err"]) == 1.0


@pytest.fixture()
def active_plan(monkeypatch):
    def install(plan: fault.FaultPlan):
        monkeypatch.setenv(fault.PLAN_ENV, plan.to_env())
        fault.FaultPlan.reset_active()
        return fault.FaultPlan.active()
    yield install
    fault.FaultPlan.reset_active()


def test_fault_plan_tears_scheduled_save(tmp_path, active_plan):
    active_plan(fault.FaultPlan(corrupt_checkpoint=2))
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(10, _tree(1.0))
    mgr.save(20, _tree(2.0))   # the torn one
    _, extra = mgr.restore(_tree())
    assert extra["step"] == 10 and extra["skipped_corrupt"]


def test_transient_io_errors_absorbed_by_retry(tmp_path, active_plan):
    plan = active_plan(fault.FaultPlan(io_errors=3))
    mgr = CheckpointManager(str(tmp_path), keep=3, retry_backoff_s=0.001)
    mgr.save(10, _tree(5.0))   # the write path retries through the budget
    assert plan.io_errors == 0
    tree, extra = mgr.restore(_tree())
    assert extra["step"] == 10 and float(tree["err"]) == 5.0


def test_async_save_failure_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3, retry_attempts=1)
    monkeypatch.setattr(mgr, "_write", lambda *a, **k: (_ for _ in ()).throw(OSError("disk")))
    mgr.save(10, _tree(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()


def test_async_snapshot_is_a_copy(tmp_path):
    """The write runs behind the caller: changing a tensor after save()
    returns must not change what lands on disk."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(3.0)
    mgr.save(1, tree, blocking=False)
    tree["fields"]["T"].fill_(-1.0)
    mgr.wait()
    got, _ = mgr.restore(_tree())
    assert torch.equal(got["fields"]["T"], torch.full((4, 4), 3.0))


# ---------------------------------------------------------------------------
# the checkpointed solve: bitwise contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_iters", [60, 62])
def test_checkpointed_solve_bitwise_equals_plain(tmp_path, rng, dtype, max_iters):
    arrays, sc = setup(rng)
    kern, _ = kernels(dtype)
    f = torch_fields(arrays, dtype)
    plain = iterate.solve_until(kern, f, sc, tol=1e-6, max_iters=max_iters, check_every=5)
    ck = iterate.Checkpointing(str(tmp_path), save_every=2, blocking=dtype == torch.float32)
    chunked = iterate.solve_until(kern, f, sc, tol=1e-6, max_iters=max_iters, check_every=5,
                                  checkpoint=ck)
    assert (chunked.iters, chunked.err) == (plain.iters, plain.err)
    assert chunked.host_syncs == plain.host_syncs == plain.iters // 5
    for n in f:
        assert torch.equal(chunked.fields[n], plain.fields[n])
    assert chunked.fields["T"].dtype == dtype
    # a save every 2 checks, and one after the last (short) chunk
    assert chunked.saved_steps == (*range(10, plain.iters, 10), plain.iters)
    assert chunked.resumed_from is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_resume_midway_bitwise_equals_uninterrupted(tmp_path, rng, dtype):
    # tol=inf with until="above" runs to max_iters at any storage dtype (a
    # 2-byte solve under tol=0 stops where its steps fall below one ulp)
    arrays, sc = setup(rng)
    kern, _ = kernels(dtype)
    f = torch_fields(arrays, dtype)
    kw = dict(tol=float("inf"), until="above", check_every=4)
    full = iterate.solve_until(kern, f, sc, max_iters=80, **kw)
    ck = iterate.Checkpointing(str(tmp_path), save_every=5, blocking=True)
    part = iterate.solve_until(kern, f, sc, max_iters=40, checkpoint=ck, **kw)
    assert part.iters == 40
    resumed = iterate.solve_until(kern, f, sc, max_iters=80, checkpoint=ck, **kw)
    assert resumed.resumed_from == 40 and resumed.iters == full.iters == 80
    assert resumed.err == full.err
    for n in f:
        assert torch.equal(resumed.fields[n], full.fields[n])
    # a finished run that is restarted resumes and stops at once
    again = iterate.solve_until(kern, f, sc, max_iters=80, checkpoint=ck, **kw)
    assert again.resumed_from == 80 and again.iters == 80 and again.saved_steps == ()
    fresh = iterate.solve_until(kern, f, sc, max_iters=8, **kw,
                                checkpoint=iterate.Checkpointing(str(tmp_path), resume=False))
    assert fresh.resumed_from is None and fresh.iters == 8


def test_until_above_resume_and_error_callable(tmp_path, rng):
    """GP's drift guard: the error is a callable over 0-d reductions; the
    checkpoint carries its value as f32, and a resume stops where the
    uninterrupted run stops."""
    arrays, sc = setup(rng, (10, 10, 10))
    kern, _ = kernels()
    kern = kern.with_reductions({"m": "sum_sq(T2)"})
    f = torch_fields(arrays)
    m0 = float((f["T"] ** 2).sum())

    def drift(r):
        return torch.abs(r["m"] - m0) / m0

    kw = dict(tol=0.02, check_every=5, error=drift, until="above")
    full = iterate.solve_until(kern, f, dict(sc, dt=1e-3), max_iters=200, **kw)
    assert 0 < full.iters < 200
    ck = iterate.Checkpointing(str(tmp_path), save_every=1, blocking=True)
    iterate.solve_until(kern, f, dict(sc, dt=1e-3), max_iters=10, checkpoint=ck, **kw)
    man = json.load(open(os.path.join(str(tmp_path), "step_000000010", "manifest.json")))
    assert {t["path"]: t["dtype"] for t in man["tensors"]} == {
        "err": "float32", "fields/Ci": "float32", "fields/T": "float32",
        "fields/T2": "float32", "reds/m": "float32"}
    resumed = iterate.solve_until(kern, f, dict(sc, dt=1e-3), max_iters=200, checkpoint=ck, **kw)
    assert (resumed.resumed_from, resumed.iters, resumed.err) == (10, full.iters, full.err)
    assert torch.equal(resumed.fields["T"], full.fields["T"])


def test_save_every_must_be_positive(tmp_path, rng):
    arrays, sc = setup(rng, (6, 6, 6))
    kern, _ = kernels()
    with pytest.raises(ValueError, match="save_every"):
        iterate.solve_until(kern, torch_fields(arrays), sc, tol=0.0, max_iters=4,
                            checkpoint=iterate.Checkpointing(str(tmp_path), save_every=0))


# ---------------------------------------------------------------------------
# across packages: the same files, the same solves
# ---------------------------------------------------------------------------
_NP = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path, rng, dtype):
    vals = (rng.randn(5, 7) * 100).astype(_NP[dtype])
    RefManager(str(tmp_path)).save(12, {"fields": {"T": jnp.asarray(vals)},
                                        "err": jnp.float32(0.25)}, extra={"iters": 12})
    like = {"fields": {"T": torch.zeros(5, 7, dtype=getattr(torch, dtype))},
            "err": torch.zeros(())}
    tree, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert extra == {"iters": 12, "step": 12}
    got = tree["fields"]["T"]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(bits(got), vals.view(np.int16) if dtype == "bfloat16"
                                  else vals)
    assert float(tree["err"]) == 0.25


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_port_checkpoint_files_are_the_references(tmp_path, rng, dtype):
    """The port's files: byte for byte the reference's .npy files, the same
    manifest entries, and (f32, f16) restored bitwise by the reference."""
    vals = (rng.randn(5, 7) * 100).astype(_NP[dtype])
    t = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16) if dtype == "bfloat16" \
        else torch.from_numpy(vals)
    CheckpointManager(str(tmp_path / "port")).save(3, {"fields": {"T": t},
                                                       "err": torch.tensor(0.5)})
    RefManager(str(tmp_path / "ref")).save(3, {"fields": {"T": jnp.asarray(vals)},
                                               "err": jnp.float32(0.5)})
    step = "step_000000003"
    mans = [json.load(open(tmp_path / w / step / "manifest.json")) for w in ("port", "ref")]
    assert mans[0]["tensors"] == mans[1]["tensors"]
    for entry in mans[0]["tensors"]:
        assert ((tmp_path / "port" / step / entry["file"]).read_bytes()
                == (tmp_path / "ref" / step / entry["file"]).read_bytes())
    if dtype == "bfloat16":
        return   # the reference reads its own bf16 files as |V2 and refuses them
    tree, _ = RefManager(str(tmp_path / "port")).restore(
        {"fields": {"T": jnp.zeros((5, 7), _NP[dtype])}, "err": jnp.float32(0)})
    np.testing.assert_array_equal(np.asarray(tree["fields"]["T"]), vals)
    assert float(tree["err"]) == 0.5


def test_checkpointed_solves_agree_across_packages(tmp_path, rng):
    arrays, sc = setup(rng)
    port, ref = kernels()
    kw = dict(tol=2e-5, max_iters=400, check_every=5)
    got = iterate.solve_until(port, torch_fields(arrays), sc,
                              checkpoint=iterate.Checkpointing(str(tmp_path / "p"), save_every=3),
                              **kw)
    want = r_iterate.solve_until(ref, {n: jnp.asarray(a) for n, a in arrays.items()}, sc,
                                 checkpoint=r_iterate.Checkpointing(str(tmp_path / "r"),
                                                                    save_every=3), **kw)
    assert 0 < got.iters < 400 and got.iters == int(want.iters)
    assert got.saved_steps == tuple(want.saved_steps)
    np.testing.assert_allclose(got.err, float(want.err), rtol=1e-5)
    for n in ("T", "T2"):
        np.testing.assert_allclose(got.fields[n].numpy(), np.asarray(want.fields[n]), atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_run_started_in_one_package_resumes_in_the_other(tmp_path, rng, writer):
    arrays, sc = setup(rng)
    port, ref = kernels()
    kw = dict(tol=0.0, check_every=4)
    ck = str(tmp_path / "ck")
    jf = {n: jnp.asarray(a) for n, a in arrays.items()}
    if writer == "port":
        iterate.solve_until(port, torch_fields(arrays), sc, max_iters=20, checkpoint=ck, **kw)
        res = r_iterate.solve_until(ref, jf, sc, max_iters=40,
                                    checkpoint=r_iterate.Checkpointing(ck), **kw)
        full = r_iterate.solve_until(ref, jf, sc, max_iters=40, **kw)
        got, want = np.asarray(res.fields["T"]), np.asarray(full.fields["T"])
    else:
        r_iterate.solve_until(ref, jf, sc, max_iters=20, checkpoint=r_iterate.Checkpointing(ck),
                              **kw)
        res = iterate.solve_until(port, torch_fields(arrays), sc, max_iters=40, checkpoint=ck,
                                  **kw)
        full = iterate.solve_until(port, torch_fields(arrays), sc, max_iters=40, **kw)
        got, want = res.fields["T"].numpy(), full.fields["T"].numpy()
    assert res.resumed_from == 20 and int(res.iters) == 40
    np.testing.assert_allclose(got, want, atol=1e-5)
