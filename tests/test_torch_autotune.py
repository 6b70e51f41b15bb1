"""The port's launch autotuner (``repro_torch.kernels.autotune``) and
``parallel(tile=)`` on the CPU, against the reference's
``repro.kernels.autotune`` on identical inputs.

Nothing here is timed: both packages' timers are replaced by a fixed table
of times (the reference's ``teff.measure`` through its module, the port's
``autotune._measure``), so the decisions compared are the tuners' own:
the same candidates, fake times and cost model give the same winner,
``candidates_tried`` and ``candidates_pruned``. Kernels launched on the
CPU run their plain versions (the ``torch`` backend), held bitwise to k
single steps; candidate layouts of the generated kernel are rehearsed
(``repro_torch.kernels.rehearse``) bitwise to k single steps of the
``torch`` backend.
"""
import dataclasses
import json
import threading

import jax.numpy as jnp
import pytest
import torch

from repro.core import teff as r_teff
from repro.ir import StencilCostModel as RCost, count_flops as r_count_flops
from repro.kernels import autotune as r_autotune
from repro_torch import telemetry
from repro_torch.core import fd2d, init_parallel_stencil, teff
from repro_torch.ir import StencilCostModel, count_flops
from repro_torch.kernels import autotune, codegen, rehearse, stencil
from repro_torch.launch import tune_stencil

Shape = codegen.KernelShape
SHAPE3 = (16, 16, 16)
F3 = {n: SHAPE3 for n in ("T2", "T", "Ci")}
SC3 = dict(lam=1.0, dt=1e-4, _dx=15.0, _dy=15.0, _dz=15.0)


@pytest.fixture(autouse=True)
def _fresh_caches():
    autotune._CACHE.clear()
    r_autotune._CACHE.clear()
    yield
    autotune._CACHE.clear()
    r_autotune._CACHE.clear()


def _key(tile):
    return None if tile is None else tuple(tile)


class FakeTimes:
    """A fixed table of seconds a step by (tile, k, march), in place of both
    packages' timers; ``calls`` records what each measured. A step made by
    :meth:`make_step` names its candidate; a real one (the diffusion
    tuners') is taken to be the next of ``order``. Nothing is run."""

    def __init__(self, table=None, default=1e-3):
        self.table, self.default = dict(table or {}), default
        self.calls, self.order = [], []

    def seconds(self, tile, k, march):
        return self.table.get((_key(tile), k, march), self.default) * k

    def make_step(self, tile, k, march=None):
        def step():
            raise AssertionError("a fake timer runs no step")
        step.candidate = (_key(tile), k, march)
        return step

    def _time(self, fn):
        cand = getattr(fn, "candidate", None) or self.order[len(self.calls)]
        self.calls.append(cand)
        return self.seconds(*cand)

    def port(self, fn, iters, device):
        s = self._time(fn)
        return teff.Measurement(s, (s, s), [s])

    def ref(self, fn, iters=5, warmup=1, inner=1):
        s = self._time(fn)
        return r_teff.Measurement(s, (s, s), [s])


@pytest.fixture()
def fake(monkeypatch):
    t = FakeTimes()
    monkeypatch.setattr(autotune, "_measure", t.port)
    monkeypatch.setattr(r_autotune.teff, "measure", t.ref)
    return t


class _HW:
    name = "H100 data sheet"
    peak_bw, peak_flops = 3.35e12, 67e12


def _costs(shape=(64, 64), n_fields=3):
    kw = dict(shape=shape, itemsize=4, read_bytes=2 * 64 * 64 * 4, write_bytes=64 * 64 * 4,
              halo=((1, 1),) * len(shape), field_offsets=((0,) * len(shape),) * n_fields)
    return StencilCostModel(flops=count_flops({}), **kw), RCost(flops=r_count_flops({}), **kw)


def _both(fake, **kw):
    """The same search in both packages: the port's result, the
    reference's, and the candidates each timed."""
    port_cost, ref_cost = kw.pop("costs", (None, None))
    fake.calls.clear()
    port = autotune.autotune(fake.make_step, cost_model=port_cost, device="cpu", **kw)
    port_calls = list(fake.calls)
    fake.calls.clear()
    ref = r_autotune.autotune(fake.make_step, cost_model=ref_cost, **kw)
    return port, ref, port_calls, list(fake.calls)


def _same(port, ref):
    assert (_key(port.tile), port.nsteps, port.march_axis) == \
        (_key(ref.tile), ref.nsteps, ref.march_axis)
    assert port.per_step_s == ref.per_step_s
    assert port.candidates_tried == ref.candidates_tried
    assert port.candidates_pruned == ref.candidates_pruned


# ---------------------------------------------------------------------------
# the same decisions as the reference
# ---------------------------------------------------------------------------
SEARCHES = {
    "tiles_by_k": dict(shape=(64, 64), tiles=[(64, 64), (32, 64), (16, 64)],
                       nsteps_candidates=(1, 2), times={((32, 64), 2): 2e-4}),
    "march": dict(shape=(64, 64), tiles=[(64, 64), (8, 64)], nsteps_candidates=(1, 2),
                  march_candidates=(None, 0), times={((8, 64), 1, 0): 1e-4}),
    "pruned": dict(shape=(64, 64), tiles=[(64, 64), (2, 64), (2, 2)],
                   nsteps_candidates=(1,), costs=True, prune_ratio=1.2,
                   times={((2, 64), 1): 1e-5}),
    "pruned_march_k": dict(shape=(64, 64), tiles=[(64, 64), (16, 16), (4, 4)],
                           nsteps_candidates=(1, 2, 4), march_candidates=(None, 1),
                           costs=True, prune_ratio=1.5, check_every=4),
    "ties_keep_first": dict(shape=(64, 64), tiles=[(32, 32), (64, 64)],
                            nsteps_candidates=(1, 2), times={}),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_same_winner_tried_and_pruned_as_the_reference(fake, name):
    case = dict(SEARCHES[name])
    times = case.pop("times", {})
    fake.table = {(t, k, m[0] if m else None): s for (t, k, *m), s in times.items()}
    kw = dict(dtype="float32", radius=1, n_fields=3, iters=1, tag=f"same-{name}", **case)
    if kw.pop("costs", False):
        kw["costs"], kw["hw"] = _costs(), _HW
    port, ref, port_calls, ref_calls = _both(fake, **kw)
    _same(port, ref)
    assert port_calls == ref_calls          # the same survivors, timed in the same order
    if name.startswith("pruned"):
        assert port.candidates_pruned >= 1


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_temporal.py, test_mixed.py,
# test_streaming.py, test_coupled.py, test_ir.py, test_telemetry.py)
# ---------------------------------------------------------------------------
def test_autotune_picks_and_caches(fake, tmp_path):
    cache = str(tmp_path / "tune.json")
    kw = dict(shape=SHAPE3, dtype="float32", radius=1, n_fields=3, nsteps_candidates=(1, 2),
              tiles=[(16, 16, 16), (8, 16, 16)], iters=1, tag="unit", cache_path=cache)
    fake.table = {((8, 16, 16), 2, None): 5e-4}
    r1 = autotune.autotune(fake.make_step, device="cpu", **kw)
    assert (r1.tile, r1.nsteps, r1.candidates_tried) == ((8, 16, 16), 2, 4)
    n = len(fake.calls)
    r2 = autotune.autotune(fake.make_step, device="cpu", **kw)   # memoized: nothing timed
    assert r2 == r1 and len(fake.calls) == n
    autotune._CACHE.clear()                                      # the disk cache survives
    r3 = autotune.autotune(fake.make_step, device="cpu", **kw)
    assert r3 == r1 and len(fake.calls) == n
    _same(r1, r_autotune.autotune(fake.make_step, **{**kw, "cache_path": None}))


def _diffusion_both(fake, **kw):
    port = autotune.autotune_diffusion3d(SHAPE3, device="cpu", **kw)
    ref = r_autotune.autotune_diffusion3d(SHAPE3, **kw)
    return port, ref


def test_autotune_diffusion3d_smoke(fake):
    """The port's torch backend and the reference's jnp backend tune k
    alone, over one tile each (None, and the reference's derived block),
    and make the same decision on the same times."""
    fake.default = 2e-3
    fake.order = [(None, 1, None), (None, 2, None)]
    fake.table = {(None, 2, None): 1e-3}
    port = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1,
                                         device="cpu")
    assert port.tile is None and port.nsteps == 2 and port.per_step_s == 1e-3
    fake.calls.clear()
    ref = r_autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1)
    assert len(ref.tile) == 3
    _same(dataclasses.replace(port, tile=ref.tile), ref)


def test_autotune_diffusion3d_report_holds_each_candidate_bitwise(fake):
    fake.order = [(None, k, m) for k in (1, 2, 4) for m in (None, 0)]
    report = []
    r = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2, 4), iters=1,
                                      device="cpu", march_candidates=(None, 0), report=report)
    assert len(report) == r.candidates_tried == 6
    assert all(row["bitwise"] and not row["pruned"] and row["measured_s"] > 0 for row in report)
    assert {(row["nsteps"], row["march_axis"]) for row in report} == \
        {(k, m) for k in (1, 2, 4) for m in (None, 0)}


def test_autotune_cache_key_carries_dtypes():
    base = dict(shape=(32, 32), radius=1, n_fields=3, tag="t")
    k32 = autotune.cache_key(dtype="float32", dtypes=("float32", "float32"), **base)
    kbf = autotune.cache_key(dtype="bfloat16", dtypes=("bfloat16", "float32"), **base)
    assert k32 != kbf
    assert r_autotune.cache_key(dtype="float32", dtypes=("float32", "float32"), **base) != \
        r_autotune.cache_key(dtype="bfloat16", dtypes=("bfloat16", "float32"), **base)


def _step2d(dtype=torch.float32, tile=None):
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype, ndims=2)
    return ps.parallel(outputs=("U2",), rotations={"U2": "U"}, tile=tile)(
        lambda U2, U, dt: {"U2": fd2d.inn(U) + dt * (fd2d.d2_xi(U) + fd2d.d2_yi(U))})


def test_autotune_old_cache_format_ignored(fake, tmp_path):
    cache = str(tmp_path / "tune.json")
    stale = {"version": 3, "entries": {"whatever": {
        "tile": [1, 1], "nsteps": 1, "per_step_s": 0.0, "candidates_tried": 1}}}
    with open(cache, "w") as f:
        json.dump(stale, f)
    assert autotune._load_cache(cache) == {}
    r = autotune.autotune(fake.make_step, shape=(16, 16), dtype="float32", radius=1,
                          n_fields=2, nsteps_candidates=(1,), iters=1, tag="unit",
                          cache_path=cache, device="cpu")
    assert r.nsteps == 1 and fake.calls == [(None, 1, None)]
    with open(cache) as f:
        disk = json.load(f)
    assert disk["version"] == autotune.CACHE_VERSION
    assert "whatever" not in disk["entries"]            # replaced, not merged


def test_a_cache_written_by_the_reference_is_ignored(fake, tmp_path):
    cache = str(tmp_path / "tune.json")
    kw = dict(shape=(16, 16), dtype="float32", radius=1, n_fields=2, nsteps_candidates=(1, 2),
              tiles=[(16, 16)], iters=1, tag="unit-ref-file")
    ref = r_autotune.autotune(fake.make_step, cache_path=cache, **kw)
    with open(cache) as f:
        assert json.load(f)["version"] == r_autotune.CACHE_VERSION
    assert r_autotune._load_cache(cache) and autotune._load_cache(cache) == {}
    fake.calls.clear()
    port = autotune.autotune(fake.make_step, cache_path=cache, device="cpu", **kw)
    assert len(fake.calls) == 2                         # re-tuned, not trusted
    _same(port, ref)
    with open(cache) as f:
        disk = json.load(f)
    assert disk["version"] == autotune.CACHE_VERSION and len(disk["entries"]) == 1


def test_autotune_separate_entries_per_dtype(fake, tmp_path):
    cache = str(tmp_path / "tune.json")
    for dtype in (torch.float32, torch.bfloat16, "float16"):
        autotune.autotune(fake.make_step, shape=(16, 16), dtype=dtype, radius=1, n_fields=2,
                          nsteps_candidates=(1,), iters=1, tag="unit-dtype-pair",
                          cache_path=cache, device="cpu")
    with open(cache) as f:
        disk = json.load(f)
    assert len(disk["entries"]) == 3     # one per (storage, compute) pair
    pairs = {tuple(json.loads(k)[-2]) for k in disk["entries"]}
    assert pairs == {("float32", "float32"), ("bfloat16", "float32"), ("float16", "float32")}


def test_autotune_march_candidates_and_cache_version(fake, tmp_path):
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:      # a pre-versioned file: ignored, then rewritten
        json.dump({"[\"old\"]": {"tile": [8, 8, 8], "nsteps": 1, "per_step_s": 1e-9}}, f)
    assert autotune._load_cache(path) == {}
    fake.order = [(None, k, m) for k in (1, 2) for m in (None, 0)]
    fake.table = {(None, 2, 0): 1e-4}
    r = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1,
                                      cache_path=path, march_candidates=(None, 0),
                                      device="cpu")
    assert (r.nsteps, r.march_axis, r.candidates_tried) == (2, 0, 4)
    with open(path) as f:
        assert json.load(f)["version"] == autotune.CACHE_VERSION
    autotune._CACHE.clear()
    n = len(fake.calls)
    r2 = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1,
                                       cache_path=path, march_candidates=(None, 0),
                                       device="cpu")
    assert r2 == r and len(fake.calls) == n


def test_autotune_march_prunes_with_cost_model(fake):
    fake.order = [(None, k, m) for k in (1, 2) for m in (None, 0)]
    report = []
    r = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1, hw=_HW,
                                      prune_ratio=1.05, march_candidates=(None, 0),
                                      device="cpu", report=report)
    assert r.candidates_pruned >= 1
    assert r.candidates_pruned + r.candidates_tried == len(report) == 4
    pruned = [row for row in report if row["pruned"]]
    assert all(row["measured_s"] is None and not row["bitwise"] for row in pruned)
    assert all(row["predicted_s"] > 0 for row in report)


def test_autotune_prices_but_prunes_nothing_without_a_ratio(fake):
    """No ratio, the default: every candidate is priced and timed, the key
    carries no prune tag, and the decision is the reference's with a ratio
    that prunes nothing."""
    fake.order = [(None, k, m) for k in (1, 2) for m in (None, 0)]
    report = []
    r = autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1, hw=_HW,
                                      march_candidates=(None, 0), device="cpu", report=report)
    assert (r.candidates_pruned, r.candidates_tried, len(report)) == (0, 4, 4)
    assert all(row["predicted_s"] > 0 and row["measured_s"] is not None for row in report)
    (key,) = autotune._CACHE
    assert key[8] is None
    port_cost, ref_cost = _costs()
    kw = dict(shape=(64, 64), dtype="float32", radius=1, n_fields=3, nsteps_candidates=(1,),
              tiles=[(64, 64), (2, 64), (2, 2)], iters=1, tag="no-prune", hw=_HW)
    fake.table = {((2, 2), 1, None): 1e-5}      # priced worst, timed fastest
    port = autotune.autotune(fake.make_step, cost_model=port_cost, device="cpu", **kw)
    assert port.tile == (2, 2) and port.candidates_pruned == 0
    _same(port, r_autotune.autotune(fake.make_step, cost_model=ref_cost,
                                    prune_ratio=float("inf"), **kw))


def test_autotune_keys_differ_by_search_space_and_card():
    base = ((8, 8), "float32", 1, 3, "t", (1,))
    keys = [autotune.cache_key(*base),
            autotune.cache_key(*base, march_candidates=(None, 0)),
            autotune.cache_key(*base, halos=((1, 0), (0, 0))),
            autotune.cache_key(*base, prune=("H100", 2.0)),
            autotune.cache_key(*base, field_offsets=[(0, 0), (1, 0), (0, 1)]),
            autotune.cache_key(*base, dtypes=("bfloat16", "float32")),
            autotune.cache_key(*base, card="NVIDIA H100 80GB HBM3"),
            autotune.cache_key(*base, card="cpu"),
            autotune.cache_key(*base, tiles=[Shape((32, 8), 2, 6)]),
            autotune.cache_key(*base, tiles=[Shape((32, 8), 1, 6)]),
            autotune.cache_key(*base, reductions=["max_abs_diff(T2, T)"], check_every=4)]
    assert len(set(keys)) == len(keys)
    assert autotune.cache_key(*base) == autotune.cache_key(*base)
    # as the reference's own keys differ
    assert len({r_autotune.cache_key(*base), r_autotune.cache_key(*base, prune=("x", 2.0)),
                r_autotune.cache_key(*base, march_candidates=(None, 0))}) == 3


def test_autotune_keyed_on_field_offsets(fake):
    kw = dict(shape=(16, 16), dtype="float32", radius=1, n_fields=3, nsteps_candidates=(1,),
              iters=1, tag="offsets-unit")
    r1 = autotune.autotune(fake.make_step, field_offsets=[(0, 0)] * 3, device="cpu", **kw)
    n1 = len(fake.calls)
    r2 = autotune.autotune(fake.make_step, field_offsets=[(0, 0), (1, 0), (0, 1)],
                           device="cpu", **kw)
    assert len(fake.calls) > n1          # re-measured, not inherited
    assert r1.nsteps == r2.nsteps == 1


def test_autotune_prunes_candidates_before_building(fake):
    built = []

    def make_step(tile, k):
        built.append((tuple(tile), k))
        return fake.make_step(tile, k)

    prepared = []
    port_cost, ref_cost = _costs()
    kw = dict(shape=(64, 64), dtype="float32", radius=1, n_fields=3, nsteps_candidates=(1,),
              tiles=[(64, 64), (2, 64), (2, 2)], iters=1, tag="prune-unit", hw=_HW,
              prune_ratio=1.2)
    r = autotune.autotune(make_step, cost_model=port_cost, prepare=prepared.append,
                          device="cpu", **kw)
    assert r.candidates_pruned >= 1
    assert len(built) == 3 - r.candidates_pruned       # pruned: never built
    assert (2, 2) not in [t for t, _ in built]         # the worst tile never ran
    assert prepared == [[(t, k, None) for t, k in built]]   # built together, before any step
    assert r.tile == (64, 64)
    _same(r, r_autotune.autotune(fake.make_step, cost_model=ref_cost, **kw))


def test_autotune_decision_events(fake):
    def decisions(pkg_autotune, tel, **extra):
        tel.configure(None)
        col = tel.get()
        kw = dict(shape=(32, 32), dtype="float32", radius=1, n_fields=3,
                  nsteps_candidates=(1,), tiles=[(32, 32), (8, 32)], iters=1,
                  tag="telemetry-unit")
        pkg_autotune.autotune(fake.make_step, **kw, **extra)
        pkg_autotune.autotune(fake.make_step, **kw, **extra)
        evs = [r for r in col.records if r["kind"] == "event"
               and r["name"] == "autotune.decision"]
        counters = sorted((r["name"], r["value"]) for r in col.records
                          if r["kind"] == "counter")
        tel.configure(enabled=False)
        return evs, counters

    from repro import telemetry as r_telemetry
    try:
        port_evs, port_counts = decisions(autotune, telemetry, device="cpu")
        ref_evs, ref_counts = decisions(r_autotune, r_telemetry)
    finally:
        telemetry.reset()
        r_telemetry.reset()
    assert [e["attrs"]["cache"] for e in port_evs] == ["miss", "memory_hit"]
    assert [e["attrs"] for e in port_evs] == [e["attrs"] for e in ref_evs]
    assert port_counts == ref_counts
    assert port_evs[0]["attrs"]["candidates_tried"] == 2


# ---------------------------------------------------------------------------
# the port's own: results, candidates, the lock, parallel(tile=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tile", [Shape((32, 8), 2, 6), Shape((16, 8), 2, 10, vec=2),
                                  Shape((32, 32), 2, 3, block=256),
                                  Shape((16, 4), 16, 4, True, True), (8, 16, 16), None])
def test_tune_result_json_round_trips_the_layout(tile):
    r = autotune.TuneResult(tile, 2, 1.5e-4, 5, 3, 0)
    back = autotune.TuneResult.from_json(json.loads(json.dumps(r.to_json())))
    assert back == r and type(back.tile) is type(r.tile)


def test_tune_stencil_times_the_same_lists():
    for name in ("candidates", "steps_candidates", "march_candidates",
                 "steps_march_candidates"):
        assert getattr(tune_stencil, name) is getattr(autotune, name)


def test_tile_candidates_table_first_within_the_plan():
    kern = autotune.diffusion3d_kernel(init_parallel_stencil(backend="torch", device="cpu"))
    for k in (1, 2, 4):
        for march in (None, 0, 2):
            got = autotune.tile_candidates(kern, F3, SC3, k, march, max_candidates=3)
            table = kern.marched(march).compiled(nsteps=k, **F3, **SC3)
            if table.march_fallback:          # too short to march: nothing of its own
                assert got == [] and march == 2
                continue
            assert got[0] == table.shape and 1 <= len(got) <= 3 and len(set(got)) == len(got)
            for shape in got:        # every one a layout the plan accepts
                stencil.StencilCall(kern.compiled(**F3, **SC3).ir, kern.label, kern.bc, shape,
                                    k, kern.rotations if k > 1 else None,
                                    march_axis=march, strict=True)
    single = autotune.tile_candidates(kern, F3, SC3, 1, None, max_candidates=4)
    assert single[1:] == [Shape((32, 8), 1, 6), Shape((32, 8), 2, 8), Shape((32, 8), 4, 6)]


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_candidate_rehearsed_bitwise_to_single_steps(cxx, dtype):
    """What the tuner holds each candidate to on the card: k steps of
    every layout it would time (FIG1, k = 1 and 2, all-parallel and
    marched) equal k single steps of the ``torch`` backend bitwise."""
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype)
    plain = autotune.diffusion3d_kernel(ps)
    g = torch.Generator().manual_seed(3)
    shape = (13, 17, 40)
    T = torch.rand(shape, generator=g).to(dtype)
    f = {"T2": T.clone(), "T": T, "Ci": (torch.rand(shape, generator=g) + 0.5).to(dtype)}
    sc = dict(lam=1.0, dt=1e-4, _dx=12.0, _dy=16.0, _dz=39.0)
    sizes = {n: shape for n in f}
    for k in (1, 2):
        want = plain.run_steps(k, **f, **sc)
        for march in (None, 0):
            for tile in autotune.tile_candidates(plain, sizes, sc, k, march, max_candidates=2):
                call = autotune.diffusion3d_kernel(ps, tile).marched(march).compiled(
                    nsteps=k, **sizes, **sc)
                assert call.shape == tile
                outs, _ = rehearse.run(call, f, sc, xc=5)
                assert torch.equal(outs["T2"], want), (codegen.layout_name(tile), k, march)


def test_the_tuner_sets_no_module_constant(fake):
    def constants():
        return {(m.__name__, n): repr(v) for m in (stencil, codegen)
                for n, v in vars(m).items() if n.isupper()}
    before = constants()
    fake.order = [(None, k, m) for k in (1, 2) for m in (None, 0)]
    autotune.autotune_diffusion3d(SHAPE3, nsteps_candidates=(1, 2), iters=1, device="cpu",
                                  march_candidates=(None, 0))
    assert constants() == before


def test_cache_under_threads(fake):
    """More threads than cores tuning the same problem at once: every one
    gets the one winner, and the cache holds one entry."""
    import sys
    fake.table = {((8, 8), 2, None): 1e-4}
    kw = dict(shape=(16, 16), dtype="float32", radius=1, n_fields=2, nsteps_candidates=(1, 2),
              tiles=[(16, 16), (8, 8)], iters=1, tag="threads", device="cpu")
    results, errors = [], []

    def tune():
        try:
            results.append(autotune.autotune(fake.make_step, **kw))
        except Exception as e:        # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=tune) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 32 and {(r.tile, r.nsteps) for r in results} == {((8, 8), 2)}
    assert len(autotune._CACHE) == 1


def test_parallel_tile_reaches_the_call_and_launch_info():
    ps = init_parallel_stencil(backend="torch", device="cpu")
    g = torch.Generator().manual_seed(5)
    shape = (16, 16, 64)          # long enough along z for a slab's plane queue
    f = {n: torch.rand(shape, generator=g) for n in ("T2", "T", "Ci")}
    table = autotune.diffusion3d_kernel(ps)
    for tile, k, march in ((Shape((32, 8), 1, 8), 1, None), (Shape((32, 8), 4, 6), 1, 0),
                           (Shape((32, 32), 1, 3, block=256), 2, None),
                           (Shape((32, 16), 1, 4), 2, 1), (Shape((16, 4), 16, 4, True, True), 1, 2)):
        kern = autotune.diffusion3d_kernel(ps, tile).marched(march)
        assert kern.tile == tile and kern.with_reductions({"e": "max_abs_diff(T2, T)"}).tile == tile
        call = kern.compiled(nsteps=k, **f, **SC3)
        assert call.shape == tile and call.strict and call.march_axis == march
        call.prepare({n: f[n] for n in call.program.fields}, SC3, 132)   # no launch on the CPU
        assert kern.launch_info[shape]["layout"] == codegen.layout_name(tile)
        # the torch backend accepts the tile and computes what it computes without
        assert torch.equal(kern.run_steps(k, **f, **SC3), table.run_steps(k, **f, **SC3))
    # the batched call keeps its own layout
    kern = autotune.diffusion3d_kernel(ps, Shape((32, 8), 1, 8))
    assert kern.batched_call(**F3, **SC3).shape == codegen.batch_shape(
        kern.batched_call(**F3, **SC3).program)


@pytest.mark.parametrize("tile,k,march,dtype,why", [
    (Shape((64, 4), 2, 8, column=True), 1, None, torch.float32, "column march is a batched"),
    (Shape((32, 32), 1, 3, block=256), 1, None, torch.float32, "all-parallel k-step"),
    (Shape((32, 16), 2, 4, block=256), 2, 0, torch.float32, "all-parallel k-step"),
    (Shape((16, 8), 2, 10, vec=2), 2, None, torch.bfloat16, "pair layout serves single"),
    (Shape((16, 8), 2, 10, vec=2), 1, None, torch.float32, "pair layout"),
    (Shape((16, 4), 16, 4, True, True), 1, None, torch.float32, "contiguous axis"),
    (Shape((16, 4), 12, 4, True, True), 1, 2, torch.float32, "must divide"),
    (Shape((32, 40), 2, 1), 1, None, torch.float32, "at most 1024"),
    (Shape((32, 8), 2, 9), 1, None, torch.float32, "exceed an SM"),
    (Shape((32, 32), 32, 2, block=512), 4, None, torch.float32, "shared memory"),
])
def test_a_layout_that_cannot_serve_the_call_raises(tile, k, march, dtype, why):
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=dtype)
    kern = autotune.diffusion3d_kernel(ps, tile).marched(march)
    with pytest.raises(ValueError, match=why) as e:
        kern.compiled(nsteps=k, **F3, **SC3)
    assert codegen.layout_name(tile) in str(e.value)


def test_a_2d_launch_refuses_a_3d_tile_and_pairs_refuse_a_misaligned_view():
    with pytest.raises(ValueError, match="32x8/p2/b6 cannot serve this call: a tile of 8 rows"):
        _step2d(tile=Shape((32, 8), 2, 6)).compiled(U2=(16, 64), U=(16, 64), dt=1e-3)
    assert _step2d(tile=Shape((128, 1), 2, 6)).compiled(U2=(16, 64), U=(16, 64),
                                                        dt=1e-3).shape == Shape((128, 1), 2, 6)
    ps = init_parallel_stencil(backend="torch", device="cpu", dtype=torch.bfloat16)
    pair = Shape((16, 8), 2, 10, vec=2)
    kern = autotune.diffusion3d_kernel(ps, pair)
    call = kern.compiled(**F3, **SC3)
    buf = torch.zeros(16 ** 3 + 1, dtype=torch.bfloat16)
    odd = {n: buf[1:].view(SHAPE3) for n in call.program.fields}
    with pytest.raises(ValueError, match="aligned"):
        call.prepare(odd, SC3, 132)
    # without a tile the port takes the one-cell layout for the same view
    table = autotune.diffusion3d_kernel(ps).compiled(**F3, **SC3)
    assert table.shape == pair and table.layout_call(odd).shape.vec == 1
    with pytest.raises(TypeError, match="KernelShape"):
        autotune.diffusion3d_kernel(ps, (8, 8, 8))


def test_card_name_names_the_device_torch_runs_on(monkeypatch):
    """The card's name comes from the CUDA device itself, with no
    ``nvidia-smi`` call (whose index is not the CUDA ordinal)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: f"card of {d}")
    monkeypatch.setattr(teff, "card_info", lambda *a: pytest.fail("nvidia-smi was asked"))
    assert autotune.card_name("cuda:1") == "card of cuda:1"
    assert autotune.card_name(torch.device("cuda")) == "card of cuda"


def test_strict_call_relabels_only_layout_refusals(monkeypatch):
    """A chosen layout that a printer refuses raises ``ValueError`` naming
    it; what the kernel does not port propagates as it is."""
    ps = init_parallel_stencil(backend="torch", device="cpu")
    tile = Shape((32, 8), 1, 8)

    def refuse(exc):
        def source(*a, **k):
            raise exc
        monkeypatch.setattr(codegen, "cuda_source", source)
        return autotune.diffusion3d_kernel(ps, tile)

    with pytest.raises(ValueError, match="32x8/p1/b8 cannot serve this call: too wide"):
        refuse(codegen.LayoutRefused("too wide")).compiled(**F3, **SC3)
    with pytest.raises(NotImplementedError, match="not ported") as e:
        refuse(NotImplementedError("reduction kind 'x' is not ported")).compiled(**F3, **SC3)
    assert not isinstance(e.value, codegen.LayoutRefused)
    # without a chosen layout a printer's refusal stays a NotImplementedError
    with pytest.raises(codegen.LayoutRefused):
        refuse(codegen.LayoutRefused("too wide"))
        autotune.diffusion3d_kernel(ps).compiled(**F3, **SC3)


def test_card_name_on_the_cpu_and_the_key_it_takes(fake):
    assert autotune.card_name("cpu") == "cpu"
    autotune.autotune(fake.make_step, shape=(8, 8), dtype="float32", nsteps_candidates=(1,),
                      iters=1, tag="card", device="cpu")
    (key,) = autotune._CACHE
    assert key[-1] == "cpu" and key[-2] == ("float32", "float32")
