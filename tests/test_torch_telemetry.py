"""The port's runtime telemetry (``repro_torch.telemetry``), mirroring
``tests/test_telemetry.py``: no-op when disabled, JSONL and Perfetto
schema, device metrics read at the solve's existing syncs, roofline
attribution; and the port's JSONL held to the JAX package's validator.

The two contracts under test:
  * disabled mode is FREE: the global collector is the shared no-op
    singleton, and a solve makes the same kernel calls and host syncs with
    telemetry on or off, with a bitwise-equal result;
  * enabled mode writes schema-valid JSONL (under the port's schema and the
    reference's) whose records carry the chunk spans, the error trajectory,
    checkpoint latencies and roofline fractions.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from repro.telemetry import schema as ref_schema
from repro.telemetry.collector import SCHEMA_VERSION as REF_SCHEMA_VERSION
from repro_torch import telemetry
from repro_torch.core import fd3d, init_parallel_stencil, iterate, parallel, teff
from repro_torch.distributed import fault
from repro_torch.telemetry import attrib, export, report, schema
from repro_torch.telemetry.collector import _jsonable

ERR = {"err": "max_abs_diff(T2, T)"}


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    """Every test starts and ends with the env-default (disabled) state and
    a pinned roofline peak (no host measurement)."""
    monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
    monkeypatch.setenv("REPRO_TELEMETRY_BW_GBS", "50")
    monkeypatch.delenv("REPRO_TELEMETRY_FLOPS_G", raising=False)
    telemetry.reset()
    attrib.reset_hardware_cache()
    yield
    telemetry.reset()
    attrib.reset_hardware_cache()


def diffusion_kernel(reductions=ERR):
    ps = init_parallel_stencil(backend="torch", device="cpu")

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"}, reductions=reductions)
    def kern(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
            fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}

    return kern


def setup3d(rng, shape=(12, 12, 12)):
    T = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    Ci = torch.from_numpy((rng.rand(*shape) + 0.5).astype(np.float32))
    return dict(T2=T, T=T, Ci=Ci), dict(lam=1.0, dt=0.05, _dx=1.0, _dy=1.0, _dz=1.0)


# ---------------------------------------------------------------- disabled
def test_disabled_is_shared_noop_singleton():
    col = telemetry.get()
    assert col is telemetry.NULL and not col.enabled
    assert telemetry.get() is col                 # cached, not re-resolved
    s1, s2 = col.span("a"), col.span("b", attr=1)
    assert s1 is s2                               # one shared null span
    with s1 as s:
        assert s is s1
    assert col.count("c") is None and col.gauge("g", 1.0) is None
    assert col.observe("h", 0.5) is None and col.event("e") is None
    col.span_end("x", 0.0, 1.0)
    col.flush(), col.close()
    telemetry.count("c"), telemetry.gauge("g", 1), telemetry.event("e")
    telemetry.observe("h", 1.0)
    with telemetry.span("s"):
        pass
    assert not telemetry.enabled()


def test_env_enables_and_configure_overrides(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TELEMETRY", str(tmp_path / "run.jsonl"))
    telemetry.reset()
    col = telemetry.get()
    assert col.enabled and col.path == str(tmp_path / "run.jsonl")
    col2 = telemetry.configure(None)       # programmatic override
    assert telemetry.get() is col2 and col2.path is None
    assert telemetry.configure(enabled=False) is telemetry.NULL
    monkeypatch.setenv("REPRO_TELEMETRY", "1")
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path / "d"))
    telemetry.reset()
    assert telemetry.get().path == str(tmp_path / "d" / f"run_{os.getpid()}.jsonl")
    monkeypatch.setenv("REPRO_TELEMETRY", "0")
    telemetry.reset()
    assert telemetry.get() is telemetry.NULL


def test_resolve_kwarg_contract():
    assert telemetry.resolve(False) is telemetry.NULL
    col = telemetry.Collector(None)
    assert telemetry.resolve(col) is col
    assert telemetry.resolve(None) is telemetry.get()
    assert telemetry.resolve(True).enabled
    assert telemetry.resolve(True) is telemetry.get()   # the enabled global is reused


def test_jsonable_reads_one_element_tensors():
    assert _jsonable(torch.tensor(0.5)) == 0.5
    assert _jsonable(np.int64(3)) == 3 and _jsonable((1, torch.tensor(2.0))) == [1, 2.0]
    assert _jsonable(torch.zeros(3)).startswith("tensor(")


def _counting(monkeypatch):
    """Count kernel calls on the torch backend (every step, plain or checked)."""
    calls = {"n": 0}
    run = parallel.StencilKernel._run_torch

    def counted(self, *a, **k):
        calls["n"] += 1
        return run(self, *a, **k)

    monkeypatch.setattr(parallel.StencilKernel, "_run_torch", counted)
    return calls


def test_disabled_solve_unperturbed(rng, monkeypatch):
    f, sc = setup3d(rng)
    kern = diffusion_kernel()
    calls = _counting(monkeypatch)
    runs = {}
    for label, sel in (("default", None), ("off", False), ("on", telemetry.Collector(None))):
        calls["n"] = 0
        res = iterate.solve_until(kern, f, sc, tol=2e-5, max_iters=200, check_every=5,
                                  telemetry=sel)
        runs[label] = (res, calls["n"])
    r0, n0 = runs["off"]
    assert 0 < r0.iters < 200 and n0 == r0.iters
    assert r0.host_syncs == r0.iters // 5
    for res, n in runs.values():
        assert (res.iters, res.err, res.host_syncs, n) == (r0.iters, r0.err, r0.host_syncs, n0)
        assert torch.equal(res.fields["T"], r0.fields["T"])
    col = telemetry.resolve(None)
    assert col is telemetry.NULL


def test_plain_solve_records_and_cold_detection(rng):
    f, sc = setup3d(rng, (10, 10, 10))
    kern = diffusion_kernel()
    col = telemetry.Collector(None)
    iterate.solve_until(kern, f, sc, tol=0.0, max_iters=10, check_every=5, telemetry=col)
    iterate.solve_until(kern, f, sc, tol=0.0, max_iters=10, check_every=5, telemetry=col)
    spans = [r for r in col.records if r["kind"] == "span" and r["name"] == "solve_until"]
    assert [s["attrs"]["cold"] for s in spans] == [True, False]
    assert all(s["attrs"]["iters"] == 10 and s["attrs"]["kernel"] == "kern[err]" for s in spans)
    roof = [r for r in col.records if r["kind"] == "event" and r["name"] == "roofline"]
    assert len(roof) == 1                        # the warm solve only
    assert roof[0]["attrs"]["tile"] == [10, 10, 10] and roof[0]["attrs"]["hw"] == "pinned"
    assert col.counters[("solve.steps", ())] == 20
    assert col.gauges[("solve.iters", ())] == 10


# ----------------------------------------------------------------- enabled
def _run_checkpointed(rng, tmp_path, log="run.jsonl"):
    f, sc = setup3d(rng)
    kern = diffusion_kernel()
    path = str(tmp_path / log)
    # the GLOBAL collector, as REPRO_TELEMETRY= would install it: the
    # checkpoint and fault subsystems emit through the process singleton
    col = telemetry.configure(path)
    mon = fault.StepMonitor(host_id=0, heartbeat_dir=str(tmp_path / "hb"))
    ck = iterate.Checkpointing(str(tmp_path / "ck"), save_every=2, blocking=False, monitor=mon)
    res = iterate.solve_until(kern, f, sc, tol=2e-5, max_iters=200, check_every=5,
                              checkpoint=ck)
    telemetry.reset()                       # close and flush the log
    return res, col, path


def test_enabled_chunked_jsonl_schema_and_content(rng, tmp_path):
    res, col, path = _run_checkpointed(rng, tmp_path)
    counts = schema.validate_file(path)          # raises on any drift
    assert ref_schema.validate_file(path) == counts   # and the reference's validator agrees
    assert counts["meta"] == 1 and counts["span"] > 0
    records = schema.load_records(path)
    assert records[0]["schema"] == schema.SCHEMA_VERSION == REF_SCHEMA_VERSION
    assert schema.KINDS == ref_schema.KINDS
    names = {(r["kind"], r.get("name")) for r in records}
    for want in (("span", "solve.chunk"), ("span", "checkpoint.snapshot"),
                 ("span", "checkpoint.write"), ("event", "solve.trajectory"),
                 ("event", "roofline"), ("counter", "solve.steps"),
                 ("counter", "checkpoint.saves"), ("counter", "checkpoint.bytes_written"),
                 ("gauge", "fault.ewma_step_s"), ("gauge", "solve.iters"),
                 ("gauge", "solve.err"), ("gauge", "roofline.fraction")):
        assert want in names, want
    chunks = [r for r in records if r["kind"] == "span" and r["name"] == "solve.chunk"]
    assert sum(c["attrs"]["steps"] for c in chunks) == res.iters
    assert [c["attrs"]["cold"] for c in chunks] == [True] + [False] * (len(chunks) - 1)
    traj = [r for r in records if r["kind"] == "event" and r["name"] == "solve.trajectory"]
    errs = [t["attrs"]["err"] for t in traj]
    assert errs[-1] == res.err and errs[0] >= errs[-1]        # diffusion decays
    assert traj[-1]["attrs"]["reds"] == {"err": res.err}
    saves = [r for r in records if r["kind"] == "counter" and r["name"] == "checkpoint.saves"]
    assert len(saves) == len(res.saved_steps)
    written = [r["value"] for r in records
               if r["kind"] == "counter" and r["name"] == "checkpoint.bytes_written"]
    assert written[0] == 3 * 12 ** 3 * 4 + 2 * 4        # T, T2, Ci, err, reds/err
    roof = [r for r in records if r["kind"] == "event" and r["name"] == "roofline"]
    assert 0 < roof[-1]["attrs"]["roofline_fraction"] <= 1 and roof[-1]["attrs"]["bounded"]
    assert res.step_stats is not None and res.step_stats[0]["ewma_s"] > 0


def test_resume_event_and_restore_span(rng, tmp_path):
    f, sc = setup3d(rng)
    kern = diffusion_kernel()
    ck = iterate.Checkpointing(str(tmp_path / "ck"), save_every=1, blocking=True)
    iterate.solve_until(kern, f, sc, tol=0.0, max_iters=10, check_every=5, checkpoint=ck,
                        telemetry=False)
    col = telemetry.configure(None)        # restore emits through the global
    res = iterate.solve_until(kern, f, sc, tol=0.0, max_iters=20, check_every=5, checkpoint=ck)
    assert res.resumed_from == 10
    ev = [r for r in col.records if r["kind"] == "event" and r["name"] == "solve.resume"]
    assert ev and ev[0]["attrs"]["step"] == 10
    assert any(r["kind"] == "span" and r["name"] == "checkpoint.restore" for r in col.records)
    assert any(r["kind"] == "counter" and r["name"] == "checkpoint.restores"
               for r in col.records)


def test_chrome_trace_export(rng, tmp_path):
    _, _, path = _run_checkpointed(rng, tmp_path)
    out = str(tmp_path / "trace.json")
    n = export.write_chrome_trace(schema.load_records(path), out)
    evs = json.load(open(out))["traceEvents"]
    assert n == len(evs) > 0
    assert {"X", "C", "i", "M"} <= {e["ph"] for e in evs}
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in evs if e["ph"] == "X")
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)


def test_prometheus_export():
    col = telemetry.Collector(None)
    col.count("solve.steps", 30)
    col.count("solve.steps", 12)
    col.gauge("roofline.fraction", 0.83, kernel="kern")
    col.observe("chunk_s", 0.1)
    col.observe("chunk_s", 0.3)
    text = export.prometheus_text(col)
    assert "repro_solve_steps_total 42" in text
    assert 'repro_roofline_fraction{kernel="kern"} 0.83' in text
    assert 'quantile="0.5"' in text and "repro_chunk_s_count 2" in text


def test_schema_rejects_drift(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "meta", "ts": 0.0, "schema": 1, "pid": 1}) + "\n"
                   + json.dumps({"kind": "span", "ts": 1.0, "name": "x", "dur_s": -2.0}) + "\n")
    with pytest.raises(schema.SchemaError, match="dur_s"):
        schema.validate_file(str(bad))
    assert schema.main([str(bad)]) == 1
    for rec, match in (({"kind": "nope", "ts": 0}, "unknown kind"),
                       ({"kind": "gauge", "ts": 0, "name": "g"}, "numeric"),
                       ({"kind": "event", "ts": 0, "name": "e", "attrs": 3}, "attrs")):
        with pytest.raises(schema.SchemaError, match=match):
            schema.validate_record(rec)
    none = tmp_path / "none.jsonl"
    none.write_text(json.dumps({"kind": "counter", "ts": 0, "name": "c", "value": 1}) + "\n")
    with pytest.raises(schema.SchemaError, match="meta"):
        schema.validate_file(str(none))


def test_report_cli(rng, tmp_path, capsys):
    _, _, path = _run_checkpointed(rng, tmp_path)
    trace = str(tmp_path / "trace.json")
    assert report.main([path, "--validate", "--trace", trace]) == 0
    out = capsys.readouterr().out
    for want in ("Per-phase spans", "solve.chunk", "Error trajectory", "Counters",
                 "Gauges (last value)", "backend cpu"):
        assert want in out, want
    assert os.path.exists(trace)
    assert schema.main([path]) == 0


# ---------------------------------------------------------------- roofline
def test_roofline_fraction_hand_computed():
    """roofline_fraction of the 3-D diffusion kernel against hand math, with
    an explicit HardwareSpec so nothing depends on the host."""
    shape = (16, 16, 16)
    kern = diffusion_kernel()
    sc = dict(lam=1.0, dt=0.05, _dx=1.0, _dy=1.0, _dz=1.0)
    cost = kern.cost_model(T2=shape, T=shape, Ci=shape, **sc)
    hw = teff.HardwareSpec("unit", "n/a", peak_bw=100e9, peak_flops=1e12)
    per_step_s = 1e-3
    col = telemetry.Collector(None)
    out = attrib.attribute(col, "kern", per_step_s, cost, hw=hw)
    # A_eff: T and Ci read once, T2 written once, 16^3 f32 each; the least
    # time is those bytes at 100 GB/s, above the step's flops at 1 TFLOP/s
    a = 3 * 16 ** 3 * 4
    assert cost.a_eff_bytes(1) == a
    t_model = a / 100e9
    assert t_model > cost.flops.total() / 1e12
    assert out["model_per_step_s"] == pytest.approx(t_model)
    assert out["roofline_fraction"] == pytest.approx(t_model / per_step_s)
    assert out["bounded"] is True
    assert out["t_eff_measured"] == pytest.approx(a / per_step_s)
    assert out["t_eff_model"] == pytest.approx(100e9)
    byname = {g["name"]: g for g in col.records if g["kind"] == "gauge"}
    assert byname["roofline.fraction"]["value"] == pytest.approx(t_model / per_step_s)
    assert byname["roofline.fraction"]["labels"] == {"kernel": "kern"}
    assert byname["roofline.t_eff_measured_GBs"]["value"] == pytest.approx(a / per_step_s / 1e9)
    assert attrib.attribute(col, "kern", 0.0, cost, hw=hw) == {}
    # a fused check every 4 steps over 8^3 tiles adds one f32 partial per
    # tile and reduction (8 tiles) a check, and its map and fold's flops
    checked = attrib.least_per_step_s(cost, (8, 8, 8), 1, hw, check_every=4)
    assert checked == pytest.approx((a + 8 * 4 / 4) / 100e9)
    assert cost.check_flops.total() > 0


def test_roofline_unbounded_launch_has_no_fraction():
    """A step measured faster than the model's least time is a launch the
    yardstick does not bound: the record says so and carries no fraction,
    and no roofline.fraction gauge is emitted."""
    shape = (16, 16, 16)
    cost = diffusion_kernel().cost_model(T2=shape, T=shape, Ci=shape, lam=1.0, dt=0.05,
                                         _dx=1.0, _dy=1.0, _dz=1.0)
    hw = teff.HardwareSpec("unit", "n/a", peak_bw=100e9, peak_flops=1e12)
    col = telemetry.Collector(None)
    t_least = attrib.least_per_step_s(cost, shape, 1, hw)
    out = attrib.attribute(col, "kern", t_least / 2, cost, hw=hw)
    assert out["bounded"] is False and out["roofline_fraction"] is None
    assert out["model_per_step_s"] == pytest.approx(t_least)
    names = {g["name"] for g in col.records if g["kind"] == "gauge"}
    assert "roofline.fraction" not in names and "roofline.t_eff_measured_GBs" in names
    ev = [r for r in col.records if r["kind"] == "event" and r["name"] == "roofline"]
    assert ev[0]["attrs"]["bounded"] is False
    # at exactly the least time the launch is on the roofline: fraction 1
    assert attrib.attribute(col, "kern", t_least, cost, hw=hw)["roofline_fraction"] == 1.0


def test_default_hardware_env_pin_and_host_measurement(monkeypatch):
    monkeypatch.setenv("REPRO_TELEMETRY_BW_GBS", "123")
    monkeypatch.setenv("REPRO_TELEMETRY_FLOPS_G", "456")
    attrib.reset_hardware_cache()
    hw = attrib.default_hardware()
    assert hw.peak_bw == pytest.approx(123e9) and hw.peak_flops == pytest.approx(456e9)
    assert attrib.default_hardware() is hw       # cached
    monkeypatch.delenv("REPRO_TELEMETRY_BW_GBS")
    monkeypatch.delenv("REPRO_TELEMETRY_FLOPS_G")
    attrib.reset_hardware_cache()
    host = attrib.default_hardware("cpu")
    assert host.name == "host-cpu (STREAM-measured)" and host.peak_bw > 0
    assert host.peak_flops == pytest.approx(8.0 * host.peak_bw)
    assert teff.HardwareSpec("card", "700.00 W", peak_bw=1.0).peak_flops == float("inf")
    assert teff.H100_F32_FLOPS == 67e12


@pytest.mark.parametrize("name,flops", [("NVIDIA H100 80GB HBM3", 67e12),
                                        ("NVIDIA A100-SXM4-80GB", float("inf"))])
def test_device_spec_takes_the_h100_rate_only_on_an_h100(monkeypatch, name, flops):
    """The spec's compute peak is the H100 data sheet's rate on an H100
    only; another card keeps the memory term alone (the card's probes are
    stubbed: no card here)."""
    monkeypatch.setattr(teff, "_require_card", lambda: None)
    monkeypatch.setattr(teff, "card_info", lambda index=0: (name, "700.00 W"))
    monkeypatch.setattr(teff, "measure_device_bandwidth", lambda nbytes=0: 3e12)
    monkeypatch.setattr(teff.torch.cuda, "device", lambda index: contextlib.nullcontext())
    spec = teff.device_spec()
    assert (spec.name, spec.power_limit, spec.peak_bw) == (name, "700.00 W", 3e12)
    assert spec.peak_flops == flops


# ---------------------------------------------------------------------------
# the hardened JSONL writer: transient I/O degrades to dropped records with a
# counter instead of killing the solve
# ---------------------------------------------------------------------------
class _FlakyIO:
    """Install/remove a FaultPlan object directly (bypassing the env) so the
    injection budget starts ticking exactly where the test says."""

    def __enter__(self):
        fault.FaultPlan.reset_active()
        return self

    def arm(self, **kw):
        plan = fault.FaultPlan(**kw)
        fault._active_plan, fault._active_loaded = plan, True
        return plan

    def __exit__(self, *exc):
        fault.FaultPlan.reset_active()
        return False


@pytest.mark.parametrize("case", ["absorbed", "dropped", "memory_only"])
def test_writer_retry_drop_and_degrade(tmp_path, case):
    path = str(tmp_path / "t.jsonl")
    with _FlakyIO() as flaky:
        if case == "absorbed":
            flaky.arm(io_errors=2)                # within the retry budget
            col = telemetry.configure(path=path)
            for i in range(5):
                col.count("solve.steps", i)
            col.close()
            assert col.dropped_records == 0
            assert len([json.loads(ln) for ln in open(path)]) == 6   # meta + 5
        elif case == "dropped":
            col = telemetry.configure(path=path)
            flaky.arm(io_errors=col.IO_ATTEMPTS)  # the next write fails every try
            col.count("lost_line", 1)             # dropped, MUST NOT raise
            col.count("landed_line", 1)           # budget spent: lands
            col.close()
            mine = {"lost_line", "landed_line"}   # retries count too
            names = [ln.get("name") for ln in map(json.loads, open(path))
                     if ln["kind"] == "counter" and ln.get("name") in mine]
            assert col.dropped_records == 1 and names == ["landed_line"]
            assert [r.get("name") for r in col.records if r.get("name") in mine] == [
                "lost_line", "landed_line"]       # memory holds everything
        else:
            flaky.arm(io_errors=50)
            col = telemetry.configure(path=path)  # open exhausts its retries
            col.count("a", 1)
            col.close()
            assert not os.path.exists(path)
            assert col.records[0].get("sink_degraded") is True
            assert col.dropped_records == 2       # meta + counter
            assert [r["kind"] for r in col.records] == ["meta", "counter"]
    telemetry.reset()


def test_solve_survives_flaky_telemetry_sink(tmp_path, rng):
    kern = diffusion_kernel()
    f, sc = setup3d(rng)
    clean = iterate.solve_until(kern, f, sc, tol=1e-4, max_iters=200, check_every=4)
    path = str(tmp_path / "flaky.jsonl")
    with _FlakyIO() as flaky:
        col = telemetry.configure(path=path)
        flaky.arm(io_errors=3 * col.IO_ATTEMPTS)
        res = iterate.solve_until(kern, f, sc, tol=1e-4, max_iters=200, check_every=4,
                                  telemetry=col)
        col.close()
    assert torch.equal(res.fields["T"], clean.fields["T"]) and res.iters == clean.iters
    assert col.dropped_records >= 1
    telemetry.reset()


# ------------------------------------------------------------- rank merge
def _write_rank_stream(path, spans, rank=None):
    with open(path, "w") as f:
        for ts, name, dur in spans:
            rec = {"kind": "span", "ts": ts, "name": name, "dur_s": dur}
            if rank is not None:
                rec["rank"] = rank
            f.write(json.dumps(rec) + "\n")


def test_merge_records_interleaves_by_timestamp(tmp_path):
    # rank 0's records are stamped; rank 1's rely on the rank_<i> file name
    p0, p1 = str(tmp_path / "rank_0.jsonl"), str(tmp_path / "rank_1.jsonl")
    _write_rank_stream(p0, [(1.0, "solve.chunk", 0.5), (3.0, "solve.chunk", 0.7)], rank=0)
    _write_rank_stream(p1, [(2.0, "solve.chunk", 0.6), (4.0, "exchange", 0.1)])
    merged = report.merge_records([p0, p1])
    assert [r["ts"] for r in merged] == [1.0, 2.0, 3.0, 4.0]
    assert [r["rank"] for r in merged] == [0, 1, 0, 1]
    rows = report.per_rank_phase_summary(merged)
    assert {(r["phase"], r["rank"], r["count"]) for r in rows} == {
        ("solve.chunk", 0, 2), ("solve.chunk", 1, 1), ("exchange", 1, 1)}


def test_report_cli_merge_glob_and_no_match_notice(tmp_path, capsys):
    p0, p1 = str(tmp_path / "rank_0.jsonl"), str(tmp_path / "rank_1.jsonl")
    _write_rank_stream(p0, [(1.0, "solve.chunk", 0.5)], rank=0)
    _write_rank_stream(p1, [(2.0, "solve.chunk", 0.9)], rank=1)
    assert report.main(["--merge", str(tmp_path / "rank_*.jsonl")]) == 0
    out = capsys.readouterr().out
    # one row per (phase, rank): the straggler's 0.9 s is not averaged away
    assert "Per-rank phases" in out and "0.9" in out and "0.5" in out
    assert report.main([p0, "--merge", str(tmp_path / "nope_*.jsonl")]) == 0
    assert "no files match" in capsys.readouterr().err


def test_collector_rank_stamp(tmp_path, monkeypatch):
    path = str(tmp_path / "rank_3.jsonl")
    col = telemetry.configure_rank(3, path=path)
    col.count("steps", 2)
    with col.span("solve.chunk"):
        pass
    col.close()
    recs = schema.load_records(path)
    assert recs and all(r.get("rank") == 3 for r in recs)
    assert telemetry.configure_rank(1) is telemetry.NULL   # telemetry off: a no-op
    monkeypatch.setenv("REPRO_TELEMETRY", str(tmp_path / "logs" / "run.jsonl"))
    assert telemetry.configure_rank(1).path == str(tmp_path / "logs" / "rank_1.jsonl")
    telemetry.reset()
