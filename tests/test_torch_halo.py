"""The port's halo exchange (``repro_torch.distributed.halo``), its wire
formats and ``compression``, held against the JAX package.

Gangs of 2 and 4 CPU processes joined by gloo (``torch_gang.run_gang``,
each with its own timeout) run the exchanges. The grouped exchange with
per-field depths and the bf16 and int8 wire formats is held to the
reference's own ``exchange_many`` under ``shard_map`` on fake CPU devices
(``conftest.run_subprocess``), bitwise: both cast to bf16 with round to
nearest even and quantize with the same f32 arithmetic. The byte counts
are compared with the reference's function directly, and the int8 round
trip with the bound the port's arithmetic gives (Hypothesis).
"""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from conftest import run_subprocess
from repro.distributed import halo as r_halo
from repro_torch import telemetry
from repro_torch.distributed import compression, halo
from repro_torch.launch.mesh import RankMesh, make_mesh
from torch_gang import results, run_gang


# ---------------------------------------------------------------------------
# host-side layout helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("radius,factors", [(1, (2, 2)), (2, (2, 4)), (1, (4, 1))])
def test_global_local_roundtrip_matches_reference(radius, factors, rng):
    inner = (8 * factors[0], 8 * factors[1])
    g = rng.rand(inner[0] + 2 * radius, inner[1] + 2 * radius, 5).astype(np.float32)
    locs = halo.global_to_local(torch.from_numpy(g), factors, radius=radius)
    want = r_halo.global_to_local(g, factors, radius=radius)
    assert len(locs) == len(want)
    for a, b in zip(locs, want):
        np.testing.assert_array_equal(a.numpy(), b)
    back = halo.local_to_global(locs, factors, radius=radius)
    np.testing.assert_array_equal(back.numpy(), g)
    np.testing.assert_array_equal(back.numpy(), r_halo.local_to_global(want, factors, radius))


def test_owned_slices_tile_the_global_array_once():
    factors, r = (3, 2), 2
    g = torch.zeros(3 * 4 + 2 * r, 2 * 5 + 2 * r, 3)
    for idx in np.ndindex(*factors):
        loc = halo.local_block(g, factors, idx, r)
        own = halo.owned_slices(loc.shape, factors, idx, r)
        # the owned part of each block, placed globally, counts each cell once
        inner = [(s - 2 * r) for s in loc.shape[:2]]
        dst = tuple(slice(i * n + s.start, i * n + s.stop)
                    for i, n, s in zip(idx, inner, own[:2]))
        g[dst] += 1
    assert torch.equal(g, torch.ones_like(g))


# ---------------------------------------------------------------------------
# byte accounting and telemetry
# ---------------------------------------------------------------------------
BYTE_CASES = [
    dict(shapes={"A": (8, 6), "B": (8, 6)}, isz={"A": 4, "B": 4}, isf={"A": True, "B": True},
         n_axes=1, kw={}),
    dict(shapes={"A": (8, 6), "B": (8, 6)}, isz={"A": 4, "B": 4}, isf={"A": True, "B": True},
         n_axes=1, kw={"compress": "bf16"}),
    dict(shapes={"A": (8, 6), "B": (8, 6)}, isz={"A": 4, "B": 4}, isf={"A": True, "B": True},
         n_axes=1, kw={"compress": "int8"}),
    dict(shapes={"A": (8, 6), "B": (8, 6)}, isz={"A": 4, "B": 4}, isf={"A": True, "B": True},
         n_axes=1, kw={"active": [False]}),
    dict(shapes={"A": (8, 6), "B": (8, 6)}, isz={"A": 4, "B": 4}, isf={"A": True, "B": True},
         n_axes=1, kw={"grouped": False}),
    dict(shapes={"M": (8, 6)}, isz={"M": 1}, isf={"M": False}, n_axes=1,
         kw={"compress": "bf16"}),
    dict(shapes={"re": (20, 12, 9), "im": (20, 12, 9), "q": (19, 12, 9)},
         isz={"re": 4, "im": 4, "q": 2}, isf={"re": True, "im": True, "q": True}, n_axes=2,
         kw={"radius": 2, "depths": {"re": ((2, 2), (1, 0)), "q": ((0, 1), (2, 2))},
             "compress": "int8"}),
    dict(shapes={"re": (20, 12, 9), "im": (20, 12, 9)}, isz={"re": 4, "im": 4},
         isf={"re": True, "im": True}, n_axes=2,
         kw={"radius": 2, "depths": {"re": ((2, 2), (1, 0))}, "compress": "bf16",
             "active": [True, False]}),
]


@pytest.mark.parametrize("case", range(len(BYTE_CASES)))
def test_exchange_byte_counts_match_reference(case):
    c = BYTE_CASES[case]
    got = halo.exchange_byte_counts(c["shapes"], c["isz"], c["isf"], c["n_axes"], **c["kw"])
    want = r_halo.exchange_byte_counts(c["shapes"], c["isz"], c["isf"], c["n_axes"], **c["kw"])
    assert got == want


def test_exchange_byte_counts_hand_checked():
    shapes, isz, isf = {"A": (8, 6), "B": (8, 6)}, {"A": 4, "B": 4}, {"A": True, "B": True}
    # one mesh axis, radius 1, grouped: per side one message of 2 fields x
    # 1 plane x 6 elements = 12 f32 = 48 B; two sides
    assert halo.exchange_byte_counts(shapes, isz, isf, 1) == {
        "bytes_raw": 96, "bytes_wire": 96, "messages": 2}
    c = halo.exchange_byte_counts(shapes, isz, isf, 1, compress="int8")
    assert c["bytes_wire"] == 2 * (compression.BLOCK + 4) and c["messages"] == 4


def test_exchange_telemetry_emission():
    """Counts from the shapes, once per collector and geometry: the mesh's
    size-1 axes ship nothing."""
    col = telemetry.Collector(None)
    A = torch.ones(8, 6)
    mesh = RankMesh((2,), ("x",), 0, (0, 1))
    for _ in range(3):
        halo._emit_exchange_telemetry(col, dict(A=A), ("A",), mesh, radius=1, depths=None,
                                      compress=None, grouped=True)
    ev = [r for r in col.records if r["kind"] == "event" and r["name"] == "halo.exchange_traced"]
    assert len(ev) == 1
    a = ev[0]["attrs"]
    assert a["bytes_raw"] == a["bytes_wire"] == 48
    assert a["messages"] == 2 and a["fields"] == ["A"]
    assert any(r["kind"] == "counter" and r["name"] == "halo.traced_exchanges"
               for r in col.records)
    assert any(r["kind"] == "gauge" and r["name"] == "halo.bytes_wire_per_exchange"
               for r in col.records)
    col1 = telemetry.Collector(None)
    halo._emit_exchange_telemetry(col1, dict(A=A), ("A",), RankMesh((1,), ("x",)), 1, None,
                                  "bf16", True)
    (ev1,) = [r for r in col1.records if r["kind"] == "event"]
    assert ev1["attrs"]["bytes_raw"] == 0 and ev1["attrs"]["messages"] == 0


# ---------------------------------------------------------------------------
# int8 round trip: the bound the port's own arithmetic gives
# ---------------------------------------------------------------------------
_F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=100, deadline=None)
@given(st.lists(_F32, min_size=1, max_size=3 * compression.BLOCK),
       st.sampled_from([1.0, 1e-30, 1e30, 2.0 ** -120]))
def test_int8_round_trip_within_its_derived_bound(values, scale):
    x = torch.tensor(values, dtype=torch.float32) * scale
    # the bound's domain: finite, |x| <= 2^127
    x = torch.where(torch.isfinite(x) & (x.abs() <= 2.0 ** 127), x, torch.zeros_like(x))
    q, s, meta = compression.quantize_int8(x)
    back = compression.dequantize_int8(q, s, meta)
    assert back.shape == x.shape and back.dtype == torch.float32
    err = (back.double() - x.double()).abs()
    bound = compression.int8_error_bound(x, s, meta)
    assert bool((err <= bound).all()), float((err - bound).max())
    assert int(q.abs().max()) <= 127


def test_int8_bound_is_tight_to_half_a_scale():
    x = torch.linspace(-3.0, 3.0, 5000)
    q, s, meta = compression.quantize_int8(x)
    err = (compression.dequantize_int8(q, s, meta).double() - x.double()).abs()
    bound = compression.int8_error_bound(x, s, meta)
    assert bool((err <= bound).all())
    # the code's rounding dominates: the bound sits within 0.01% of scale/2
    half = 0.5 * s.double().max()
    assert float(bound.max()) < float(half) * 1.0001


# ---------------------------------------------------------------------------
# one rank: the periodic self-wrap is a local copy
# ---------------------------------------------------------------------------
def test_single_rank_self_wrap_needs_no_process_group(rng):
    mesh = make_mesh((1, 1), ("x", "y"))
    a = torch.from_numpy(rng.rand(9, 8, 3).astype(np.float32))
    got = halo.halo_exchange(a.clone(), mesh, radius=2, periodic=True)
    inner = a[2:-2, 2:-2].numpy()
    want = np.pad(inner, ((2, 2), (2, 2), (0, 0)), mode="wrap")
    np.testing.assert_array_equal(got[:, :, :].numpy(), want)
    same = halo.halo_exchange(a.clone(), mesh, radius=2, periodic=False)
    assert torch.equal(same, a)              # a non-periodic edge keeps its ghosts
    with pytest.raises(ValueError, match="holds 2 ranks"):
        make_mesh((2,), ("x",))
    with pytest.raises(ValueError, match="compress"):
        halo.exchange_many({"a": a}, ("a",), mesh, compress="fp8")
    with pytest.raises(ValueError, match="ghost"):
        halo.halo_exchange(a, mesh, radius=1, depths=[(2, 0), (0, 0)])


# ---------------------------------------------------------------------------
# gangs: 2 x 2 grouped exchanges, against per-field and the reference
# ---------------------------------------------------------------------------
LS = (12, 14, 6)
DEPTHS = {"A": ((2, 1), (0, 2)), "B": ((1, 1), (2, 2))}


def _inputs(path, rng):
    A = rng.rand(2, 2, *LS).astype(np.float32)
    B = (rng.rand(2, 2, *LS) * 1e3).astype(np.float32)
    C = rng.randint(0, 100, (2, 2, *LS)).astype(np.int32)
    np.savez(path, A=A, B=B, C=C)
    return A, B, C


_REF_GROUPED = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed import halo
from repro.launch.mesh import make_mesh
d = np.load({inp!r})
mesh = make_mesh((2, 2), ("x", "y"))
depths = {depths!r}
out = {{}}
for tag, kw in [("plain", dict(periodic=False)), ("per", dict(periodic=True)),
                ("bf16", dict(depths=depths, compress="bf16")),
                ("int8", dict(depths=depths, compress="int8"))]:
    def f(A, B, C, kw=kw):
        r = halo.exchange_many(dict(A=A[0, 0], B=B[0, 0], C=C[0, 0]), ("A", "B", "C"),
                               ("x", "y"), radius=2, **kw)
        return tuple(r[n][None, None] for n in ("A", "B", "C"))
    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("x", "y"),) * 3,
                          out_specs=(P("x", "y"),) * 3, check_vma=False))
    for n, v in zip("ABC", g(jnp.asarray(d["A"]), jnp.asarray(d["B"]), jnp.asarray(d["C"]))):
        out[tag + n] = np.asarray(v)
np.savez({out!r}, **out)
print("REF_OK")
"""

_PORT_GROUPED = r"""
from repro_torch.distributed import halo
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("x", "y"))
d = np.load(os.environ["INP"])
i, j = mesh.coords
fields = {n: torch.from_numpy(d[n][i, j].copy()) for n in "ABC"}
depths = {k: tuple(tuple(p) for p in v) for k, v in json.loads(os.environ["DEPTHS"]).items()}
out, same = {}, True
for tag, kw in [("plain", dict(periodic=False)), ("per", dict(periodic=True)),
                ("bf16", dict(depths=depths, compress="bf16")),
                ("int8", dict(depths=depths, compress="int8"))]:
    g = halo.exchange_many({n: v.clone() for n, v in fields.items()}, ("A", "B", "C"),
                           mesh, radius=2, **kw)
    s = halo.exchange_many({n: v.clone() for n, v in fields.items()}, ("A", "B", "C"),
                           mesh, radius=2, grouped=False, **kw)
    for n in "ABC":
        out[tag + n] = g[n].numpy()
        if "compress" not in kw:        # int8 quantizes per message: grouped != per field
            same &= bool(torch.equal(g[n], s[n]))
np.savez(os.environ["OUT"] + f"_{ctx.rank}.npz", **out)
print("RESULT", json.dumps({"coords": [i, j], "grouped_equals_per_field": same}))
"""


def test_grouped_exchange_against_per_field_and_reference(tmp_path, rng):
    """Float and int fields, periodic and not, radius 2; with per-field
    depths and the bf16 and int8 wires. Grouped equals per field (without
    int8, which quantizes per message), and every rank's result equals the
    reference's bitwise."""
    inp = str(tmp_path / "inputs.npz")
    _inputs(inp, rng)
    ref = str(tmp_path / "ref.npz")
    assert "REF_OK" in run_subprocess(_REF_GROUPED.format(inp=inp, out=ref, depths=DEPTHS),
                                      n_devices=4, timeout=240)
    out = run_gang(_PORT_GROUPED, 4, timeout=90,
                   env={"INP": inp, "OUT": str(tmp_path / "port"),
                        "DEPTHS": json.dumps(DEPTHS)})
    res = results(out)
    assert all(r[0]["grouped_equals_per_field"] for r in res)
    want = np.load(ref)
    for rank, r in enumerate(res):
        i, j = r[0]["coords"]
        got = np.load(str(tmp_path / f"port_{rank}.npz"))
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key][i, j], err_msg=key)


_PORT_1D = r"""
from repro_torch.distributed import compression, halo
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4,), ("x",))
n_local = 6
full = torch.arange(4 * (n_local - 2), dtype=torch.float32) + 100
i = mesh.coords[0]
loc = torch.nn.functional.pad(full[i * (n_local - 2):(i + 1) * (n_local - 2)], (1, 1))
out = halo.halo_exchange(loc, mesh, radius=1, periodic=True)
res = {"lo": float(out[0]), "hi": float(out[-1]), "same_tensor": out is loc}

# the wire formats on a 2-D payload: each ghost within its format's bound
g = torch.from_numpy(np.random.RandomState(1).randn(4 * 8 + 2, 700).astype(np.float32))
exact = halo.halo_exchange(halo.local_block(g, (4,), (i,), 1), mesh, radius=1)
for fmt in ("bf16", "int8"):
    got = halo.halo_exchange(halo.local_block(g, (4,), (i,), 1), mesh, radius=1,
                             compress=fmt)
    diff = (got.double() - exact.double()).abs()
    res[fmt + "_interior_exact"] = bool(torch.equal(got[1:-1], exact[1:-1]))
    if fmt == "bf16":
        ok = diff <= exact.double().abs() * 2.0 ** -8
    else:
        ok = torch.ones_like(diff, dtype=torch.bool)
        for side, src in ((0, -2), (-1, 1)):      # each ghost row left a neighbour's slab
            row = exact[side]
            q, s, meta = compression.quantize_int8(row)
            ok[side] = diff[side] <= compression.int8_error_bound(row, s, meta)
    res[fmt + "_within_bound"] = bool(ok.all())
    res[fmt + "_max_err"] = float(diff.max())

# error-feedback int8 all-reduce (the reference's own checks)
gl = torch.from_numpy(np.random.RandomState(1).randn(4, 1000).astype(np.float32))
exact_sum = gl.sum(0)
red, err = compression.compressed_psum(gl[i], mesh.group, torch.zeros(1000))
res["rel"] = float((red - exact_sum).abs().max() / exact_sum.abs().max())
acc, err = torch.zeros(1000), torch.zeros(1000)
for _ in range(50):
    red, err = compression.compressed_psum(gl[i], mesh.group, err)
    acc += red
res["bias"] = float((acc / 50 - exact_sum).abs().max() / exact_sum.abs().max())
print("RESULT", json.dumps(res))
"""


def test_periodic_wrap_wire_bounds_and_compressed_psum():
    """Four ranks along x: rank 0's low ghost is the last interior value of
    the global line (the wrap), rank 3's high ghost the first; bf16 and
    int8 ghosts stay within their formats' bounds and leave the interior
    exact; the error-feedback int8 sum is within 5% and its bias shrinks
    under 2% over 50 repeats (the reference's thresholds)."""
    res = [r[0] for r in results(run_gang(_PORT_1D, 4, timeout=90))]
    assert res[0]["lo"] == 100 + 15 and res[3]["hi"] == 100.0
    assert res[1]["lo"] == 100 + 3 and res[1]["hi"] == 100 + 8
    for r in res:
        assert r["same_tensor"]
        for fmt in ("bf16", "int8"):
            assert r[fmt + "_interior_exact"] and r[fmt + "_within_bound"], r
        assert 0 < r["bf16_max_err"] and 0 < r["int8_max_err"]
        assert r["rel"] < 0.05 and r["bias"] < 0.02
    assert len({json.dumps([r["rel"], r["bias"]]) for r in res}) == 1   # rank-uniform
