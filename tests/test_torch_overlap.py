"""The port's ``@hide_communication`` (``repro_torch.distributed.overlap``)
on gloo gangs of CPU processes, held against the port's single-process
result and the JAX package's ``shard_map`` result.

Contract: every rank computes each owned cell with the single-process
step's arithmetic, so the gathered owned cells of ``sequential_step``,
``overlapped_step`` (also with ``march_axis`` and coupled staggered inputs)
and the deep-halo ``multi_step`` are bitwise equal to the port's
single-process steps, and ``overlapped_step`` is bitwise equal to
``sequential_step`` on the whole local block. The reductions fold the
owned cells: a max equals the single-process value bitwise, a sum within
rtol 1e-6. Against the reference's ``shard_map`` run (another framework on
the same f32 inputs) the fields agree to atol 1e-6, as the reference's own
multi-device tests hold them against its single device. The generated
kernel's launches at the shapes the distributed path gives it (rank
blocks, shell slabs thinner than a tile) are rehearsed on the CPU bitwise
to the ``torch`` backend.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import fd2d as fd2, fd3d, init_parallel_stencil
from repro_torch.distributed import fault, overlap
from repro_torch.kernels import rehearse
from repro_torch.launch.mesh import RankMesh
from torch_gang import results, run_gang

SC = dict(lam=1.0, dt=1e-4, _dx=1.0, _dy=1.0, _dz=1.0)
NG, NZ, K = 34, 10, 3


def fig1(T2, T, Ci, lam, dt, _dx, _dy, _dz):
    return {"T2": fd3d.inn(T) + dt * (lam * fd3d.inn(Ci) * (
        fd3d.d2_xi(T) * _dx ** 2 + fd3d.d2_yi(T) * _dy ** 2 + fd3d.d2_zi(T) * _dz ** 2))}


def _kernel(reds=None):
    return init_parallel_stencil(backend="torch", device="cpu").parallel(
        outputs=("T2",), rotations={"T2": "T"}, reductions=reds)(fig1)


_GANG_2X2 = r"""
from repro_torch.core import fd3d, init_parallel_stencil
from repro_torch.distributed import elastic, halo, overlap
from repro_torch.launch.mesh import make_mesh
exec(os.environ["FIG1_SRC"])
mesh = make_mesh((2, 2), ("x", "y"))
d = {k: torch.from_numpy(v) for k, v in np.load(os.environ["INP"]).items()}
sc = json.loads(os.environ["SC"])
ps = init_parallel_stencil(backend="torch", device="cpu")
kern = ps.parallel(outputs=("T2",), rotations={"T2": "T"})(fig1)
reds = {"err": "max_abs_diff(T2, T)", "s": "sum(T2)"}
kr = kern.with_reductions(reds)
Tl, Cl = (halo.local_block(d[n], (2, 2), mesh.coords, 1) for n in ("T", "Ci"))
res = {}

# three overlapped steps (the reference's test), gathered on rank 0
T = Tl.clone()
for _ in range(3):
    T, _ = overlap.overlapped_step(kern, dict(T2=T, T=T, Ci=Cl), sc, ("T",), mesh)
g = elastic.fetch_global({"T": T}, mesh, 1, to=0)

# one step four ways: sequential, overlapped, overlapped marched, with reductions
outs = {}
for tag, fn, kw in [("seq", overlap.sequential_step, {}), ("ovl", overlap.overlapped_step, {}),
                    ("march", overlap.overlapped_step, {"march_axis": 2})]:
    A = Tl.clone()
    outs[tag], fresh = fn(kern, dict(T2=A, T=A, Ci=Cl), sc, ("T",), mesh, **kw)
    outs[tag + "_fresh"] = fresh["T"]
res["ovl_equals_seq"] = bool(torch.equal(outs["ovl"], outs["seq"])
                             and torch.equal(outs["ovl_fresh"], outs["seq_fresh"]))
res["march_equals_ovl"] = bool(torch.equal(outs["march"], outs["ovl"]))
red = {}
for tag, fn in [("seq", overlap.sequential_step), ("ovl", overlap.overlapped_step)]:
    A, B = Tl.clone(), Tl.clone() + 0.5
    (o, r), _ = fn(kr, dict(T2=B, T=A, Ci=Cl), sc, ("T",), mesh)
    red[tag] = {n: float(v) for n, v in r.items()}
    outs[tag + "_red"] = o
res["reds"] = red
res["reds_out_equal"] = bool(torch.equal(outs["seq_red"], outs["ovl_red"]))
g1 = elastic.fetch_global({"seq": outs["seq"], "red": outs["ovl_red"]}, mesh, 1, to=0)

# temporal blocking: one 3-deep exchange, three local steps
Tk, Ck = (halo.local_block(d[n], (2, 2), mesh.coords, 3) for n in ("Tk", "Ck"))
out_k, _ = overlap.multi_step(kern, dict(T2=Tk, T=Tk, Ci=Ck), sc, ("T",), mesh, 3)
gk = elastic.fetch_global({"Tk": out_k}, mesh, 3, to=0)
if mesh.position == 0:
    np.savez(os.environ["OUT"], T=g["T"].numpy(), Tk=gk["Tk"].numpy(),
             seq=g1["seq"].numpy(), red=g1["red"].numpy())
print("RESULT", json.dumps(res))
"""

_REF_2X2 = r"""
import jax, jax.numpy as jnp, numpy as np, json
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import init_parallel_stencil, fd3d
from repro.distributed import halo, overlap
from repro.launch.mesh import make_mesh
exec({fig1!r})
d = np.load({inp!r})
sc = {sc!r}
K = {K}
mesh = make_mesh((2, 2), ("x", "y"))
ps = init_parallel_stencil(backend="jnp", ndims=3)
kern = ps.parallel(outputs=("T2",), rotations={{"T2": "T"}})(fig1)

def stacked(a, r):
    locs = halo.global_to_local(jnp.asarray(a), (2, 2), radius=r)
    return jnp.asarray(np.stack(locs).reshape(2, 2, *locs[0].shape)), locs[0].shape

Ts, ls = stacked(d["T"], 1)
Cs, _ = stacked(d["Ci"], 1)
def steps(Tl, Cl):
    Tl, Cl = Tl[0, 0], Cl[0, 0]
    for _ in range(3):
        Tl, _ = overlap.overlapped_step(kern, dict(T2=Tl, T=Tl, Ci=Cl), sc, ("T",), ("x", "y"))
    return Tl[None, None]
f = jax.jit(shard_map(steps, mesh=mesh, in_specs=(P("x", "y"),) * 2, out_specs=P("x", "y"),
                      check_vma=False))
T = halo.local_to_global(list(np.asarray(f(Ts, Cs)).reshape(4, *ls)), (2, 2))

Tks, lk = stacked(d["Tk"], K)
Cks, _ = stacked(d["Ck"], K)
def ksteps(Tl, Cl):
    Tl, Cl = Tl[0, 0], Cl[0, 0]
    out, _ = overlap.multi_step(kern, dict(T2=Tl, T=Tl, Ci=Cl), sc, ("T",), ("x", "y"), K)
    return out[None, None]
f = jax.jit(shard_map(ksteps, mesh=mesh, in_specs=(P("x", "y"),) * 2, out_specs=P("x", "y"),
                      check_vma=False))
Tk = halo.local_to_global(list(np.asarray(f(Tks, Cks)).reshape(4, *lk)), (2, 2), radius=K)
np.savez({out!r}, T=T, Tk=Tk)
print("REF_OK")
"""


def _fig1_src() -> str:
    import inspect

    return inspect.getsource(fig1)


def _single_process(d):
    kern = _kernel()
    T, Ci = (torch.from_numpy(d[n]) for n in ("T", "Ci"))
    for _ in range(3):
        T = kern(T2=T, T=T, Ci=Ci, **SC)
    a = b = torch.from_numpy(d["Tk"])
    Ck = torch.from_numpy(d["Ck"])
    for _ in range(K):
        a = kern(T2=a, T=b, Ci=Ck, **SC)
        a, b = b, a
    T0 = torch.from_numpy(d["T"])
    one = kern(T2=T0, T=T0, Ci=Ci, **SC)
    (o, r) = kern.with_reductions({"err": "max_abs_diff(T2, T)", "s": "sum(T2)"})(
        T2=T0 + 0.5, T=T0, Ci=Ci, **SC)
    return T, b, one, o, {n: float(v) for n, v in r.items()}


def test_overlapped_2x2_fig1_against_single_process_and_reference(tmp_path, rng):
    ng_k = 24 + 2 * K
    d = {"T": rng.rand(NG, NG, NZ).astype(np.float32),
         "Ci": (rng.rand(NG, NG, NZ) + 0.5).astype(np.float32),
         "Tk": rng.rand(ng_k, ng_k, NZ).astype(np.float32),
         "Ck": (rng.rand(ng_k, ng_k, NZ) + 0.5).astype(np.float32)}
    inp, out, ref = (str(tmp_path / n) for n in ("inp.npz", "port.npz", "ref.npz"))
    np.savez(inp, **d)
    gang = run_gang(_GANG_2X2, 4, timeout=90,
                    env={"INP": inp, "OUT": out, "SC": json.dumps(SC),
                         "FIG1_SRC": _fig1_src()})
    assert "REF_OK" in run_subprocess(_REF_2X2.format(fig1=_fig1_src(), inp=inp, out=ref,
                                                      sc=SC, K=K), n_devices=4, timeout=240)
    res = [r[0] for r in results(gang)]
    for r in res:
        assert r["ovl_equals_seq"] and r["march_equals_ovl"] and r["reds_out_equal"]
        assert r["reds"] == res[0]["reds"]                      # rank-uniform
    T, Tk, one, o, reds = _single_process(d)
    got, want = np.load(out), np.load(ref)
    np.testing.assert_array_equal(got["T"], T.numpy())
    np.testing.assert_array_equal(got["seq"], one.numpy())
    np.testing.assert_array_equal(got["red"], o.numpy())
    own = (slice(K, -K), slice(K, -K))
    np.testing.assert_array_equal(got["Tk"][own], Tk.numpy()[own])
    np.testing.assert_allclose(got["T"], want["T"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["Tk"][own], want["Tk"][own], atol=1e-6, rtol=0)
    for tag in ("seq", "ovl"):
        assert res[0]["reds"][tag]["err"] == reds["err"]
        np.testing.assert_allclose(res[0]["reds"][tag]["s"], reds["s"], rtol=1e-6)


_GANG_1D = r"""
from repro_torch.core import init_parallel_stencil, fd2d as fd
from repro_torch.distributed import elastic, halo, overlap
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4,), ("x",))
d = {k: torch.from_numpy(v) for k, v in np.load(os.environ["INP"]).items()}
ps = init_parallel_stencil(backend="torch", ndims=2, device="cpu")
res = {}

@ps.parallel(outputs=("U2",))
def k4(U2, U, dt):
    # 4th-order laplacian in x (radius 2), 2nd order in y
    d4 = (-U[4:, 2:-2] + 16 * U[3:-1, 2:-2] - 30 * U[2:-2, 2:-2]
          + 16 * U[1:-3, 2:-2] - U[:-4, 2:-2]) / 12.0
    d2 = U[2:-2, 3:-1] - 2 * U[2:-2, 2:-2] + U[2:-2, 1:-3]
    return {"U2": U[2:-2, 2:-2] + dt * (d4 + d2)}

U = halo.local_block(d["U"], (4,), mesh.coords, 2)
A, B = U.clone(), U.clone()
seq, _ = overlap.sequential_step(k4, dict(U2=A, U=A), {"dt": 1e-3}, ("U",), mesh)
ovl, _ = overlap.overlapped_step(k4, dict(U2=B, U=B), {"dt": 1e-3}, ("U",), mesh)
res["radius2_ovl_equals_seq"] = bool(torch.equal(seq, ovl))
g = elastic.fetch_global({"U2": seq}, mesh, 2, to=0)

@ps.parallel(outputs=("phi2", "Pe2"))
def kc(phi2, Pe2, phi, Pe, qx, qy, dtau):
    div_q = fd.d_xa(qx[:, 1:-1]) + fd.d_ya(qy[1:-1, :])
    Pe_new = fd.inn(Pe) + dtau * (-(div_q + fd.inn(Pe)))
    phi_new = fd.inn(phi) + dtau * (-(1.0 - fd.inn(phi)) * Pe_new)
    return {"phi2": phi_new, "Pe2": Pe_new}

i = mesh.coords[0]
# the rank's blocks of the global fields: 16 owned cells and 2 ghosts along x,
# 17 x faces of qx between them
cut = dict(phi=18, Pe=18, qx=17, qy=18)
f = {n: d[n][16 * i:16 * i + k].clone() for n, k in cut.items()}
f2 = {n: v.clone() for n, v in f.items()}
seq, _ = overlap.sequential_step(kc, dict(phi2=f["phi"], Pe2=f["Pe"], **f), {"dtau": 0.01},
                                 ("phi", "Pe"), mesh)
ovl, _ = overlap.overlapped_step(kc, dict(phi2=f2["phi"], Pe2=f2["Pe"], **f2),
                                 {"dtau": 0.01}, ("phi", "Pe"), mesh)
res["coupled_ovl_equals_seq"] = all(bool(torch.equal(seq[n], ovl[n])) for n in ("phi2", "Pe2"))
gc = elastic.fetch_global({n: seq[n] for n in ("phi2", "Pe2")}, mesh, 1, to=0)

@ps.parallel(outputs=("U2",))
def one_sided(U2, U, dt):
    # reads only U[i-2..i] along x: exchange depth (2, 0)
    return {"U2": U[2:-2, 1:-1] + dt * (U[:-4, 1:-1] - U[2:-2, 1:-1])}

ir = one_sided.stencil_ir(U2=tuple(U.shape), U=tuple(U.shape), dt=0.0)
res["field_halo"] = [list(p) for p in ir.field_halo["U"]]
U0 = U.clone()
U0[:2] = -1.0                  # stale ghosts, which the exchange must refresh
U0[-2:] = -1.0
full = halo.exchange_many(dict(U=U0.clone()), ("U",), mesh, radius=2)
tight = halo.exchange_many(dict(U=U0.clone()), ("U",), mesh, radius=2,
                           depths={"U": ir.field_halo["U"][:1]})
a = one_sided(U2=full["U"], U=full["U"], dt=1e-3)
b = one_sided(U2=tight["U"], U=tight["U"], dt=1e-3)
C = U0.clone()
s, _ = overlap.sequential_step(one_sided, dict(U2=C, U=C), {"dt": 1e-3}, ("U",), mesh)
res["tight_equals_full_owned"] = bool(torch.equal(a[2:-2], b[2:-2]) and torch.equal(a[2:-2], s[2:-2]))
res["tight_left_unread_ghosts"] = bool(torch.equal(tight["U"][-2:], U0[-2:]))
res["full_refreshed_them"] = not torch.equal(full["U"][-2:], U0[-2:])
if mesh.position == 0:
    np.savez(os.environ["OUT"], U2=g["U2"].numpy(), **{n: v.numpy() for n, v in gc.items()})
print("RESULT", json.dumps(res))
"""


def test_radius2_coupled_staggered_and_tight_depths_on_four_ranks(tmp_path, rng):
    """Four ranks along x: a radius-2 stencil and a coupled system with
    staggered inputs (rank-local face fields cut from the global ones),
    each overlapped bitwise to sequential and gathered bitwise to one
    process; a one-sided stencil's tight exchange leaves the ghosts it
    never reads as they were."""
    ng = 4 * 16 + 2              # the coupled system's global cells along x
    d = {"U": rng.rand(4 * 16 + 4, 20).astype(np.float32),
         "phi": rng.rand(ng, 16).astype(np.float32), "Pe": rng.rand(ng, 16).astype(np.float32),
         "qx": rng.rand(ng - 1, 16).astype(np.float32), "qy": rng.rand(ng, 15).astype(np.float32)}
    inp, out = str(tmp_path / "inp.npz"), str(tmp_path / "out.npz")
    np.savez(inp, **d)
    res = [r[0] for r in results(run_gang(_GANG_1D, 4, timeout=90,
                                          env={"INP": inp, "OUT": out}))]
    for r in res:
        assert r["radius2_ovl_equals_seq"] and r["coupled_ovl_equals_seq"]
        assert r["field_halo"] == [[2, 0], [0, 0]]
        assert r["tight_equals_full_owned"]
    # the high ghosts, which the stencil never reads: left as they were by the
    # tight exchange, refreshed by the full one (rank 3 has no right neighbour)
    assert all(r["tight_left_unread_ghosts"] for r in res)
    assert [r["full_refreshed_them"] for r in res] == [True, True, True, False]
    ps = init_parallel_stencil(backend="torch", ndims=2, device="cpu")

    @ps.parallel(outputs=("U2",))
    def k4(U2, U, dt):
        d4 = (-U[4:, 2:-2] + 16 * U[3:-1, 2:-2] - 30 * U[2:-2, 2:-2]
              + 16 * U[1:-3, 2:-2] - U[:-4, 2:-2]) / 12.0
        d2 = U[2:-2, 3:-1] - 2 * U[2:-2, 2:-2] + U[2:-2, 1:-3]
        return {"U2": U[2:-2, 2:-2] + dt * (d4 + d2)}

    @ps.parallel(outputs=("phi2", "Pe2"))
    def kc(phi2, Pe2, phi, Pe, qx, qy, dtau):
        div_q = fd2.d_xa(qx[:, 1:-1]) + fd2.d_ya(qy[1:-1, :])
        Pe_new = fd2.inn(Pe) + dtau * (-(div_q + fd2.inn(Pe)))
        phi_new = fd2.inn(phi) + dtau * (-(1.0 - fd2.inn(phi)) * Pe_new)
        return {"phi2": phi_new, "Pe2": Pe_new}

    got = np.load(out)
    Ug = torch.from_numpy(d["U"])
    np.testing.assert_array_equal(got["U2"], k4(U2=Ug, U=Ug, dt=1e-3).numpy())
    g = {n: torch.from_numpy(d[n]) for n in ("phi", "Pe", "qx", "qy")}
    want = kc(phi2=g["phi"], Pe2=g["Pe"], **g, dtau=0.01)
    for n in ("phi2", "Pe2"):
        np.testing.assert_array_equal(got[n], want[n].numpy())


# ---------------------------------------------------------------------------
# the shapes the distributed path launches, rehearsed
# ---------------------------------------------------------------------------
def test_shell_slab_shapes_of_fig1_on_a_2x2_mesh():
    """FIG1 512^3 on 2 x 2 ranks: 257 x 257 x 512 rank blocks, shell slabs
    2r + max(support, ring) = 3 cells thick."""
    kern = _kernel()
    mesh = RankMesh((2, 2), ("x", "y"), 0, (0, 1, 2, 3))
    f = {n: (257, 257, 512) for n in ("T2", "T", "Ci")}
    slabs = overlap.shell_slabs(kern, f, SC, ("T",), mesh)
    assert [(a, s) for a, s, _ in slabs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {shp["T"] for a, _, shp in slabs if a == 0} == {(3, 257, 512)}
    assert {shp["T"] for a, _, shp in slabs if a == 1} == {(257, 3, 512)}


@pytest.fixture()
def cxx():
    if rehearse.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to rehearse the printed kernel")


@pytest.mark.parametrize("shape", [(3, 19, 40), (19, 3, 40), (19, 19, 40), (3, 3, 40)])
def test_printed_kernel_at_rank_block_and_slab_shapes(cxx, shape, rng):
    """A slab thinner than one tile along x or y, a rank block, and both:
    the printed FIG1 kernel, with and without its fused error, equals the
    torch backend bitwise."""
    for reds in (None, {"err": "max_abs_diff(T2, T)"}):
        kern = _kernel(reds)
        f = {n: torch.from_numpy(rng.rand(*shape).astype(np.float32)) for n in ("T2", "T", "Ci")}
        outs, r = rehearse.run(kern.compiled(**f, **SC), f, SC)
        want = kern(**f, **SC)
        if reds:
            want, wr = want
            assert float(r["err"]) == float(wr["err"])
        assert torch.equal(outs["T2"], want)


def test_monitored_stepper_raises_rank_failure(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "host_7.json"), "w") as f:
        json.dump({"step": 1, "t": time.time() - 1000.0, "ewma_s": 0.1}, f)
    mon = fault.StepMonitor(host_id=0, heartbeat_dir=d, timeout_s=300.0)
    stepper = overlap.monitored(lambda x: x + 1, mon, check_peers_every=1)
    with pytest.raises(fault.RankFailure) as ei:
        stepper(torch.tensor(1.0))
    assert ei.value.dead == [7]
    assert 0 in fault.Heartbeat(d).read_all()       # our own heartbeat was bumped first
