#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

It builds every CUDA kernel of the Fig. 1 path from the sources in the
checkout (one nvcc per source, all started together), holds each kernel
against its plain PyTorch version on the card, drives the port's main path
at the paper's FIG1 size (512^3 f32: 100 @parallel steps, the same steps
with the explicit kernel, then solve_until), checks the result, and times
each kernel beside its plain version and its bound.

It prints JSON lines; the line before the last lists the kernels, the one
before that is the card's name and power limit as nvidia-smi gives them,
and the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without a card, or without the repository
beside it, it exits non-zero at once.
"""
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(33, 20, 130), (64, 64, 64), (512, 512, 512)]
ALL_REDS = {"err": "max_abs_diff(T2, T)", "mx": "max_abs(T2)", "s": "sum(T2)",
            "m2": "sum_sq(T2)"}
ERR = {"err": "max_abs_diff(T2, T)"}
# Sums fold in another order than torch.sum; every addend here is positive,
# so each order's relative error is at most its longest chain of additions
# (about 130 + 8 + 15 here) times 2^-24, under 1e-5.
SUM_RTOL = 1e-5
# NVIDIA's H100 SXM data sheet: memory rate and f32 rate outside the tensor
# cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
T_RANGE = (1.7, 2.7)      # the maximum principle for the Fig. 1 initial state
T_SLACK = 2.0 ** -20      # a few f32 ulps of rounding at T ~ 2


def emit(obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import FIG1, Diffusion3DConfig
    from repro_torch.core import init_parallel_stencil, teff
    from repro_torch.examples import quickstart
    from repro_torch.kernels import build, diffusion3d, ref, stencil

    torch.manual_seed(0)
    dev = torch.device("cuda", 0)

    # ---- 1. card ------------------------------------------------------
    name, power = teff.card_info(0)
    emit({"phase": "card", "name": name, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ---- 2. build -----------------------------------------------------
    ps = init_parallel_stencil()
    ps_plain = init_parallel_stencil(backend="torch", device="cuda")
    step = quickstart.make_step(ps)
    step_plain = quickstart.make_step(ps_plain)
    generic, generic_plain = make_generic(ps), make_generic(ps_plain)
    shape_kw = {n: (8, 8, 8) for n in ("T2", "T", "Ci")}
    sc_names = dict.fromkeys(("lam", "dt", "_dx", "_dy", "_dz"), 1.0)
    calls = [step.compiled(**shape_kw, **sc_names),
             step.with_reductions(ERR).compiled(**shape_kw, **sc_names),
             step.with_reductions(ALL_REDS).compiled(**shape_kw, **sc_names),
             generic.compiled(**{n: (8, 8, 8) for n in ("A2", "B2", "A", "B")}, c=1.0, h=1.0)]
    t0 = time.perf_counter()
    builds = build.compile_many([("diffusion3d", diffusion3d.SOURCE.read_text())]
                                + [(c.lib_name, c.source) for c in calls])
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "builds": [{"name": b.name, "seconds": b.seconds,
                      "ptxas": [ln.strip() for ln in b.log.splitlines()
                                if "registers" in ln or "spill" in ln]}
                     for b in builds]})

    # ---- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device="cpu").manual_seed(20260714)
    # each generated variant beside its torch-backend twin: the two the main
    # path launches, and the one with every reduction kind
    variants = {
        "stencil": (step, step_plain),
        "stencil+err": (step.with_reductions(ERR), step_plain.with_reductions(ERR)),
        "stencil+4red": (step.with_reductions(ALL_REDS), step_plain.with_reductions(ALL_REDS)),
    }
    err_at = {}
    for shape in SHAPES:
        T = torch.rand(shape, generator=gen).to(dev)
        T2 = torch.rand(shape, generator=gen).to(dev)
        Ci = (torch.rand(shape, generator=gen) + 0.5).to(dev)
        sc = {"lam": 1.0, "dt": 1e-4, "_dx": float(shape[0] - 1),
              "_dy": float(shape[1] - 1), "_dz": float(shape[2] - 1)}
        args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
        d_hand = max_abs_diff(diffusion3d.diffusion3d_step(T2, T, Ci, *args),
                              ref.diffusion3d_step(T2, T, Ci, *args))
        require(d_hand == 0.0, f"diffusion3d differs from its plain version at {shape}")
        err_at[shape] = {"diffusion3d": d_hand}
        row = {"phase": "check", "shape": list(shape), "diffusion3d_max_abs_diff": d_hand}
        for label, (kern, plain) in variants.items():
            got, want = kern(T2=T2, T=T, Ci=Ci, **sc), plain(T2=T2, T=T, Ci=Ci, **sc)
            (o_k, r_k), (o_p, r_p) = (got, want) if kern.reductions else ((got, {}), (want, {}))
            d = max_abs_diff(o_k, o_p)
            reds = {n: {"kernel": float(r_k[n]), "plain": float(r_p[n])} for n in r_k}
            require(d == 0.0, f"{label} differs from the torch backend at {shape}")
            for n, r in kern.reductions.items():
                a, b = reds[n]["kernel"], reds[n]["plain"]
                if r.combine == "max":
                    require(a == b, f"{label}: {n} differs at {shape}")
                else:
                    require(math.isclose(a, b, rel_tol=SUM_RTOL),
                            f"{label}: {n} outside rtol {SUM_RTOL} at {shape}")
            # the error of what the variant returns: its output, and its
            # max-kind reductions (held bitwise above)
            err_at[shape][label] = max([d] + [abs(reds[n]["kernel"] - reds[n]["plain"])
                                              for n, r in kern.reductions.items()
                                              if r.combine == "max"])
            row[label] = {"max_abs_diff": d, "reductions": reds}
            del got, want, o_k, o_p
        if shape != SHAPES[-1]:
            fa = {n: torch.rand(shape, generator=gen).to(dev) for n in ("A2", "B2", "A", "B")}
            (ga, gr), (pa, pr) = generic(**fa, c=0.3, h=0.7), generic_plain(**fa, c=0.3, h=0.7)
            row["generic_max_abs_diff"] = max(max_abs_diff(ga[n], pa[n]) for n in ga)
            row["generic_reductions"] = {n: [float(gr[n]), float(pr[n])] for n in gr}
            require(row["generic_max_abs_diff"] == 0.0, f"generic kernel differs at {shape}")
            require(float(gr["d"]) == float(pr["d"]), f"generic max_abs_diff differs at {shape}")
            require(math.isclose(float(gr["s"]), float(pr["s"]), rel_tol=SUM_RTOL),
                    f"generic sum outside rtol at {shape}")
        emit(row)
        del T, T2, Ci

    # ---- 4. the main path at FIG1 ------------------------------------------
    stencil.launches.clear()
    diffusion3d.launches = 0
    t0 = time.perf_counter()
    r = quickstart.run(FIG1, device="cuda", tol=1e-7, max_iters=1000, check_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"step": stencil.launches["step"], "step[err]": stencil.launches["step[err]"],
              "diffusion3d": diffusion3d.launches}
    final = {"T": r.T, "T_explicit": r.T_explicit, "solve_T": r.solve.output(r.step)}
    stats = {n: {"finite": bool(torch.isfinite(t).all()), "min": float(t.min()),
                 "max": float(t.max())} for n, t in final.items()}
    explicit_diff = max_abs_diff(r.T, r.T_explicit)
    emit({"phase": "main_path", "config": "FIG1", "shape": list(FIG1.shape), "nt": FIG1.nt,
          "wall_s": wall, "launches": counts, "fields": stats,
          "explicit_vs_parallel_max_abs_diff": explicit_diff,
          "solve": {"iters": r.solve.iters, "host_syncs": r.solve.host_syncs,
                    "err": r.solve.err, "tol": 1e-7, "max_iters": 1000, "check_every": 10}})
    for n, s in stats.items():
        require(s["finite"], f"{n} holds non-finite values")
        require(T_RANGE[0] - T_SLACK <= s["min"] and s["max"] <= T_RANGE[1] + T_SLACK,
                f"{n} leaves {T_RANGE}: [{s['min']}, {s['max']}]")
    for k, v in counts.items():
        require(v > 0, f"kernel {k} was not launched on the main path")
    require(explicit_diff == 0.0, "explicit kernel and @parallel step disagree")
    require(r.solve.host_syncs == r.solve.iters // 10, "host_syncs != iters // check_every")
    del r, final

    cfg64 = Diffusion3DConfig(nx=64, ny=64, nz=64, nt=100)
    rc = quickstart.run(cfg64, device="cuda", backend="cuda", tol=1e-7, max_iters=1000)
    rt = quickstart.run(cfg64, device="cuda", backend="torch", tol=1e-7, max_iters=1000)
    small = {"T_max_abs_diff": max_abs_diff(rc.T, rt.T),
             "solve_max_abs_diff": max_abs_diff(rc.solve.output(rc.step),
                                                rt.solve.output(rt.step)),
             "iters": [rc.solve.iters, rt.solve.iters], "err": [rc.solve.err, rt.solve.err]}
    emit({"phase": "main_path_64_vs_torch_backend", **small})
    require(small["T_max_abs_diff"] == 0.0 and small["solve_max_abs_diff"] == 0.0,
            "cuda and torch backends disagree at 64^3")
    require(rc.solve.iters == rt.solve.iters and rc.solve.err == rt.solve.err,
            "solve_until differs between the backends at 64^3")
    del rc, rt

    # ---- 5. times at FIG1 ---------------------------------------------------
    spec = teff.device_spec(0)
    grid, f, sc = quickstart.initial_state(FIG1, "cuda")
    args = (sc["lam"], sc["dt"], sc["_dx"], sc["_dy"], sc["_dz"])
    timed = {
        "stencil": lambda: step(**f, **sc),
        "stencil_plain": lambda: step_plain(**f, **sc),
        "stencil+err": lambda: step.with_reductions(ERR)(**f, **sc),
        "stencil+err_plain": lambda: step_plain.with_reductions(ERR)(**f, **sc),
        "diffusion3d": lambda: diffusion3d.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args),
        "diffusion3d_plain": lambda: ref.diffusion3d_step(f["T2"], f["T"], f["Ci"], *args),
    }
    ms = {k: teff.measure(fn, iters=20, warmup=3).median_s * 1e3 for k, fn in timed.items()}
    a_eff = teff.a_eff_from_ir(step.stencil_ir(**f, **sc), 4)
    # f32 operations per interior cell: the step's tap program; the check
    # adds a subtract, an abs and a max; the explicit kernel does the step's
    # arithmetic
    interior = math.prod(n - 2 for n in FIG1.shape)
    n_ops = len(calls[0].program.outputs[0].ops)
    ops = {"stencil": n_ops * interior, "stencil+err": (n_ops + 3) * interior,
           "diffusion3d": n_ops * interior}
    bound_ms = {k: max(a_eff / PEAK_BYTES_PER_S, v / PEAK_F32_PER_S) * 1e3
                for k, v in ops.items()}
    copy_bound_ms = a_eff / spec.peak_bw * 1e3
    emit({"phase": "times", "card": spec.name, "power_limit": spec.power_limit,
          "shape": list(FIG1.shape), "a_eff_bytes": a_eff,
          "copy_bandwidth_GBps": spec.peak_bw / 1e9, "ms": ms,
          "t_eff_GBps": {k: a_eff / (v / 1e3) / 1e9 for k, v in ms.items()},
          "t_eff_over_copy": {k: a_eff / (v / 1e3) / spec.peak_bw for k, v in ms.items()},
          "bound_ms": bound_ms, "copy_bound_ms": copy_bound_ms})

    # ---- 6. the kernels line -------------------------------------------------
    fig1 = SHAPES[-1]
    gen_src = "src/repro_torch/kernels/codegen.py"
    rows = [
        ("stencil", "step", gen_src, "src/repro/kernels/stencil.py:1052"),
        ("stencil+err", "step[err]", gen_src, "src/repro/kernels/stencil.py:1052"),
        ("diffusion3d", "diffusion3d", "src/repro_torch/kernels/csrc/diffusion3d.cu",
         "src/repro/kernels/diffusion3d.py:75"),
    ]
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[c],
                "max_abs_err": err_at[fig1][k],
                "ms": ms[k], "plain_ms": ms[k + "_plain"], "bound_ms": bound_ms[k],
                "bound_by": "bytes" if a_eff / PEAK_BYTES_PER_S >= ops[k] / PEAK_F32_PER_S
                else "operations",
                "copy_bound_ms": copy_bound_ms, "library_ms": None}
               for k, c, src, rep in rows]
    print(f"{name}, {power}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def max_abs_diff(a, b) -> float:
    return float((a - b).abs().max())


def make_generic(ps):
    """A two-output, radius-2 update with one-sided reads, a reversed
    subtraction and a division: it exercises what Fig. 1 does not."""
    @ps.parallel(outputs=("A2", "B2"), reductions={"d": "max_abs_diff(A2, A)",
                                                   "s": "sum_sq(B2)"})
    def generic(A2, B2, A, B, c, h):
        return {
            "A2": A[2:-2, 2:-2, 2:-2] + c * (A[4:, 2:-2, 2:-2] - A[:-4, 2:-2, 2:-2])
            - (1.0 - B[2:-2, 2:-2, 1:-3]) * h,
            "B2": B[1:-1, 1:-1, 1:-1] / (2.0 + abs(A[1:-1, :-2, 1:-1]))
            - h ** 2 * B[1:-1, 1:-1, 2:],
        }

    return generic


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
