"""Where the LM serving time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch zamba2-1.2b] [--batch 4] [--prompt-len 1024] [--decode-steps 8] \\
        [--smoke] [--device cuda|cpu] [--override field=value ...]

For each implementation (``cuda``: the hand-written kernels; ``ref``: their
plain versions) it builds the model with random weights from a seed, warms
up with one prefill and one decode step, then times on the host clock
(each sample ends in ``torch.cuda.synchronize()``) three prefills and
``--decode-steps`` decode steps, and traces one more prefill and decode
step with ``torch.profiler``. It prints one JSON line per implementation:
the warm prefill and decode-step times (medians), the device time the trace
saw in each and its share of the host time (the device's busy share), and
the kernels with the most device time, grouped as the port's own kernels,
matrix products and everything else.

Any arch of ``configs.ARCH_IDS`` runs, with the prefill batch of its
family (a VLM's patch embeddings, an enc-dec's frames); ``--override
n_layers=8`` cuts a config that does not fit the card (Zamba2's weights
take 4.7 GB at f32). ``--device cpu --smoke`` runs the same phases at the
smoke size on the CPU (the trace then holds host time only, and no device
number is printed).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .. import configs
from ..core.device import resolve_device
from ..models import RunConfig, build, synth_batch

OWN_KERNELS = ("conv1d_tile", "conv1d_any", "ssd_states_kernel", "ssd_output_kernel",
               "attention_kernel")
MATMUL_MARKS = ("gemm", "gemv", "cutlass", "sm90_xmma", "cublas")


def _kind(name: str) -> str:
    low = name.lower()
    if any(k in name for k in OWN_KERNELS):
        return "port kernels"
    if any(k in low for k in MATMUL_MARKS):
        return "matrix products"
    return "other"


# CUPTI's marker for a host stalled on a full launch queue: no device work
NOT_DEVICE_WORK = ("Command Buffer Full",)


def _device_us(evt) -> float:
    """Device time of a device-side event (a kernel, copy or set); host
    operators, which also report their kernels' time, count 0, so that no
    kernel is counted twice."""
    if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in NOT_DEVICE_WORK:
        return 0.0
    # renamed from self_cuda_time_total in recent PyTorch releases
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trace(fn, top: int, dev: torch.device) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        _sync(dev)
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    by_kind: dict[str, float] = {}
    for key, _, us in rows:
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0.0) + us / 1e3
    rows.sort(key=lambda r: -r[2])
    return {"device_ms": sum(r[2] for r in rows) / 1e3, "by_kind_ms": by_kind,
            "top": [{"kernel": k[:120], "calls": c, "ms": us / 1e3} for k, c, us in rows[:top]]}


def profile(arch: str, batch: int, prompt_len: int, decode_steps: int, impl: str,
            seed: int = 0, top: int = 8, smoke: bool = False, device="cuda",
            overrides=None) -> dict:
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
    if overrides:
        cfg = configs.apply_overrides(cfg, overrides)
    model = build(cfg, RunConfig(param_dtype="float32", attn_impl=impl, ssd_impl=impl,
                                 conv_impl=impl), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens = synth_batch(model, torch.Generator(device=dev).manual_seed(seed + 1),
                         prompt_len, batch)
    max_seq = prompt_len + decode_steps + 3

    def prefill():
        return model.prefill(params, tokens, max_seq)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return time.perf_counter() - t0, out

    with torch.inference_mode():
        logits, cache = prefill()                                   # warm-up
        tok = torch.argmax(logits, -1)
        model.decode_step(params, tok, cache, prompt_len)
        prefill_s = [timed(prefill)[0] for _ in range(3)]
        logits, cache = prefill()
        tok = torch.argmax(logits, -1)
        step_s = []
        for i in range(decode_steps):
            dt, (logits, cache) = timed(lambda: model.decode_step(params, tok, cache,
                                                                  prompt_len + i))
            step_s.append(dt)
            tok = torch.argmax(logits, -1)
        pre = _trace(prefill, top, dev)
        _, cache = prefill()
        dec = _trace(lambda: model.decode_step(params, tok, cache, prompt_len), top, dev)
    p_ms, d_ms = statistics.median(prefill_s) * 1e3, statistics.median(step_s) * 1e3
    for tr, ms in ((pre, p_ms), (dec, d_ms)):
        tr["busy_share"] = tr["device_ms"] / ms if tr["device_ms"] else None
    return {"arch": arch, "impl": impl, "batch": batch, "prompt_len": prompt_len,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "prefill_ms": p_ms, "prefill_samples_ms": [s * 1e3 for s in prefill_s],
            "decode_step_ms": d_ms, "decode_tok_per_s": batch / (d_ms / 1e3),
            "prefill_trace": pre, "decode_step_trace": dec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--override", action="append", default=[], metavar="FIELD=VALUE")
    args = ap.parse_args(argv)
    overrides = dict(o.split("=", 1) for o in args.override)
    for impl in ("cuda", "ref"):
        print(json.dumps(profile(args.arch, args.batch, args.prompt_len, args.decode_steps,
                                 impl, smoke=args.smoke, device=args.device,
                                 overrides=overrides)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
