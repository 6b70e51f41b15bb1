"""LM serving driver of the port: one prefill, then ``gen_len - 1`` greedy
or temperature decode steps over a batch of prompts. The twin of
``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen-len 32] \\
        [--temperature 0] [--device cuda|cpu]

On ``--device cuda`` (the default) prefill runs the hand-written CUDA
kernels (conv1d, SSD, attention); ``--device cpu`` runs their plain
versions. Without ``--arch`` it forwards to the simulation server's demo,
``python -m repro_torch.serve --demo`` (on ``--device``), as the
reference forwards to ``repro.serve``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..core.device import resolve_device
from ..models import RunConfig, build, synth_batch


@dataclasses.dataclass
class ServeConfig:
    batch: int = 4
    prompt_len: int = 32
    gen_len: int = 32
    temperature: float = 0.0
    seed: int = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, scfg: ServeConfig, rc: Optional[RunConfig] = None, smoke: bool = False,
          device="cuda", params=None, tokens=None, log_fn=print):
    """Serve one batch. ``params`` (the port's tree) and ``tokens`` ((B, L)
    int) replace the weights drawn from ``scfg.seed`` and the prompt drawn
    from ``scfg.seed + 1``.

    Returns (generated tokens (B, gen_len) numpy int64, info) with info
    holding ``t_prefill_s``, ``t_decode_s``, ``tok_per_s`` and the prefill's
    ``prefill_logits`` (B, V)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
    rc = rc or RunConfig(param_dtype="float32")
    dev = resolve_device(device)
    model = build(cfg, rc, dev)
    max_seq = scfg.prompt_len + scfg.gen_len
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(scfg.seed))
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(scfg.seed + 1)
        tokens = synth_batch(model, gen, scfg.prompt_len, scfg.batch)["tokens"]
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
    tokens = tokens.to(dev).long()
    if tuple(tokens.shape) != (scfg.batch, scfg.prompt_len):
        raise ValueError(f"tokens {tuple(tokens.shape)} do not match "
                         f"(batch, prompt_len) = ({scfg.batch}, {scfg.prompt_len})")
    sampler = torch.Generator(device=dev).manual_seed(scfg.seed + 2)

    def sample(logits):
        if scfg.temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)[:, 0]

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, max_seq)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        first_logits = logits
        toks = [sample(logits)]
        t0 = time.perf_counter()
        for i in range(scfg.gen_len - 1):
            logits, cache = model.decode_step(params, toks[-1], cache, scfg.prompt_len + i)
            toks.append(sample(logits))
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen = torch.stack(toks, dim=1).cpu().numpy().astype(np.int64)
    tok_s = scfg.batch * (scfg.gen_len - 1) / max(t_decode, 1e-9)
    log_fn(f"prefill {scfg.batch}x{scfg.prompt_len} in {t_prefill * 1e3:.1f} ms; "
           f"decode {scfg.gen_len - 1} steps @ {tok_s:.1f} tok/s ({dev})")
    return gen, {"t_prefill_s": t_prefill, "t_decode_s": t_decode, "tok_per_s": tok_s,
                 "prefill_logits": first_logits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="LM serving driver of the PyTorch/CUDA port. For simulation serving "
                    "use `python -m repro_torch.serve --demo` (repro_torch.serve).")
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS),
                    help="run the LM driver for this arch; without it, forwards to "
                         "repro_torch.serve")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, rest = ap.parse_known_args(argv)
    if args.arch is None:
        # the simulation-serving entry point lives in repro_torch.serve
        from ..serve.__main__ import main as serve_main

        return serve_main((rest or ["--demo"]) + ["--device", args.device])
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    gen, _ = serve(args.arch, ServeConfig(batch=args.batch, prompt_len=args.prompt_len,
                                          gen_len=args.gen_len,
                                          temperature=args.temperature),
                   smoke=args.smoke, device=args.device)
    print("generated", gen.shape, "first row:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
