"""LM serving driver of the port: one prefill, then ``gen_len - 1`` greedy
or temperature decode steps over a batch of prompts. The twin of
``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen-len 32] \\
        [--temperature 0] [--device cuda|cpu] [--override field=value ...]

Every arch of ``configs.ARCH_IDS`` serves. A VLM's prompt is
``n_patches`` patch embeddings then ``prompt_len - n_patches`` tokens; an
enc-dec's prompt is ``prompt_len`` decoder tokens after a source of
``source_len`` frames (both stub frontends, drawn from the seed).
``--override n_layers=8`` (repeatable) cuts a config as the reference's
``apply_overrides`` does. On ``--device cuda`` (the default) prefill runs
the hand-written CUDA kernels (attention; conv1d and SSD for the SSM and
hybrid families); ``--device cpu`` runs their plain versions. Without ``--arch`` it forwards to the simulation server's demo,
``python -m repro_torch.serve --demo`` (on ``--device``), as the
reference forwards to ``repro.serve``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Mapping, Optional

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
          device="cuda", params=None, tokens=None, extras: Optional[Mapping] = None,
          overrides: Optional[Mapping] = None, log_fn=print):
    """Serve one batch. ``overrides`` ({field: value}) cut the config with
    ``configs.apply_overrides``. ``params`` (the port's tree) and ``tokens``
    ((B, L) int) replace the weights drawn from ``scfg.seed`` and the prompt
    drawn from ``scfg.seed + 1``; with ``tokens``, ``extras`` carries a
    VLM's ``patch_embeds`` (B, n_patches, D) or an enc-dec's ``frames``
    (B, S_src, D).

    Returns (generated tokens (B, gen_len) numpy int64, info) with info
    holding ``t_prefill_s``, ``t_decode_s``, ``tok_per_s`` and the prefill's
    ``prefill_logits`` (B, V)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
    if overrides:
        cfg = configs.apply_overrides(cfg, overrides)
    rc = rc or RunConfig(param_dtype="float32")
    dev = resolve_device(device)
    model = build(cfg, rc, dev)
    max_seq = scfg.prompt_len + scfg.gen_len
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(scfg.seed))
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(scfg.seed + 1)
        batch = synth_batch(model, gen, scfg.prompt_len, scfg.batch)
    else:
        batch = prompt_batch(model, scfg, tokens, extras or {})
    sampler = torch.Generator(device=dev).manual_seed(scfg.seed + 2)

    def sample(logits):
        if scfg.temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)[:, 0]

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_seq)
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


def prompt_batch(model, scfg: ServeConfig, tokens, extras: Mapping) -> dict:
    """The prefill batch of a given prompt on the model's device, its shapes
    checked: ``tokens`` (B, L) and the family's extras."""
    cfg, dev, B = model.cfg, model.device, scfg.batch
    n_tok = scfg.prompt_len - (cfg.n_patches if cfg.family == "vlm" else 0)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
    batch = {"tokens": tokens.to(dev).long()}
    if tuple(tokens.shape) != (B, n_tok):
        raise ValueError(f"tokens {tuple(tokens.shape)} do not match (batch, tokens) = "
                         f"({B}, {n_tok})")
    need = {"vlm": {"patch_embeds": (B, cfg.n_patches, cfg.d_model)},
            "encdec": {"frames": (B, None, cfg.d_model)}}.get(cfg.family, {})
    if set(extras) != set(need):
        raise ValueError(f"{cfg.family} prompt takes extras {sorted(need)}, "
                         f"got {sorted(extras)}")
    for name, shape in need.items():
        t = extras[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        if t.ndim != 3 or any(w is not None and w != g for w, g in zip(shape, t.shape)):
            raise ValueError(f"{name} {tuple(t.shape)} does not match {shape}")
        batch[name] = t.to(dev)
    return batch


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
    ap.add_argument("--override", action="append", default=[], metavar="FIELD=VALUE",
                    help="cut the config, e.g. n_layers=8 (repeatable)")
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
                   smoke=args.smoke, device=args.device,
                   overrides=dict(o.split("=", 1) for o in args.override))
    print("generated", gen.shape, "first row:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
