"""End-to-end LM training: mamba2-130m (its published ~130M-parameter
config) on the synthetic token stream, with checkpointing and resume. The
twin of the reference's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300      # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --quick --steps 20 \\
        --device cpu                                                        # reduced, CPU

On the card every Mamba2 layer runs the conv1d and SSD kernels forward and
their hand-written backward kernels. Exits non-zero unless the loss
decreased.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import TrainLoopConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--quick", action="store_true", help="the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"),
                    help='where to checkpoint ("" for nowhere)')
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    loop = TrainLoopConfig(steps=args.steps, seq_len=args.seq_len,
                           global_batch=args.global_batch, ckpt_dir=args.ckpt_dir or None,
                           resume=args.resume, ckpt_every=max(args.steps // 4, 10),
                           log_every=5)
    _, _, hist = train("mamba2-130m", loop, smoke=args.quick, device=args.device)
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    if not hist[-1] < hist[0]:
        print("the loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
