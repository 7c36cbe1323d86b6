"""Train a small LM with checkpointing and a simulated failure + restart
mid-run — the twin of ``examples/train_lm.py`` on the port.

    PYTHONPATH=src python -m repro_torch.launch.train_lm                # card
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --steps 40
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.launch.train import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        tc = TrainConfig(arch=args.arch, smoke=True, steps=args.steps,
                         global_batch=8, seq_len=128, n_microbatches=2,
                         ckpt_dir=ckpt_dir, ckpt_every=max(args.steps // 4, 1),
                         log_every=max(args.steps // 15, 1), lr=2e-3)
        print(f"== phase 1: train to ~{args.steps//2} steps, then 'fail' ==")
        _, _, hist1 = train(dataclasses.replace(tc, steps=args.steps // 2), device=args.device)

        print("\n== phase 2: restart from the latest checkpoint (fault tolerance) ==")
        _, _, hist2 = train(tc, device=args.device)  # resumes from ckpt_dir
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, last = hist1[0][1], hist2[-1][1]
    print(f"\nloss {first:.4f} -> {last:.4f} across a simulated failure "
          f"({'OK' if last < first else 'WARN: no improvement'})")
    return first, last


if __name__ == "__main__":
    main()
