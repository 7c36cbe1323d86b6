"""Serving CLI: stand up a continuous-batching engine and serve generate
requests — the FaaS function an HPC-Whisk invoker hosts, on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve              # card, smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --full       # card, full width
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu # CPU, smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --full

``--arch`` takes any ported arch (qwen2.5-3b, internlm2-1.8b, mixtral-8x22b,
mamba2-2.7b, zamba2-2.7b). ``--sequential`` runs the run-to-completion
baseline instead; SIGTERM drains the partial generations (the invoker
hand-off path) and exits with 143.
"""
from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token: finished slots free early")
    ap.add_argument("--sequential", action="store_true",
                    help="run-to-completion baseline instead of continuous batching")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke twin")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)
    max_seq = args.prompt_len + args.new_tokens + 8
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
               for _ in range(args.requests)]

    t0 = time.perf_counter()
    if args.sequential:
        engine = ServingEngine(cfg, params, max_seq=max_seq, device=device)
        done = []
        for i, p in enumerate(prompts):
            out = engine.generate(np.asarray([p], np.int64), args.new_tokens)
            done.append(GenRequest(id=i, prompt=p, max_new=args.new_tokens,
                                   generated=out[0].tolist(), done=True))
        occ = 1.0
    else:
        engine = ContinuousEngine(cfg, params, n_slots=args.batch_slots,
                                  max_seq=max_seq, eos_id=args.eos_id, device=device)
        # SIGTERM = invoker preemption: hand partials back for resubmit()
        signal.signal(signal.SIGTERM, lambda *_: _drain_and_exit(engine))
        for i, p in enumerate(prompts):
            engine.add(GenRequest(id=i, prompt=p, max_new=args.new_tokens))
        done = engine.run()
        occ = engine.occupancy
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    mode = "sequential" if args.sequential else \
        f"continuous x{args.batch_slots} slots (occupancy {occ:.0%})"
    width = "full" if args.full else "smoke"
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {device}, {width} {cfg.arch_id}, {mode})")


def _drain_and_exit(engine: ContinuousEngine):
    partials = engine.drain()
    print(f"SIGTERM: drained {len(partials)} in-flight requests "
          f"({sum(len(p.generated) for p in partials)} partial tokens kept "
          f"for resubmit)")
    raise SystemExit(143)


if __name__ == "__main__":
    main()
