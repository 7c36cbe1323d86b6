"""End-to-end training loop: data pipeline -> train step -> metrics ->
checkpoint/restart — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train                      # card, smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 12    # card, full width

Under a tensor-parallel group or a grid (``train(tc, tp=group)``, every
rank of a ``torch.distributed`` group calling it; see
``distributed.tensor_parallel.spawn_tp`` and
``distributed.data_parallel.make_grid``) each rank draws only its shards
(``init_params(..., tp=)``), reads the whole batch from its own pipeline
(the train step takes the rank's rows of it under a grid), runs the split
train step, checkpoints the whole arrays with the group (rank 0 writes)
and resumes onto the group's mesh (``sharding.group_mesh``: the grid's
shape) through ``distributed.elastic.reshard_restore``; rank 0 logs.

Fault tolerance: checkpoints every ``ckpt_every`` steps (async), resumes
from the latest committed step, and, because the data pipeline is
stateless given (seed, step), a restart replays the exact batch sequence:
on the CPU a resumed run ends with the bits of an unbroken one. Parameters
come from the port's seeded ``init_params`` (JAX's random stream cannot be
replayed), and the model runs ``kernel_impls="reference"``: the kernels
have no backward.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.elastic import reshard_restore
from repro_torch.distributed.sharding import group_mesh
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    arch: str = "internlm2-1.8b"
    smoke: bool = True
    steps: int = 200
    global_batch: int = 8
    seq_len: int = 128
    n_microbatches: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    lr: float = 1e-3


def train(tc: TrainConfig, device: DeviceLike = None, tp=None):
    """Train ``tc.steps`` steps on ``device`` (``None``: the card), resuming
    from ``tc.ckpt_dir``'s latest committed step when there is one. Returns
    (params, opt_state, history [(step, loss)] at the logged steps). Under
    a tensor-parallel group ``tp`` every rank calls it and the device is the
    rank's (``device`` is not read): params and opt_state are the rank's
    shards, and the history is the same on every rank."""
    dev = resolve_device(device) if tp is None else tp.device
    cfg = get_config(tc.arch, smoke=tc.smoke)
    opt_cfg = OptimizerConfig(lr=tc.lr, warmup_steps=max(tc.steps // 20, 1),
                              total_steps=tc.steps)
    params = M.init_params(cfg, torch.Generator(device=dev.type).manual_seed(tc.seed), dev,
                           tp=tp)
    opt_state = init_opt_state(params)
    start_step = 0
    pipe = DataPipeline(cfg, tc.global_batch, tc.seq_len, seed=tc.seed)
    lead = tp is None or tp.world.rank == 0
    if tc.ckpt_dir:
        latest = ckpt.latest_step(tc.ckpt_dir)
        if latest is not None:
            state = {"params": params, "opt": opt_state}
            if tp is None:
                state, manifest = ckpt.restore(state, tc.ckpt_dir, step=latest, device=dev)
            else:
                whole = M.params_meta(cfg)   # meta tensors: shapes and dtypes
                template = {"params": whole, "opt": init_opt_state(whole)}
                state, manifest = reshard_restore(cfg, template, tc.ckpt_dir, group_mesh(tp),
                                                  step=latest)
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            pipe.load_state_dict(manifest["extra"]["pipeline"])
            if lead:
                print(f"resumed from step {latest}")
    step_fn = make_train_step(cfg, opt_cfg, tc.n_microbatches, tp=tp)
    history = []
    t0 = time.time()
    for step in range(start_step, tc.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % tc.log_every == 0 or step + 1 == tc.steps:
            loss = float(metrics["loss"])
            history.append((step + 1, loss))
            dt = time.time() - t0
            if lead:
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt/(step+1-start_step):.2f}s/step)", flush=True)
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            ckpt.save({"params": params, "opt": opt_state}, tc.ckpt_dir,
                      step + 1, extra={"pipeline": pipe.state_dict()},
                      async_save=True, tp=tp, cfg=cfg)
    ckpt.wait_for_saves()
    return params, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (needs the card's memory)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tc = TrainConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                     global_batch=args.global_batch, seq_len=args.seq_len,
                     n_microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                     lr=args.lr)
    _, _, history = train(tc, device=args.device)
    first, last = history[0][1], history[-1][1]
    print(f"loss {first:.4f} -> {last:.4f}")


if __name__ == "__main__":
    main()
