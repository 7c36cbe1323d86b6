"""Quickstart of the port: the three layers of the framework in about a
minute.

1. model zoo      — instantiate any assigned arch (reduced config), run a
                    train step and a decode step
2. harvest layer  — the paper's contribution: simulate 1 hour of an HPC
                    cluster harvesting idle nodes into FaaS capacity
3. dry run        — what ``launch/dryrun.py`` does per cell: the cell's
                    inputs as ``meta`` tensors (shapes and dtypes, no
                    storage)

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] [--smoke]

The twin of ``examples/quickstart.py``; the model runs on the card unless
``--device cpu`` is given. ``--smoke`` simulates 600 s of the cluster
instead of an hour (test speed).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import input_specs
from repro_torch.models.model import init_params
from repro_torch.platform import Platform, ScenarioConfig, SchedulingSection, WorkloadSection
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="600 s of cluster time (test speed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. model zoo ==")
    print("assigned architectures:", ", ".join(ARCH_IDS))
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pipe = DataPipeline(cfg, global_batch=4, seq_len=64, seed=0)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3))
    opt = init_opt_state(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    print(f"train step: loss={loss:.3f}")

    engine = ServingEngine(cfg, params, max_seq=48, device=dev)
    out = engine.generate(np.ones((1, 8), np.int64), n_new=8)
    print(f"decode: generated tokens {out[0].tolist()}")

    print("\n== 2. harvest layer (the paper) ==")
    duration = 600.0 if args.smoke else 3600.0
    sc = ScenarioConfig(name="quickstart", duration=duration, seed=0,
                        workload=WorkloadSection(qps=5.0),
                        scheduling=SchedulingSection(model="fib"))
    res = Platform.build(sc).run()
    print(f"{duration:.0f} s of cluster time: coverage={res.slurm_coverage:.1%} "
          f"(clairvoyant bound {res.sim_upper_bound:.1%}), "
          f"invoked={res.invoked_share:.1%}, pilots started={res.n_jobs_started}, "
          f"evicted={res.n_evicted}")

    print("\n== 3. dry run (the cell's inputs on meta) ==")
    specs = input_specs(cfg, SHAPES_BY_NAME["train_4k"])
    print("train_4k input specs:",
          {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()})
    print("full dry run: PYTHONPATH=src python -m repro_torch.launch.dryrun --all")
    return {"loss": loss, "tokens": out[0].tolist(), "coverage": res.slurm_coverage,
            "specs": {k: tuple(v.shape) for k, v in specs.items()}}


if __name__ == "__main__":
    main()
