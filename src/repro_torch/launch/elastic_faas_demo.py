"""Elastic fault-tolerance demo of the port: train, checkpoint, 'lose a pod'
(shrink the mesh 2x), restore the same checkpoint onto the smaller
topology, check that the run continues in the same data order — then
compare the fib vs var harvest of the capacity freed while the cluster is
degraded.

    PYTHONPATH=src python -m repro_torch.launch.elastic_faas_demo [--device cpu] [--smoke]

The twin of ``examples/elastic_faas_demo.py``: the port's train step,
checkpoint, data pipeline and platform; the model trains on the card unless
``--device cpu`` is given. The checkpoint goes to a temporary directory,
removed at the end. ``--smoke`` trains 3 + 3 steps instead of 10 + 10 and
harvests 600 s instead of 1800 s (test speed).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, tree_map
from repro_torch.platform import (Platform, ScenarioConfig, SchedulingSection, TraceSection,
                                  WorkloadSection)
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def _batch(pipe, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="3 + 3 steps and 600 s harvests (test speed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, duration = (3, 600.0) if args.smoke else (10, 1800.0)

    cfg = get_config("stablelm-12b", smoke=True)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=60)
    step = make_train_step(cfg, opt_cfg)

    print("== phase 1: 'big mesh' run (DP=4 data order) ==")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt_state(params)
    pipe = DataPipeline(cfg, global_batch=8, seq_len=64, seed=0)
    for _ in range(n):
        params, opt, m = step(params, opt, _batch(pipe, dev))
    loss_n = float(m["loss"])
    d = tempfile.mkdtemp(prefix="elastic_")
    try:
        ckpt.save({"params": params, "opt": opt}, d, step=n,
                  extra={"pipeline": pipe.state_dict()})
        print(f"step {n} loss {loss_n:.4f} -> checkpointed")

        print("== phase 2: pod loss -> restore on the shrunken topology ==")
        template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                            {"params": params, "opt": opt})
        state, manifest = ckpt.restore(template, d, device=dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    pipe2 = DataPipeline(cfg, global_batch=8, seq_len=64, seed=0)
    pipe2.load_state_dict(manifest["extra"]["pipeline"])
    params2, opt2 = state["params"], state["opt"]
    for _ in range(n, 2 * n):
        params2, opt2, m2 = step(params2, opt2, _batch(pipe2, dev))
    loss_2n = float(m2["loss"])
    print(f"step {2 * n} loss {loss_2n:.4f} (continued across the resize; "
          "same data order by construction)")

    print("== phase 3: harvest the freed capacity while degraded ==")
    harvest = {}
    for model in ("fib", "var"):
        sc = ScenarioConfig(name=f"degraded_{model}", duration=duration, seed=1,
                            trace=TraceSection(seed=6),
                            workload=WorkloadSection(qps=2.0),
                            scheduling=SchedulingSection(model=model))
        res = Platform.build(sc).run()
        harvest[model] = res.slurm_coverage
        print(f"  {model}: coverage={res.slurm_coverage:.1%} "
              f"invoked={res.invoked_share:.1%} pilots={res.n_jobs_started}")
    print("done")
    return {"steps": 2 * n, "loss_checkpointed": loss_n, "loss_last": loss_2n,
            "coverage": harvest}


if __name__ == "__main__":
    main()
