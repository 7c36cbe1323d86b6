#!/usr/bin/env python3
"""How far the data-axis training leg of ``chip_smoke.py``'s tp train phase
may drift from one rank by the order of its float32 sums alone, and whether
a step from the same state agrees.

    python3 tools/dp_step_witness.py [--seeds 0 1 2] [--out FILE]
    python3 tools/dp_step_witness.py --small --seeds 0   # a dry run on the CPU

On one CUDA card, full-width, full-depth internlm2-1.8b at float32 trains
``chip_smoke.TPT_STEPS`` steps of (``TPT_BATCH``, ``TPT_SEQ``) tokens, as
the tp train phase does, for each seed:

1. on one rank, the reference (seed 0 is the phase's own leg);
2. on layouts that change only the order of the float32 sums: one rank with
   the batch as 2 microbatches, and gloo ranks of the card as (data 2,
   model 1), (data 1, model 2) and (data 2, model 2).

For each it prints each step's ``loss``, ``ce``, ``grad_norm`` and ``lr``
as a share of the limit ``chip_smoke.PARAM_TOL`` sets against the one
rank's, the final parameters' distance from the one rank's (each rank its
cut, each piece counted once) and whether the copies of every leaf that
several ranks hold are equal. For the first seed also:

3. the same state: the one rank's state after step ``TPT_SAVE_AFTER``,
   checkpointed (``checkpoint.save``) and restored onto (data 2, model 2)
   (``reshard_restore``), takes the last step on the grid: its metrics
   against the one rank's last step, its parameters against the one rank's
   final tree;
4. two faults planted on (data 2, model 2) from step 2 on, each a step of
   FSDP done wrong: ``unsummed_replicated``, the gradients of the leaves
   ``"data"`` leaves whole not summed over ``"data"`` (``reduce_grads``
   skipped); ``unsummed_shards``, the backward's reduce-scatter replaced by
   the rank's own slice of its own gradient.

Every reading goes to ``--out`` as JSON. ``--small`` runs the smoke config
at (2, 32) tokens on the CPU, to try the script.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

GRIDS = {"d2m1": (1, 2, 1), "d1m2": (1, 1, 2), "d2m2": (1, 2, 2)}
FAULTS = ("unsummed_replicated", "unsummed_shards")
KEYS = ("loss", "ce", "grad_norm", "lr")


def train_cfg(small: bool):
    """The tp train phase's internlm2-1.8b config (``chip_smoke.tpt_train_cfg``),
    or its smoke config at float32 under ``reference``."""
    if not small:
        return cs.tpt_train_cfg()
    from repro_torch.configs import get_config, with_kernel_impls
    return with_kernel_impls(dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                                                 dtype="float32"), "reference")


def batch_shape(small: bool) -> tuple:
    return (cs.TPT_BATCH, 32) if small else (cs.TPT_BATCH, cs.TPT_SEQ)


def plant(fault: str):
    """Make this process's train step wrong from now on, as ``fault`` names."""
    from repro_torch.distributed import data_parallel as DP
    from repro_torch.training import train_step as TS
    if fault == "unsummed_replicated":
        TS.reduce_grads = lambda grads, cfg, tp: grads
    elif fault == "unsummed_shards":
        DP.reduce_scatter = lambda x, axis, group, backward=False: \
            x.chunk(group.size, dim=axis)[group.rank].contiguous()
    else:
        raise ValueError(f"unknown fault {fault!r}")


def train(seed: int, device, tp, small: bool, n_mb: int = 1, fault: str = None,
          save_dir: str = None) -> tuple:
    """(each step's metrics, the final parameters): ``TPT_STEPS`` steps from
    the seeded ``init_params`` on the seeded ``DataPipeline``'s batches, as
    ``chip_smoke.tpt_train_leg`` takes them; ``fault`` planted before step
    2; the state checkpointed to ``save_dir`` after step
    ``TPT_SAVE_AFTER``."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg = train_cfg(small)
    gen = torch.Generator(device=torch.device(device).type).manual_seed(seed)
    params = M.init_params(cfg, gen, device, tp=tp)
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptimizerConfig(**cs.TPT_OPT), n_mb, tp)
    pipe = DataPipeline(cfg, *batch_shape(small), seed=seed)
    metrics = []
    for i in range(cs.TPT_STEPS):
        if fault is not None and i == 1:
            plant(fault)
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.next_batch().items()}
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if save_dir is not None and i + 1 == cs.TPT_SAVE_AFTER:
            ckpt.save({"params": params, "opt": opt}, save_dir, i + 1,
                      extra={"pipeline": pipe.state_dict()}, tp=tp, cfg=cfg)
    del opt
    return metrics, params


def against(params, ref: str, cfg, tp) -> dict:
    """{leaf path: ``chip_smoke.params_diff_stats``} of this rank's
    parameters against its cut of the tree at ``ref`` (memory-mapped)."""
    from repro_torch.distributed.sharding import local_shard, map_with_names

    whole = torch.load(ref, mmap=True, weights_only=True)
    stats = {}

    def one(names, p):
        want = cs._at_path(whole, names)
        if tp is not None:
            want = local_shard(want, names, cfg, tp)
        stats["/".join(names)] = cs.params_diff_stats([(p, want.to(p.device))])
    map_with_names(one, params)
    return stats


def rank_readings(tp, params, ref: str, cfg) -> dict:
    """A rank's parameters against ``ref`` and its copies of shared leaves
    against the other holders'."""
    out = {"params": against(params, ref, cfg, tp)}
    out["shared_leaves"], out["unequal"] = cs.dpt_shared_unequal(params, cfg, tp)
    return out


def grid_rank(world, seed: int, dims: tuple, small: bool, fault, ref: str) -> dict:
    """One rank of a grid of ``dims`` (spawn_tp): it trains and compares."""
    from repro_torch.distributed.data_parallel import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    grid = make_grid(world, dims[1], dims[2], dims[0])
    metrics, params = train(seed, grid.device, grid, small, fault=fault)
    return {"metrics": metrics, **rank_readings(grid, params, ref, train_cfg(small))}


def restore_rank(world, seed: int, dims: tuple, small: bool, d: str, ref: str) -> dict:
    """One rank of a grid of ``dims`` (spawn_tp): the checkpoint at ``d``
    restored onto the grid's mesh takes the last step."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.data_parallel import make_grid
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import group_mesh
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_cfg(small)
    grid = make_grid(world, dims[1], dims[2], dims[0])
    meta = M.params_meta(cfg)
    t = time.perf_counter()
    state, manifest = reshard_restore(cfg, {"params": meta, "opt": init_opt_state(meta)}, d,
                                      group_mesh(grid))
    restore_s = time.perf_counter() - t
    pipe = DataPipeline(cfg, *batch_shape(small), seed=seed)
    pipe.load_state_dict(manifest["extra"]["pipeline"])
    batch = {k: torch.from_numpy(v).to(grid.device) for k, v in pipe.next_batch().items()}
    step = make_train_step(cfg, OptimizerConfig(**cs.TPT_OPT), 1, grid)
    params, _, m = step(state["params"], state["opt"], batch)
    return {"metrics": [{k: float(v) for k, v in m.items()}], "restore_s": restore_s,
            **rank_readings(grid, params, ref, cfg)}


def shares(got: list, want: list, first: int = 1, keys=KEYS) -> dict:
    """{"step i key": |got - want| over ``PARAM_TOL``'s limit at want}, the
    steps counted from ``first``."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            out[f"step {i + first} {k}"] = abs(g[k] - w[k]) / (
                cs.PARAM_TOL[0] + cs.PARAM_TOL[1] * abs(w[k]))
    return out


def summary(ranks: list, dims: tuple, cfg, want: list, first: int = 1) -> dict:
    """A grid leg's readings from its ranks': the metric shares (the
    largest over the ranks), the parameters' distance with each piece
    counted once (``holder_key``), the leaves unequal across holders."""
    from repro_torch.distributed.data_parallel import holder_key

    sh = {}
    for r in ranks:
        for k, v in shares(r["metrics"], want, first).items():
            sh[k] = max(sh.get(k, 0.0), v)
    stats = {"max_abs": 0.0, "beyond": 0, "elements": 0}
    for path in ranks[0]["params"]:
        seen = set()
        for rank, r in enumerate(ranks):
            key = holder_key(path.split("/"), cfg, dims, rank)
            st = r["params"][path]
            stats["max_abs"] = max(stats["max_abs"], st["max_abs"])
            if key not in seen:
                seen.add(key)
                stats["beyond"] += st["beyond"]
                stats["elements"] += st["elements"]
    return {"metrics": ranks[0]["metrics"], "shares": sh, "params": stats,
            "unequal": sorted({u for r in ranks for u in r["unequal"]}),
            "shared_leaves": ranks[0]["shared_leaves"],
            **({"restore_s": [r["restore_s"] for r in ranks]} if "restore_s" in ranks[0]
               else {})}


def report(tag: str, leg: dict, out: dict) -> None:
    out[tag] = leg
    st = leg["params"]
    print(f"{tag}: shares of the PARAM_TOL limit "
          + ", ".join(f"{k} {v:.4f}" for k, v in leg["shares"].items())
          + f"; parameters {st['max_abs']:.4e} apart, {st['beyond']} of {st['elements']} "
          f"beyond PARAM_TOL ({st['beyond'] / max(st['elements'], 1):.3e})"
          + (f"; leaves unequal across holders {leg['unequal']}" if "unequal" in leg else ""),
          flush=True)


def free_memory(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    from repro_torch.distributed.tensor_parallel import spawn_tp
    from repro_torch.models import model as M

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "results" / "dp_step_witness.json"))
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.small else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("dp_step_witness: no CUDA card", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    spawn_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    cfg = train_cfg(args.small)
    n = sum(int(np.prod(s.shape)) for s in M.tree_leaves(M.param_specs(cfg)))
    print(f"internlm2-1.8b{' smoke' if args.small else ''}: {cfg.n_layers} layers, {n} "
          f"parameters, float32, {cs.TPT_STEPS} steps of {batch_shape(args.small)}, "
          f"{cs.TPT_OPT}, seeds {args.seeds}", flush=True)
    readings = {"config": {"layers": cfg.n_layers, "parameters": n, "steps": cs.TPT_STEPS,
                           "batch": batch_shape(args.small), "opt": cs.TPT_OPT}}
    t0 = time.perf_counter()
    for k, seed in enumerate(args.seeds):
        d = tempfile.mkdtemp(prefix="dp_step_witness_")
        try:
            out = readings[f"seed {seed}"] = {}
            ref = os.path.join(d, "one_rank.pt")
            # the same-state leg's checkpoint holds the parameters and both moments
            free = shutil.disk_usage(d).free
            first = k == 0 and free >= 1.2 * 4 * n * 4
            if k == 0 and not first:
                print(f"seed {seed}: {free} bytes free, too few for the same-state leg's "
                      f"checkpoint; that leg and the faults are left out", flush=True)
            t = time.perf_counter()
            one, params = train(seed, dev, None, args.small,
                                save_dir=os.path.join(d, "ckpt") if first else None)
            torch.save(M.tree_map(lambda x: x.cpu(), params), ref)
            del params
            free_memory(dev)
            out["one"] = {"metrics": one, "wall_s": time.perf_counter() - t}
            print(f"seed {seed} one rank: " + "; ".join(
                f"step {i + 1} " + ", ".join(f"{key} {m[key]!r}" for key in KEYS)
                for i, m in enumerate(one)), flush=True)
            t = time.perf_counter()
            mb, params = train(seed, dev, None, args.small, n_mb=2)
            stats = against(params, ref, cfg, None)
            del params
            free_memory(dev)
            # the microbatches' ce is the last one's (repro's scan), not the batch's
            report(f"seed {seed} one rank, 2 microbatches", {
                "metrics": mb, "shares": shares(mb, one, keys=("loss", "grad_norm", "lr")),
                "wall_s": time.perf_counter() - t,
                "params": {"max_abs": max(s["max_abs"] for s in stats.values()),
                           "beyond": sum(s["beyond"] for s in stats.values()),
                           "elements": sum(s["elements"] for s in stats.values())}}, out)
            legs = [(name, dims, None) for name, dims in GRIDS.items()]
            legs += [(f"d2m2 {f}", GRIDS["d2m2"], f) for f in FAULTS] if first else []
            for name, dims, fault in legs:
                t = time.perf_counter()
                ranks = spawn_tp(grid_rank, int(np.prod(dims)), device=spawn_dev,
                                 args=(seed, dims, args.small, fault, ref),
                                 timeout=900)
                leg = summary(ranks, dims, cfg, one)
                leg["wall_s"] = time.perf_counter() - t
                report(f"seed {seed} {name}", leg, out)
            if first:
                t = time.perf_counter()
                ranks = spawn_tp(restore_rank, 4, device=spawn_dev,
                                 args=(seed, GRIDS["d2m2"], args.small, os.path.join(d, "ckpt"),
                                       ref), timeout=900)
                leg = summary(ranks, GRIDS["d2m2"], cfg, one[cs.TPT_SAVE_AFTER:],
                              cs.TPT_SAVE_AFTER + 1)
                leg["wall_s"] = time.perf_counter() - t
                report(f"seed {seed} d2m2 from one rank's state after step "
                       f"{cs.TPT_SAVE_AFTER}", leg, out)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(readings, indent=1))
    print(f"dp_step_witness: {time.perf_counter() - t0:.2f} s; readings in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
