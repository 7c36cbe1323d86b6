"""Dry run of every (architecture x input shape) cell on the production
meshes, on torch's ``meta`` device — the port of ``repro.launch.dryrun``.

``repro`` lowers and compiles each cell with XLA over 256 or 512
placeholder host devices and reads XLA's cost and memory analyses. The port
runs the cell's real step (train step forward and backward with its AdamW
update, prefill, or one decode step) at full size on ``meta`` tensors:
every op computes shapes and dtypes and allocates nothing, so the FULL
configs run on any host. What it records, and where it comes from:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over every aten op
  of the step;
- bytes: the sum of each aten op's operand and result bytes (a view moves
  nothing and is skipped; a result that aliases an operand, as an in-place
  op's does, is not counted twice). This is an UNFUSED count: every
  intermediate goes to memory and back, where a fused program would keep
  some on chip. The record says so (``"bytes_count": "unfused"``);
- per-device FLOPs and bytes: the global counts divided by the chips
  (``"partition": "even"``); torch has no GSPMD to ask how a sharded
  program splits;
- ``argument_bytes_per_dev`` / ``output_bytes_per_dev``: the shard shapes
  of the parameters (``param_specs``), the optimizer state, the inputs
  (``input_shardings``) and the decode cache (``cache_specs``) over the
  mesh, with their breakdown; ``alias_bytes_per_dev`` the donated ones, as
  ``repro`` donates them; ``temp_bytes_per_dev`` is None, since ``meta``
  has no allocator to ask;
- ``coll``: ``{}`` — no HLO, no collectives to parse (``launch/roofline.py``).

A Python loop over the layers runs, and is counted, layer by layer, so the
full-depth count is exact. ``repro``'s depth probes (two reduced-depth
twins, extrapolated linearly in depth) are kept and recorded beside it; for
a depth-linear stack the extrapolation equals the full count.

``meta`` is the dry run's device by design, as placeholder host devices
are ``repro``'s; it is the only place the port uses it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, cell_is_runnable
from repro_torch.distributed.sharding import (AbstractMesh, batch_spec, cache_specs,
                                              param_specs)
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell, with
    ``repro``'s shapes and dtypes (no storage)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.frontend == "audio":
            batch["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        elif cfg.frontend == "vision":
            batch["vision_embeds"] = _meta((b, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
            batch["tokens"] = _meta((b, s - cfg.frontend_seq), i32)
        else:
            batch["tokens"] = _meta((b, s), i32)
        if shape.kind == "train":
            if cfg.frontend == "vision":
                batch["labels"] = _meta((b, s - cfg.frontend_seq), i32)
            else:
                batch["labels"] = _meta((b, s), i32)
        return batch
    # decode: one new token against an s-token cache
    return {
        "token": _meta((b, 1), i32),
        "cache": M.cache_spec(cfg, b, s),
        "pos": _meta((), i32),
    }


def _params_shape(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors, straight from the
    ``ParamSpec`` tree (the counterpart of ``jax.eval_shape(init_params)``;
    ``init_params`` itself draws on a real device)."""
    pd = cfg.param_torch_dtype
    return M._map_specs(lambda spec: _meta(spec.shape, pd), M.param_specs(cfg))


def _shard_bytes(t: torch.Tensor, spec, mesh: AbstractMesh) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` on ``mesh``."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    n = 1
    for i, dim in enumerate(t.shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        div = int(np.prod([sizes[a] for a in axes])) if axes else 1
        n *= -(-int(dim) // div)
    return n * t.element_size()


def _tree_shard_bytes(tree, specs, mesh: AbstractMesh) -> int:
    if isinstance(tree, dict):
        return sum(_tree_shard_bytes(tree[k], specs[k], mesh) for k in tree)
    return _shard_bytes(tree, specs, mesh)


def _batch_bytes(tree, mesh: AbstractMesh) -> int:
    """Per-device bytes of inputs sharded on their leading dim
    (``input_shardings``)."""
    if isinstance(tree, dict):
        return sum(_batch_bytes(v, mesh) for v in tree.values())
    if tree.dim() == 0:
        return tree.element_size()
    return _shard_bytes(tree, batch_spec(tree.shape[0], mesh, extra_dims=tree.dim() - 1),
                        mesh)


def _build(cfg: ModelConfig, shape: ShapeConfig, mesh: AbstractMesh):
    """Returns (fn, args, memory) for the cell: the step, its ``meta``
    arguments, and the per-device argument, output and donated bytes over
    ``mesh`` (with the arguments' breakdown)."""
    params = _params_shape(cfg)
    p_bytes = _tree_shard_bytes(params, param_specs(params, cfg, mesh), mesh)
    v = cfg.vocab_padded
    if shape.kind == "train":
        opt = init_opt_state(params)
        batch = input_specs(cfg, shape)
        o_bytes = 2 * p_bytes + opt["step"].element_size()
        b_bytes = _batch_bytes(batch, mesh)
        fn = make_train_step(cfg, OptimizerConfig())
        parts = {"params": p_bytes, "opt": o_bytes, "batch": b_bytes}
        out = p_bytes + o_bytes + 5 * 4   # the trees back, and 5 scalar metrics
        return fn, (params, opt, batch), dict(parts=parts, out=out, alias=p_bytes + o_bytes)
    logits = _meta((shape.global_batch, v), torch.float32)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        b_bytes = _batch_bytes(batch, mesh)
        fn = functools.partial(M.prefill, cfg=cfg)
        cache = M.cache_spec(cfg, shape.global_batch, shape.seq_len)
        c_bytes = _tree_shard_bytes(cache, cache_specs(cache, cfg, mesh, shape.global_batch,
                                                       seq_shard=cfg.shard_activations), mesh)
        parts = {"params": p_bytes, "batch": b_bytes}
        return fn, (params, batch), dict(parts=parts, out=_batch_bytes(logits, mesh) + c_bytes,
                                         alias=0)
    specs = input_specs(cfg, shape)
    c_bytes = _tree_shard_bytes(specs["cache"], cache_specs(
        specs["cache"], cfg, mesh, shape.global_batch, seq_shard=cfg.shard_activations), mesh)
    parts = {"params": p_bytes, "token": _batch_bytes(specs["token"], mesh),
             "cache": c_bytes, "pos": specs["pos"].element_size()}
    fn = functools.partial(M.decode_step, cfg=cfg)
    args = (params, specs["token"], specs["cache"], specs["pos"])
    return fn, args, dict(parts=parts, out=_batch_bytes(logits, mesh) + c_bytes, alias=c_bytes)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of each aten op's tensor operands and results; views
    are skipped, and a result aliasing an operand counts once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        self.ops += 1
        ins, _ = tree_flatten((args, kwargs or {}))
        n = sum(t.numel() * t.element_size() for t in ins if isinstance(t, torch.Tensor))
        outs, _ = tree_flatten(out)
        rets = func._schema.returns
        for i, t in enumerate(outs):
            aliased = i < len(rets) and rets[i].alias_info is not None
            if isinstance(t, torch.Tensor) and not aliased:
                n += t.numel() * t.element_size()
        self.bytes += n
        return out


def _metrics(fn, args) -> Tuple[float, float, int]:
    """(FLOPs, unfused bytes, aten ops) of one call of ``fn`` on ``args``."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with flops, counter:
        fn(*args)
    return float(flops.get_total_flops()), float(counter.bytes), counter.ops


def _probe_depths(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(depth_a, depth_b, units_a, n_units) in n_layers terms: ``repro``'s
    probes of 2 and 3 segment units; extrapolation
    total = f_a + (n_units - units_a) * (f_b - f_a)."""
    if cfg.family == "hybrid":
        return (2 * cfg.attn_every, 3 * cfg.attn_every, 2,
                cfg.n_layers // cfg.attn_every)
    if cfg.family == "moe" and cfg.first_dense_layers:
        fd = cfg.first_dense_layers
        return fd + 2, fd + 3, 2, cfg.n_layers - fd
    return 2, 3, 2, cfg.n_layers


def _cell_config(arch: str, shape: ShapeConfig, remat=None, moe_impl=None,
                 shard_activations: bool = False, param_dtype=None, ssm_chunk=None):
    """(cfg, overrides) of a cell, by ``repro``'s rules: train cells remat
    with ``dots_saveable`` unless told otherwise."""
    cfg = get_config(arch)
    overrides: Dict[str, Any] = {}
    if shape.kind == "train":
        overrides["remat"] = remat if remat is not None else "dots_saveable"
    elif remat is not None:
        overrides["remat"] = remat
    if moe_impl is not None:
        overrides["moe_impl"] = moe_impl
    if shard_activations:
        overrides["shard_activations"] = True
    if param_dtype is not None:
        overrides["param_dtype"] = param_dtype
    if ssm_chunk is not None and cfg.ssm_state:
        overrides["ssm_chunk"] = ssm_chunk
    return dataclasses.replace(cfg, **overrides), overrides


def run_cell(arch: str, shape_name: str, mesh: AbstractMesh, mesh_name: str,
             remat: Optional[str] = None, probes: bool = True,
             moe_impl: Optional[str] = None,
             shard_activations: bool = False,
             param_dtype: Optional[str] = None,
             ssm_chunk: Optional[int] = None) -> Dict[str, Any]:
    shape = SHAPES_BY_NAME[shape_name]
    cfg, overrides = _cell_config(arch, shape, remat, moe_impl, shard_activations,
                                  param_dtype, ssm_chunk)
    ok, why = cell_is_runnable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "overrides": overrides}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    chips = int(np.prod(mesh.axis_sizes))
    try:
        t0 = time.time()
        with mesh:
            fn, args, mem = _build(cfg, shape, mesh)
            flops, nbytes, n_ops = _metrics(fn, args)
        rec["run_s"] = round(time.time() - t0, 2)
        rec["device"] = "meta"
        rec["partition"] = "even"
        rec["bytes_count"] = "unfused"
        rec["aten_ops"] = n_ops
        rec["memory_analysis"] = {
            "argument_bytes_per_dev": sum(mem["parts"].values()),
            "argument_breakdown_per_dev": mem["parts"],
            "output_bytes_per_dev": mem["out"],
            "temp_bytes_per_dev": None,   # meta has no allocator
            "alias_bytes_per_dev": mem["alias"],
        }
        rec["full_depth"] = {"flops": flops, "bytes": nbytes}
        if probes:
            d1, d2, units_a, n_units = _probe_depths(cfg)
            probe_metrics = []
            for d in (d1, d2):
                pcfg = dataclasses.replace(cfg, n_layers=d, unroll=True)
                t1 = time.time()
                with mesh:
                    pfn, pargs, _ = _build(pcfg, shape, mesh)
                    f, by, _ = _metrics(pfn, pargs)
                probe_metrics.append((f, by, round(time.time() - t1, 2)))
            (f1, b1, t_1), (f2, b2, t_2) = probe_metrics
            extra = n_units - units_a
            rec["probes"] = {"depths": [d1, d2], "flops": f1 + extra * (f2 - f1),
                             "bytes": b1 + extra * (b2 - b1), "run_s": [t_1, t_2]}
        coll: Dict[str, int] = {}
        rec["coll"] = coll
        terms = RL.build_terms(flops / chips, nbytes / chips, coll, chips, cfg, shape)
        rec["roofline"] = terms.row()
        rec["status"] = "ok"
    except Exception as e:  # a failure here is a fault of the port on meta
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--shard-activations", action="store_true")
    ap.add_argument("--param-dtype", default=None,
                    help="override param dtype (e.g. bfloat16 for serving)")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "dryrun.json":
        ap.error(f"--out {args.out}: that name belongs to the reference dry run's results")

    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES_BY_NAME)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], json.dumps(r.get("overrides", {}), sort_keys=True))
            for r in existing}

    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_name = "multi" if multi else "single"
        for arch in archs:
            for shape_name in shapes:
                _, key_overrides = _cell_config(
                    arch, SHAPES_BY_NAME[shape_name], args.remat, args.moe_impl,
                    args.shard_activations, args.param_dtype, args.ssm_chunk)
                key = (arch, shape_name, mesh_name, json.dumps(key_overrides, sort_keys=True))
                if key in done:
                    continue
                print(f"=== {arch} x {shape_name} x {mesh_name} ===", flush=True)
                rec = run_cell(arch, shape_name, mesh, mesh_name,
                               remat=args.remat, probes=not args.no_probes,
                               moe_impl=args.moe_impl,
                               shard_activations=args.shard_activations,
                               param_dtype=args.param_dtype,
                               ssm_chunk=args.ssm_chunk)
                status = rec["status"]
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" run={rec.get('run_s')}s")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                else:
                    extra = " " + rec["reason"]
                print(f"  -> {status}{extra}", flush=True)
                existing.append(rec)
                with open(args.out, "w") as f:
                    json.dump(existing, f, indent=1)
    print(f"wrote {args.out} ({len(existing)} records)")


if __name__ == "__main__":
    main()
