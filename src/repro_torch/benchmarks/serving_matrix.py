"""Serving matrix of the port: every architecture of ``ARCHS`` x
{reference, kernel} through ``ContinuousEngine``, holding the kernel leg's
temperature-0 tokens equal to the reference leg's and reporting tok/s for
both legs.

Each matrix point serves ``n_requests`` prompts to completion through a
fresh engine, once with ``kernel_impls="reference"`` (the plain paths) and
once with ``kernel_impls="auto"`` (every site the arch supports on the
port's CUDA kernels; on the CPU their plain versions). Both legs run at
float32, the regime in which the greedy picks of the two legs agree. Each
leg records the kernels' launches its timed serve made (read from
``kernels.ops.launch_counts`` before and after; the counters are not reset).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_matrix \\
        [--device cpu] [--smoke] [--archs A,B,...] [--assert-equal] \\
        [--assert-archs N] [--out PATH]

The twin of ``benchmarks/serving_matrix.py``. It writes
``results/BENCH_torch_serving_matrix[_smoke].json`` by default and refuses
the reference's result files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, supported_kernel_sites, with_kernel_impls
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.model import init_params
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine

# arch -> headline mechanism exercised (doc only; sites come from the config)
ARCHS = {
    "qwen2.5-3b": "gqa",
    "mixtral-8x22b": "moe+swa",
    "deepseek-v2-lite-16b": "mla+moe",
    "mamba2-2.7b": "ssm",
    "zamba2-2.7b": "hybrid",
}
SMOKE_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-2.7b")


def _serve(cfg, params, prompts, n_new, n_slots, max_seq, device):
    """One fresh engine, one serve() call; returns (wall_s, per-req tokens,
    the kernels' launches of the timed serve)."""
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq, device=device)
    reqs = [GenRequest(id=i, prompt=list(p), max_new=n_new) for i, p in enumerate(prompts)]
    # warm-up on a single request (kernel builds, allocator) outside the timing
    engine.serve([GenRequest(id=-1, prompt=list(prompts[0]), max_new=2)])
    engine.batcher.finished.clear()
    before = launch_counts()
    t0 = time.perf_counter()
    engine.serve(reqs)      # each step ends in a host copy of the picked tokens
    wall = time.perf_counter() - t0
    counts = {k: n - before[k] for k, n in launch_counts().items()}
    done = {f.id: list(f.generated) for f in engine.batcher.finished}
    return wall, [done[i] for i in range(len(prompts))], counts


def bench_serving_matrix(archs=None, slots_grid=(2, 4), prompt_len: int = 12,
                         n_new: int = 8, requests_per_slot: int = 2, device=None):
    """Returns (rows, detail) in the shape of ``benchmarks.run``'s entries;
    ``device`` ``None`` is the card."""
    dev = resolve_device(device)
    archs = list(archs or ARCHS)
    rows, per_arch = [], {}
    all_equal = True
    for arch in archs:
        # float32 is the regime in which the two legs' greedy picks agree
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        sites = tuple(sorted(supported_kernel_sites(cfg)))
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.default_rng(0)
        points = []
        for n_slots in slots_grid:
            n_requests = n_slots * requests_per_slot
            max_seq = prompt_len + n_new + 8
            prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
                       for _ in range(n_requests)]
            n_tok = n_requests * n_new
            point = {"n_slots": n_slots, "n_requests": n_requests,
                     "prompt_len": prompt_len, "n_new": n_new}
            outs = {}
            for leg in ("reference", "kernel"):
                leg_cfg = with_kernel_impls(cfg, "auto" if leg == "kernel" else "reference")
                wall, outs[leg], counts = _serve(leg_cfg, params, prompts, n_new,
                                                 n_slots, max_seq, dev)
                point[leg] = {"wall_s": wall, "tok_s": n_tok / wall, "launches": counts}
            point["tokens_equal"] = outs["reference"] == outs["kernel"]
            point["kernel_vs_reference"] = (point["kernel"]["tok_s"]
                                            / point["reference"]["tok_s"])
            all_equal = all_equal and point["tokens_equal"]
            points.append(point)
            rows.append((f"serving_matrix_{arch}_s{n_slots}",
                         point["kernel"]["wall_s"] / n_tok * 1e6,
                         f"ref_tok_s={point['reference']['tok_s']:.1f};"
                         f"kernel_tok_s={point['kernel']['tok_s']:.1f};"
                         f"tokens_equal={point['tokens_equal']}"))
        per_arch[arch] = {"mechanism": ARCHS.get(arch, "?"),
                          "kernel_sites": sites, "points": points}
        del params
    detail = {"config": {"archs": archs, "slots_grid": list(slots_grid),
                         "prompt_len": prompt_len, "n_new": n_new,
                         "dtype": "float32"},
              "device": {"type": dev.type,
                         "name": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu")},
              "archs": per_arch, "n_archs": len(archs),
              "all_tokens_equal": all_equal}
    rows.append(("serving_matrix_summary", 0.0,
                 f"archs={len(archs)};all_tokens_equal={all_equal}"))
    return rows, {"serving_matrix": detail}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="3 archs, one slot count (CI-speed)")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch subset (default: full zoo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--assert-equal", action="store_true",
                    help="exit nonzero unless every kernel leg emitted tokens "
                         "equal to its reference leg's")
    ap.add_argument("--assert-archs", type=int, default=None,
                    help="exit nonzero unless >= N architectures ran")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.archs:
        archs = [a.strip() for a in args.archs.split(",") if a.strip()]
        for a in archs:
            if a not in ARCHS:
                ap.error(f"unknown arch {a!r}; available: {', '.join(ARCHS)}")
    else:
        archs = list(SMOKE_ARCHS) if args.smoke else list(ARCHS)
    out = args.out or os.path.join(
        "results", "BENCH_torch_serving_matrix_smoke.json" if args.smoke
        else "BENCH_torch_serving_matrix.json")
    if os.path.basename(out).startswith("BENCH_serving_matrix"):
        ap.error(f"--out {out}: that name belongs to the reference benchmark's results")
    slots_grid = (2,) if args.smoke else (2, 4)
    rows, detail = bench_serving_matrix(archs=archs, slots_grid=slots_grid,
                                        device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(detail, f, indent=1)
    sys.stderr.write(f"wrote {out}\n")

    d = detail["serving_matrix"]
    if args.assert_equal and not d["all_tokens_equal"]:
        bad = [(a, p["n_slots"]) for a, rec in d["archs"].items()
               for p in rec["points"] if not p["tokens_equal"]]
        sys.stderr.write(f"FAIL: kernel tokens != reference tokens at {bad}\n")
        sys.exit(1)
    if args.assert_archs is not None and d["n_archs"] < args.assert_archs:
        sys.stderr.write(f"FAIL: only {d['n_archs']} archs ran "
                         f"< {args.assert_archs}\n")
        sys.exit(1)
    return detail


if __name__ == "__main__":
    main()
