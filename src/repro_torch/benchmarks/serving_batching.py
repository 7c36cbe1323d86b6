"""Serving-path benchmark of the port: sequential run-to-completion decode
vs the continuous-batching ``ContinuousEngine`` on the same request set
(smoke config). Reports tok/s, completion-latency p50/p95 and slot
occupancy, and verifies the two paths emit identical token streams at
temperature 0.

All requests arrive at t0; the sequential baseline serves them one
``generate`` at a time, while the continuous engine keeps ``--slots``
requests in flight per decode wave. Each path runs ``--repeats`` times and
the best wall time counts. Every timed region ends with the card
synchronised (each step already ends in a host copy of the picked tokens).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_batching \\
        [--device cpu] [--smoke] [--assert-speedup X] [--out PATH]

The twin of ``benchmarks/serving_batching.py``. It writes
``results/BENCH_torch_serving_batching[_smoke].json`` by default and
refuses the reference's result files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, with_kernel_impls
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, ServingEngine


def _percentiles(xs):
    if not xs:
        return float("nan"), float("nan")
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 95)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_sequential(engine, prompts, n_new):
    """Serve serially; per-request completion = offset in the serialized run."""
    t0 = time.perf_counter()
    lat, outs = [], []
    for p in prompts:
        out = engine.generate(np.asarray([p], np.int64), n_new)  # a host array
        _sync(engine.device)
        lat.append(time.perf_counter() - t0)
        outs.append(out[0].tolist())
    wall = time.perf_counter() - t0
    return wall, lat, outs


def _run_continuous(engine, prompts, n_new):
    """One ``engine.serve()`` call — the same timed loop the batched executor
    charges the sim from, so the numbers measure its semantics."""
    t0 = time.perf_counter()
    finished_at = engine.serve([GenRequest(id=i, prompt=list(p), max_new=n_new)
                                for i, p in enumerate(prompts)])
    _sync(engine.device)
    wall = time.perf_counter() - t0
    done = {f.id: f.generated for f in engine.batcher.finished}
    engine.batcher.finished.clear()
    lat = [finished_at[i] for i in range(len(prompts))]
    outs = [done[i] for i in range(len(prompts))]
    return wall, lat, outs


def bench_serving(n_requests: int = 16, prompt_len: int = 16, n_new: int = 16,
                  n_slots: int = 4, repeats: int = 3, arch: str = "qwen2.5-3b",
                  device=None):
    """Returns (rows, detail) in the shape of ``benchmarks.run``'s entries;
    ``device`` ``None`` is the card."""
    dev = resolve_device(device)
    cfg = with_kernel_impls(get_config(arch, smoke=True), "auto")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    max_seq = prompt_len + n_new + 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(n_requests)]
    n_tok = n_requests * n_new

    seq_engine = ServingEngine(cfg, params, max_seq=max_seq, device=dev)
    cont = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device=dev)
    # warm-up outside the timed region (kernel builds on the card, allocator)
    _run_sequential(seq_engine, prompts[:1], n_new)
    _run_continuous(cont, prompts[:n_slots], n_new)

    best = {"sequential": None, "continuous": None}
    outs_seq = outs_cont = None
    occupancy = steps = 0
    for _ in range(repeats):
        wall, lat, outs_seq = _run_sequential(seq_engine, prompts, n_new)
        if best["sequential"] is None or wall < best["sequential"][0]:
            best["sequential"] = (wall, lat)
        steps0 = cont.n_decode_steps
        slot_steps0 = cont.n_slot_steps
        wall, lat, outs_cont = _run_continuous(cont, prompts, n_new)
        if best["continuous"] is None or wall < best["continuous"][0]:
            best["continuous"] = (wall, lat)
            steps = cont.n_decode_steps - steps0
            occupancy = ((cont.n_slot_steps - slot_steps0)
                         / max(steps * n_slots, 1))
    outputs_match = outs_seq == outs_cont

    detail = {"config": {"arch": arch, "n_requests": n_requests,
                         "prompt_len": prompt_len, "n_new": n_new,
                         "n_slots": n_slots, "repeats": repeats,
                         "kernel_impls": "auto"},
              "device": {"type": dev.type,
                         "name": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu")},
              "outputs_match": outputs_match}
    rows = []
    for mode in ("sequential", "continuous"):
        wall, lat = best[mode]
        p50, p95 = _percentiles(lat)
        detail[mode] = {"wall_s": wall, "tok_s": n_tok / wall,
                        "p50_s": p50, "p95_s": p95}
        rows.append((f"serving_{mode}", wall / n_tok * 1e6,
                     f"tok_s={n_tok/wall:.1f};p95={p95:.3f}s"))
    detail["continuous"]["occupancy"] = occupancy
    detail["continuous"]["decode_steps"] = steps
    detail["speedup_tok_s"] = (detail["continuous"]["tok_s"]
                               / detail["sequential"]["tok_s"])
    rows.append(("serving_speedup", 0.0,
                 f"x{detail['speedup_tok_s']:.2f};occupancy={occupancy:.2f};"
                 f"outputs_match={outputs_match}"))
    return rows, {"serving_batching": detail}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced request count/tokens (CI-speed)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--new-tokens", type=int, default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--assert-speedup", type=float, default=None,
                    help="exit nonzero unless continuous >= X times sequential "
                         "tok/s AND temperature-0 outputs are identical")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out = args.out or os.path.join(
        "results", "BENCH_torch_serving_batching_smoke.json" if args.smoke
        else "BENCH_torch_serving_batching.json")
    if os.path.basename(out).startswith("BENCH_serving_batching"):
        ap.error(f"--out {out}: that name belongs to the reference benchmark's results")
    n_req = args.requests if args.requests is not None else (12 if args.smoke else 16)
    n_new = args.new_tokens if args.new_tokens is not None else (8 if args.smoke else 16)
    rows, detail = bench_serving(n_requests=n_req, n_new=n_new,
                                 n_slots=args.slots, repeats=3,
                                 device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(detail, f, indent=1)
    sys.stderr.write(f"wrote {out}\n")

    d = detail["serving_batching"]
    if not d["outputs_match"]:
        sys.stderr.write("FAIL: batched and sequential temperature-0 outputs "
                         "differ\n")
        sys.exit(1)
    if args.assert_speedup is not None and d["speedup_tok_s"] < args.assert_speedup:
        sys.stderr.write(f"FAIL: continuous batching speedup "
                         f"x{d['speedup_tok_s']:.2f} < x{args.assert_speedup}\n")
        sys.exit(1)


if __name__ == "__main__":
    main()
