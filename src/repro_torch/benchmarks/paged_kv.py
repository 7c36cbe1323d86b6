"""Paged-KV benchmark of the port: dense vs block-paged cache at FIXED KV
memory.

Both engines get the same KV byte budget: the dense layout spends it on
``n_slots x max_seq`` preallocated rows, the paged layout on a pool of
fixed-size blocks (same total bytes, null block included). Requests carry a
shared tenant system prefix (``tenant_prefix``), so the paged engine
prefills it once and forks it per request; each request then only needs
blocks for its own suffix. The headline is ``slot_ratio``: at the same
cache memory the paged engine sustains that many times the concurrent
decode slots of dense, with temperature-0 token streams bit-identical on
the gather attention path (also across a drain()/resume cycle) and with the
prefix share cutting prefill tokens (``share_hit_rate > 0``).

A kernel leg re-serves a subset through the paged-attention kernel (the
CUDA kernel on the card, its plain version on the CPU): it must complete,
and its tokens are compared with the dense stream's (a near-tie argmax may
flip under another order of fp32 sums; bit identity is the gather path's
contract, checked above). It records the kernels' launches (read before
and after; the counters are not reset).

    PYTHONPATH=src python -m repro_torch.benchmarks.paged_kv \\
        [--device cpu] [--smoke] [--assert-slot-ratio X] \\
        [--assert-kernel-agreement Y] [--out PATH]

The twin of ``benchmarks/paged_kv.py``. It writes
``results/BENCH_torch_paged_kv[_smoke].json`` by default and refuses the
reference's result files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.model import init_params
from repro_torch.platform.executors import prompt_for_fn, tenant_prefix
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine


def _serve(eng, gens):
    """Drive to quiescence tracking peak concurrent slots; returns
    (wall_s, peak_slots, {id: tokens}). Each step ends in a host copy of
    the picked tokens, so the wall ends with the card synchronised."""
    t0 = time.perf_counter()
    for g in gens:
        eng.add(g)
    peak = len(eng.batcher.active())
    while eng.batcher.active():
        eng.step()
        peak = max(peak, len(eng.batcher.active()))
    wall = time.perf_counter() - t0
    done = {f.id: list(f.generated) for f in eng.batcher.finished}
    eng.batcher.finished.clear()
    return wall, peak, done


def bench_paged_kv(n_requests: int = 24, prompt_len: int = 24,
                   prefix_len: int = 16, n_new: int = 8,
                   dense_slots: int = 4, max_seq: int = 64,
                   block_size: int = 16, kernel_requests: int = 6,
                   arch: str = "qwen2.5-3b", device=None):
    """Returns (rows, detail) in the shape of ``benchmarks.run``'s entries;
    ``device`` ``None`` is the card."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    budget_tokens = dense_slots * max_seq          # the fixed memory budget
    n_blocks = budget_tokens // block_size         # same bytes, incl. null
    prefix = tenant_prefix("bench", cfg.vocab_size, prefix_len)
    prompts = [prompt_for_fn(f"bench-fn{i}", cfg.vocab_size, prompt_len,
                             prefix_len=prefix_len, tenant="bench")
               for i in range(n_requests)]

    def gens():
        return [GenRequest(id=i, prompt=list(p), max_new=n_new) for i, p in enumerate(prompts)]

    n_tok = n_requests * n_new

    dense = ContinuousEngine(cfg, params, n_slots=dense_slots, max_seq=max_seq, device=dev)
    paged = PagedContinuousEngine(cfg, params, n_slots=n_requests, max_seq=max_seq,
                                  block_size=block_size, n_blocks=n_blocks, device=dev)
    paged.register_prefix(prefix)
    if paged.kv_stats()["pool_bytes"] > dense.kv_stats()["pool_bytes"]:
        raise AssertionError("paged must not get more cache memory than dense")

    # warm-up both paths outside the timed region
    _serve(dense, gens()[:1])
    _serve(paged, gens()[:1])
    dense.prefill_tokens = 0
    paged.prefill_tokens = paged.shared_tokens = 0
    paged.share_hits = 0

    wall_d, peak_d, out_d = _serve(dense, gens())
    wall_p, peak_p, out_p = _serve(paged, gens())
    paged.kv.check()
    outputs_match = out_d == out_p
    st_d, st_p = dense.kv_stats(), paged.kv_stats()
    slot_ratio = peak_p / max(peak_d, 1)

    # drain()/resume: parked blocks are pinned and re-referenced; the
    # resumed streams must still equal the uninterrupted dense run
    resumed = PagedContinuousEngine(cfg, params, n_slots=n_requests, max_seq=max_seq,
                                    block_size=block_size, n_blocks=n_blocks, device=dev)
    resumed.register_prefix(prefix)
    for g in gens():
        resumed.add(g)
    for _ in range(3):
        resumed.step()
    parked = resumed.drain()
    for g in parked:
        resumed.add(g)
    _, _, out_r = _serve(resumed, [])
    out_r.update({f.id: list(f.generated) for f in resumed.batcher.finished})
    resume_match = out_r == out_d
    resumed.kv.check()

    # kernel leg: the paged-attention kernel (its plain version on the CPU)
    kern = PagedContinuousEngine(cfg, params, n_slots=kernel_requests, max_seq=max_seq,
                                 block_size=block_size, attn="kernel", device=dev)
    kern.register_prefix(prefix)
    before = launch_counts()
    _, _, out_k = _serve(kern, gens()[:kernel_requests])
    kernel_launches = {k: n - before[k] for k, n in launch_counts().items()}
    pairs = [(a, b) for i in range(kernel_requests) for a, b in zip(out_d[i], out_k[i])]
    kernel_agreement = sum(a == b for a, b in pairs) / len(pairs)
    kern.kv.check()

    detail = {
        "config": {"arch": arch, "n_requests": n_requests,
                   "prompt_len": prompt_len, "prefix_len": prefix_len,
                   "n_new": n_new, "max_seq": max_seq,
                   "block_size": block_size, "n_blocks": n_blocks,
                   "budget_tokens": budget_tokens},
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")},
        "dense": {"slots": peak_d, "wall_s": wall_d, "tok_s": n_tok / wall_d, "kv": st_d},
        "paged": {"slots": peak_p, "wall_s": wall_p, "tok_s": n_tok / wall_p, "kv": st_p,
                  "resume_hits": resumed.kv_stats()["resume_hits"]},
        "slot_ratio": slot_ratio,
        "outputs_match": outputs_match,
        "resume_outputs_match": resume_match,
        "prefill_tokens_saved": st_d["prefill_tokens"] - st_p["prefill_tokens"],
        "kernel_token_agreement": kernel_agreement,
        "kernel_launches": kernel_launches,
    }
    rows = [
        ("paged_kv_dense", wall_d / n_tok * 1e6,
         f"slots={peak_d};tok_s={n_tok/wall_d:.1f};"
         f"prefill_toks={st_d['prefill_tokens']}"),
        ("paged_kv_paged", wall_p / n_tok * 1e6,
         f"slots={peak_p};tok_s={n_tok/wall_p:.1f};"
         f"prefill_toks={st_p['prefill_tokens']};"
         f"share_hit_rate={st_p['share_hit_rate']:.2f};"
         f"blocks_hw={st_p['blocks_high_water']}"),
        ("paged_kv_ratio", 0.0,
         f"x{slot_ratio:.2f};outputs_match={outputs_match};"
         f"resume_match={resume_match};"
         f"kernel_agree={kernel_agreement:.2f}"),
    ]
    return rows, {"paged_kv": detail}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced request count (CI-speed)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--assert-slot-ratio", type=float, default=None,
                    help="exit nonzero unless paged sustains >= X times the "
                         "dense slot count at equal cache memory AND "
                         "temperature-0 outputs (incl. drain/resume) are "
                         "identical")
    ap.add_argument("--assert-kernel-agreement", type=float, default=None,
                    help="minimum token-agreement rate for the kernel leg")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out = args.out or os.path.join(
        "results", "BENCH_torch_paged_kv_smoke.json" if args.smoke
        else "BENCH_torch_paged_kv.json")
    if os.path.basename(out).startswith("BENCH_paged_kv"):
        ap.error(f"--out {out}: that name belongs to the reference benchmark's results")
    n_req = args.requests if args.requests is not None else (12 if args.smoke else 24)
    rows, detail = bench_paged_kv(n_requests=n_req, kernel_requests=4 if args.smoke else 6,
                                  device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(detail, f, indent=1)
    sys.stderr.write(f"wrote {out}\n")

    d = detail["paged_kv"]
    fail = []
    if not d["outputs_match"]:
        fail.append("paged (gather) and dense temperature-0 outputs differ")
    if not d["resume_outputs_match"]:
        fail.append("drain()/resume outputs differ from uninterrupted dense")
    if d["prefill_tokens_saved"] <= 0 or d["paged"]["kv"]["share_hit_rate"] <= 0:
        fail.append("prefix sharing saved no prefill tokens")
    if args.assert_slot_ratio is not None and d["slot_ratio"] < args.assert_slot_ratio:
        fail.append(f"slot ratio x{d['slot_ratio']:.2f} < x{args.assert_slot_ratio}")
    if (args.assert_kernel_agreement is not None
            and d["kernel_token_agreement"] < args.assert_kernel_agreement):
        fail.append(f"kernel agreement {d['kernel_token_agreement']:.2f} "
                    f"< {args.assert_kernel_agreement}")
    for msg in fail:
        sys.stderr.write(f"FAIL: {msg}\n")
    if fail:
        sys.exit(1)
    return detail


if __name__ == "__main__":
    main()
