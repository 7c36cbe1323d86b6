"""Elastic sharded serving grid: served-model-size x goodput under the
elastic_storm preemption day, migrating gangs vs lose-whole-replica gangs vs
single-node replicas.

The storm's pivotal ratio is calls (240 s) longer than the median idle window
(~210 s): a replica that dies with its first departing member almost never
finishes a call, so the comparison isolates what live shard + KV migration
buys. Bigger served models raise the stakes through ``form_warmup`` (the
tensor-parallel model load a re-formed gang must re-pay, scaled here at
100 MB/s of checkpoint bandwidth) and through the per-migration byte volume.

Cells per model size (same trace, workload, supply; only gang policy moves):

  - ``migrate`` — gangs resize in place on member departure (the tentpole).
  - ``lose``    — one eviction kills the replica; survivors re-form and
                  re-pay the model load.
  - ``single``  — gang_size=1: each harvested node is a whole replica (the
                  pre-gang serving model; no formation cost, no migration).

A separate leg drives the port's actual MigrationProtocol on one device
(``--device``, the card by default): a mid-stream 4 -> 2 gang shrink must
emit temperature-0 token streams identical to an uninterrupted run (the
mesh is the one device either way; the gang size is logical) and must
record nonzero migrations and migrated bytes.

    PYTHONPATH=src python -m repro_torch.benchmarks.elastic_serving \\
        [--device cpu] [--smoke] [--duration S] [--out PATH]

The twin of ``benchmarks/elastic_serving.py``. It writes
``results/BENCH_torch_elastic_serving[_smoke].json`` by default, refuses the
reference's result files, and exits nonzero if migration ever stops strictly
beating the lose-whole-replica baseline's goodput, or if the port's leg
loses a token.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Tuple

from repro_torch.platform import Platform, ScenarioConfig, nan_to_none

HOUR = 3600.0
Row = Tuple[str, float, str]

# served model size -> bytes on the wire; form_warmup = bytes / 100 MB/s
MODEL_SIZES = (("3b", 6e9), ("13b", 26e9))
LOAD_BW = 1e8
CELLS = ("migrate", "lose", "single")


def run_elastic_cell(cell: str, model_bytes: float, duration: float,
                     gang_size: int = 3, seed: int = 7) -> Dict:
    sc = ScenarioConfig.elastic_storm(
        duration=duration, gang_size=1 if cell == "single" else gang_size,
        seed=seed, migrate=(cell == "migrate"))
    if cell != "single":
        sc.platform.gang_params.update(model_bytes=model_bytes,
                                       form_warmup=model_bytes / LOAD_BW)
    t0 = time.perf_counter()
    p = Platform.build(sc)
    res = p.run()
    wall = time.perf_counter() - t0
    m = p.metrics
    oc = res.outcome_counts
    return {
        "wall_s": wall,
        "n_submitted": res.n_submitted,
        "goodput_s": res.goodput_s,
        "n_success": oc.get("success", 0),
        "n_failed": oc.get("failed", 0),
        "n_lost": oc.get("lost", 0),
        "n_timeout": oc.get("timeout", 0),
        "n_503": oc.get("503", 0),
        "n_migrations": m.total("gang_migrations_total"),
        "n_replica_losses": m.total("gang_replica_losses_total"),
        "migrated_gb": m.total("gang_migrated_bytes_total") / 1e9,
        "wire_gb": m.total("gang_wire_bytes_total") / 1e9,
        "p50_s": nan_to_none(res.response_p50),
        "p95_s": nan_to_none(res.response_p95),
    }


def torch_migration_cell(n_new: int = 8, device=None) -> Dict:
    """Drive the port's MigrationProtocol: golden uninterrupted gang-2 run vs
    a gang-4 run shrunk to 2 mid-stream on the SAME device, for the exact
    and the replay KV hand-off modes. ``device`` ``None`` is the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models.model import init_params
    from repro_torch.serving.batching import GenRequest

    dev = resolve_device(device)
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def reqs():
        rng = np.random.default_rng(3)
        return [GenRequest(id=i, prompt=rng.integers(
            0, cfg.vocab_size, size=5 + i).tolist(), max_new=n_new)
            for i in range(3)]

    def run_all(rep, rs):
        for r in rs:
            rep.add(r)
        return {r.id: list(r.generated) for r in rep.run()}

    golden = run_all(ElasticReplica(cfg, params, 2, n_slots=2, device=dev),
                     reqs())
    out: Dict = {"device": {"type": dev.type,
                            "name": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu")}}
    for mode in ("migrate", "replay"):
        rep = ElasticReplica(cfg, params, 4, n_slots=2, kv_mode=mode,
                             device=dev)
        rs = reqs()
        for r in rs:
            rep.add(r)
        for _ in range(4):
            rep.step()
        rec = rep.shrink(2)
        got = run_all(rep, [])
        out[mode] = {
            "tokens_equal": got == golden,
            "n_migrations": len(rep.migrations),
            "migrated_bytes": rep.migrated_bytes,
            "wire_bytes": rep.wire_bytes,
            "migration_wall_s": rec.wall_s,
            "n_requests_live": rec.n_requests_live,
        }
    return out


def _fmt(x) -> str:
    return "n/a" if nan_to_none(x) is None else f"{x:.3f}"


def bench_elastic(duration: float = 2 * HOUR,
                  device=None) -> Tuple[List[Row], Dict]:
    rows: List[Row] = []
    detail: Dict[str, Dict] = {}
    for size, mb in MODEL_SIZES:
        for cell in CELLS:
            c = run_elastic_cell(cell, mb, duration)
            detail[f"{size}_{cell}"] = c
            us = c["wall_s"] * 1e6 / max(c["n_submitted"], 1)
            rows.append((
                f"elastic_{size}_{cell}", us,
                f"goodput_s={c['goodput_s']:.0f};"
                f"success={c['n_success']};lost={c['n_lost']};"
                f"timeouts={c['n_timeout']};"
                f"migrations={c['n_migrations']:.0f};"
                f"losses={c['n_replica_losses']:.0f};"
                f"migrated_gb={c['migrated_gb']:.1f};"
                f"p95_s={_fmt(c['p95_s'])}"))
        gain = (detail[f"{size}_migrate"]["goodput_s"]
                - detail[f"{size}_lose"]["goodput_s"])
        rows.append((f"elastic_{size}_migrate_vs_lose", 0.0,
                     f"d_goodput_s={gain:+.0f}"))
    tx = torch_migration_cell(device=device)
    detail["torch_migration"] = tx
    for mode in ("migrate", "replay"):
        c = tx[mode]
        rows.append((
            f"elastic_torch_{mode}", c["migration_wall_s"] * 1e6,
            f"tokens_equal={c['tokens_equal']};"
            f"migrations={c['n_migrations']};"
            f"wire_bytes={c['wire_bytes']};live={c['n_requests_live']}"))
    return rows, {"elastic": detail}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="30 sim-minutes per cell (CI execution + invariant "
                         "check; the storm needs a few window generations "
                         "for the goodput gap to be stable)")
    ap.add_argument("--duration", type=float, default=None,
                    help="sim-seconds per cell (default 2 h; --smoke wins)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: "
                         "results/BENCH_torch_elastic_serving.json; --smoke "
                         "writes results/BENCH_torch_elastic_serving_smoke.json)")
    args = ap.parse_args(argv)
    duration = 30 * 60.0 if args.smoke else (args.duration or 2 * HOUR)
    out = args.out or ("results/BENCH_torch_elastic_serving_smoke.json"
                       if args.smoke else
                       "results/BENCH_torch_elastic_serving.json")
    if os.path.basename(out).startswith("BENCH_elastic_serving"):
        ap.error(f"--out {out}: that name belongs to the reference benchmark's results")
    rows, detail = bench_elastic(duration, device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    payload = {"duration_s": duration, **detail["elastic"]}
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    # acceptance invariants: migration must pay for itself at every served
    # model size, and the live protocol must not lose a token
    for size, _ in MODEL_SIZES:
        mig = detail["elastic"][f"{size}_migrate"]["goodput_s"]
        lose = detail["elastic"][f"{size}_lose"]["goodput_s"]
        if mig <= lose:
            raise SystemExit(
                f"elastic regression ({size}): migrating goodput {mig:.0f}s "
                f"<= lose-whole-replica {lose:.0f}s")
    tx = detail["elastic"]["torch_migration"]
    for mode in ("migrate", "replay"):
        if not tx[mode]["tokens_equal"]:
            raise SystemExit(f"elastic regression: {mode} hand-off lost "
                             f"temperature-0 token equality")
        if tx[mode]["n_migrations"] < 1:
            raise SystemExit(f"elastic regression: {mode} leg recorded no "
                             f"migrations")


if __name__ == "__main__":
    main()
