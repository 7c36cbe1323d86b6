"""The paper's scenario end to end with real decodes on the port: a
cluster's idle windows host pilot-job invokers that serve model inference
(bounded decodes of qwen2.5-3b) on the card. Virtual time advances by the
measured wall clock of each real decode.

This is HPC-Whisk as a serving system: dynamic registration, fast-lane
hand-off on preemption, Alg. 1 commercial fallback — with the FaaS function
being a bounded decode. Concurrent in-flight requests on an invoker are
aggregated onto one ``ContinuousEngine`` (per-slot decode positions, one
batched decode per token wave) through the ``batched-serving`` executor;
``--sequential`` runs one ``generate`` per request through ``serving``, and
``--paged`` runs a ``PagedContinuousEngine`` whose tenants fork a shared
prompt prefix. The engine runs ``kernel_impls="auto"``: the hand-written
CUDA kernels on the card, their plain versions on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.harvest_serving              # card, smoke config
    PYTHONPATH=src python -m repro_torch.launch.harvest_serving --full       # card, full width
    PYTHONPATH=src python -m repro_torch.launch.harvest_serving --device cpu --minutes 2

The twin of ``examples/harvest_serving.py``; the engine enters the platform
through the executor factory's ``engine=`` parameter.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, with_kernel_impls
from repro_torch.core import CommercialBackend, FaaSWrapper
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.platform import (Platform, PlatformSection, ScenarioConfig,
                                  SchedulingSection, TraceSection,
                                  WorkloadSection)
from repro_torch.serving.engine import (ContinuousEngine,
                                        PagedContinuousEngine, ServingEngine)

PROMPT_LEN, PREFIX_LEN, N_NEW, MAX_SEQ = 16, 8, 8, 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--qps", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sequential", action="store_true",
                    help="one generate() per request instead of continuous batching")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache; each tenant's functions share a prompt prefix")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke twin")
    args = ap.parse_args(argv)
    if args.sequential and args.paged:
        ap.error("--paged needs continuous batching (drop --sequential)")
    duration = args.minutes * 60.0

    print("loading model (the invoker warm-up the paper measures)...")
    device = resolve_device(args.device)
    cfg = with_kernel_impls(get_config("qwen2.5-3b", smoke=not args.full), "auto")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    params_ex = {"prompt_len": PROMPT_LEN, "n_new": N_NEW}
    if args.sequential:
        key = "serving"
        engine = ServingEngine(cfg, params, max_seq=MAX_SEQ, device=device)
    elif args.paged:
        key = "batched-serving"
        engine = PagedContinuousEngine(cfg, params, n_slots=args.slots,
                                       max_seq=MAX_SEQ, attn="kernel",
                                       device=device)
        params_ex["prefix_len"] = PREFIX_LEN
    else:
        key = "batched-serving"
        engine = ContinuousEngine(cfg, params, n_slots=args.slots,
                                  max_seq=MAX_SEQ, device=device)

    sc = ScenarioConfig(
        name="harvest_serving", duration=duration, seed=0,
        trace=TraceSection(seed=4),
        workload=WorkloadSection(qps=args.qps, n_functions=10),
        scheduling=SchedulingSection(model="fib"),
        platform=PlatformSection(executor=key,
                                 executor_params={"engine": engine, **params_ex}))
    # same construction path as sim-only runs; only the executor seam differs
    rt = Platform.build(sc)

    # Alg. 1 wrapper in front of the controller
    commercial = CommercialBackend(rt.sim, overhead=0.35, slowdown=1.176)
    FaaSWrapper(rt.sim, rt.controller, commercial)

    res = rt.run()
    done = [r for r in res.requests if r.outcome == "success"]
    rts = [r.response_time for r in done if r.response_time is not None]
    width = "full" if args.full else "smoke"
    print(f"\n{args.minutes:g} simulated minutes, {len(res.requests)} requests "
          f"({width} {cfg.arch_id} on {device})")
    print(f"  coverage          : {res.slurm_coverage:.1%} "
          f"(clairvoyant {res.sim_upper_bound:.1%})")
    print(f"  invoked / success : {res.invoked_share:.1%} / {res.success_share:.1%}")
    print(f"  outcomes          : {res.outcome_counts}")
    print(f"  pilots / evictions: {res.n_jobs_started} / {res.n_evicted}")
    if rts:
        print(f"  response p50      : {np.percentile(rts, 50):.3f}s "
              f"(real decode wall time inside virtual time)")
    if not args.sequential:
        print(f"  batched decode    : {engine.n_decode_steps} waves, "
              f"occupancy {engine.occupancy:.0%}" if engine.n_decode_steps else
              "  batched decode    : (no batched waves)")
        st = engine.kv_stats()
        print(f"  kv cache          : {st['layout']}, prefill tokens "
              f"{st['prefill_tokens']}, share hits {st['share_hits']}, "
              f"share hit rate {st['share_hit_rate']:.2f}")
    print(f"  executed tokens   : ~{len(done) * N_NEW} real greedy-decoded tokens")


if __name__ == "__main__":
    main()
