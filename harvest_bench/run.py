"""Run one cell of the port's benchmark once and print one JSON line.

    python3 harvest_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the port is imported from its ``src/``). The
cell (``BENCHMARK.json``) names a configuration and a traffic mix. The run
makes the weights on the card from the seed, builds the port's
``ContinuousEngine`` (bf16, every kernel site on), warms up (the largest
prompt once, then the closed loop until every slot has turned over), and
measures the closed loop for ``--seconds``. Then it frees the engine and
holds a sample of the served tokens against the plain float32 reference
(``harness.check``). With ``--trace 0`` the line carries the end-to-end
metrics, with ``--trace 1`` the per-layer ones (``metrics/<name>.py``),
read over a profiled stretch of the window.

``--device cpu`` rehearses a run on the CPU with the port's smoke-size
model and each file's ``rehearsal`` section: every metric's name then
starts with ``cpu.``, and no device metric is read.

Exit codes: 0 with the line printed; 3 without the card(s) the cell asks
for; 4 when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once
the window has closed; 1 on any other failure. Only the first prints
anything on standard output.
"""
from __future__ import annotations

import time

_MONO_AT_IMPORT = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (from ``/proc``), 0 where
    unreadable: the interpreter's own start-up belongs to set-up."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def use_checkout() -> None:
    """Import the port from this checkout's ``src/`` and the harness from
    its root, and keep every cache inside the checkout at fixed paths."""
    cache = ROOT / "build" / "harvest_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal at smoke size; no device metric is read")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Served:
    """A run up to the close of its window; what the metric readers see
    (``metrics/__init__.py``)."""
    cell: Any
    weights: Dict
    window: Any
    setup_s: float
    memory_peak_bytes: int
    peak_window_bytes: Optional[int]
    trace: Optional[Dict]
    seed: int

    @property
    def cuda(self) -> bool:
        return not self.cell.rehearsal


def torch_seed(seed: int) -> int:
    return seed % 2 ** 63


def serve(cell, seed: int, seconds: float, trace: bool, started: float,
          fault: Optional[Callable] = None) -> Served:
    """Set up the cell, warm up and measure the window; ``started`` is the
    process's start on the monotonic clock. ``fault(engine)`` breaks the
    engine for the tests of the check."""
    import numpy as np
    import torch

    from harvest_bench.harness.loop import ClosedLoop
    from harvest_bench.harness.spec import port_config
    from harvest_bench.harness.trace import Tracer
    from harvest_bench.harness.traffic import Traffic
    from harvest_bench.harness.weights import make_weights
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    marks = [("imports", time.monotonic())]
    cuda = not cell.rehearsal
    device = torch.device("cuda" if cuda else "cpu")
    mix = cell.traffic
    cfg = port_config(cell.config, cell.rehearsal)
    weights = make_weights(cfg, torch_seed(seed), device)
    marks.append(("weights", time.monotonic()))
    engine = ContinuousEngine(cfg, weights, n_slots=mix["slots"], max_seq=mix["max_seq"],
                              eos_id=None, temperature=0.0, device=device)
    if fault is not None:
        fault(engine)
    traffic = Traffic(mix, cfg.vocab_size, seed)
    tracer = None
    if trace:
        tracer = Tracer(mix["profile"]["length_s"], seconds, cuda)
        tracer.warm()
    # the largest prompt once, so its shapes are seen before the window
    longest = np.random.default_rng([seed, 3]).integers(0, cfg.vocab_size,
                                                        size=mix["prompt"]["max"]).tolist()
    engine.add(GenRequest(id=-1, prompt=longest, max_new=2))
    engine.run()
    marks.append(("engine and the longest prompt (a first run's nvcc)", time.monotonic()))
    loop = ClosedLoop(engine, traffic, mix["clients"], cfg, spans=tracer)
    loop.warm_up()
    memory_peak = 0
    if cuda:
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.monotonic()))
    setup_s = marks[-1][1] - started
    parts = ", ".join(f"{name} {t - t0:.3f}" for (_, t0), (name, t) in
                      zip([("start", started)] + marks, marks))
    print(f"set-up {setup_s:.3f} s ({parts}); window of {seconds} s", file=sys.stderr)
    window = loop.run(seconds)
    peak_window = None
    if cuda:
        peak_window = torch.cuda.max_memory_allocated()
        memory_peak = max(memory_peak, peak_window)
    if tracer:
        tracer.finish()
    return Served(cell, weights, window, setup_s, memory_peak, peak_window,
                  tracer.result if tracer else None, seed)


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


TAIL = re.compile(r"(latency|ttft)_p(\d\d)_(s|ms)")


def end_to_end(s: Served, names: List[str]) -> Dict[str, float]:
    """The end-to-end metrics ``names``: ``tokens_per_s``, ``setup_s``, and
    tails named ``latency_p<q>_<unit>`` (send -> last token) or
    ``ttft_p<q>_<unit>`` (send -> first token), each the ``q``-th
    percentile over every request sent in the window."""
    from harvest_bench.harness.stats import latencies, quantile
    w = s.window
    out = {}
    for name in names:
        tail = TAIL.fullmatch(name)
        if name == "tokens_per_s":
            out[name] = w.tokens / w.seconds
        elif name == "setup_s":
            out[name] = s.setup_s
        elif tail is None:
            raise ValueError(f"no reading for the end-to-end metric {name!r}")
        else:
            kind, q, unit = tail.groups()
            if kind == "latency":
                vals = latencies([x.send for x in w.sent], [x.end for x in w.sent], w.stop)
            else:
                vals = [x.first - x.send for x in w.sent]
            out[name] = quantile(vals, int(q) / 100) * (1e3 if unit == "ms" else 1.0)
    return out


def load_reader(name: str):
    path = ROOT / "harvest_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"harvest_bench_metric_{len(sys.modules)}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bench_metrics(kind: str, cell_name: str) -> List[Dict]:
    from harvest_bench.harness.spec import read_json
    bench = read_json(ROOT / "BENCHMARK.json")
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def per_layer(s: Served) -> Dict[str, float]:
    out = {}
    for m in bench_metrics("per_layer", s.cell.name):
        value = load_reader(m["name"])(s)
        if value is not None:
            out[m["name"]] = value
    return out


def result_line(s: Served, trace: bool, checks: Dict[str, Dict[str, float]],
                failed: int) -> Dict:
    import torch
    kind = "end_to_end" if not trace else "per_layer"
    units = {m["name"]: m["unit"] for m in bench_metrics(kind, s.cell.name)}
    values = per_layer(s) if trace else end_to_end(s, list(units))
    prefix = "cpu." if s.cell.rehearsal else ""
    metrics = {prefix + k: {"value": v, "unit": units[k]} for k, v in values.items()
               if k in units}
    if s.cell.rehearsal:
        device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": s.cell.chips, "memory_peak_bytes": s.memory_peak_bytes}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": len(s.window.sent), "failed": failed, "metrics": metrics,
            "device": device}
    if trace and s.trace and s.trace["kernels"]:
        device.update(busy_s=s.trace["busy_s"], window_s=s.trace["window_s"])
        line["breakdown"] = s.trace["breakdown"]
    line["checks"] = checks
    return line


def judge(s: Served) -> Dict[str, Dict[str, float]]:
    """Free the program's state and compare; returns each number with its
    limit."""
    from harvest_bench.harness.check import compare
    finished = [x.req for x in s.window.finished]
    malformed = sum(len(r.generated) != r.max_new for r in finished)
    free_device()
    numbers = compare(s.weights, s.cell.config, finished, s.seed,
                      s.cell.traffic["check"]["served_tokens"], s.cell.rehearsal)
    print(f"compared {numbers['sampled']} requests, {numbers['served_tokens']} served tokens; "
          f"gap_max {numbers['gap_max']!r}, flip_share {numbers['flip_share']!r} "
          f"(not compared)", file=sys.stderr)
    return {"gap_mean": {"value": numbers["gap_mean"], "limit": s.cell.limits["gap_mean"]},
            "malformed_requests": {"value": malformed, "limit": 0}}


def main(argv: Optional[List[str]] = None, fault: Optional[Callable] = None,
         started: Optional[float] = None) -> int:
    args = parse(argv)
    started = _MONO_AT_IMPORT - process_age() if started is None else started
    use_checkout()
    import torch

    from harvest_bench.harness.spec import load_cell

    cell = load_cell(args.workload, rehearsal=args.device == "cpu")
    if not cell.rehearsal and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 3
    with torch.no_grad():
        s = serve(cell, args.seed, args.seconds, bool(args.trace), started, fault)
        found = forbidden_modules()
        if found:
            print(f"loaded in the measuring process: {found}", file=sys.stderr)
            return 4
        checks = judge(s)
    line = result_line(s, bool(args.trace), checks,
                       checks["malformed_requests"]["value"])
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
