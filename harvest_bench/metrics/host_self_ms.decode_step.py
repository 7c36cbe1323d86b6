"""Median self time of a decode step: the port's ``engine.step`` span less
its children (the dispatch, the pick, any admission), the batcher's
bookkeeping and the per-step copies of positions and tokens to the card.
Read over the window's unprofiled part (``harness.program_spans``)."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "host_self_ms.decode_step")
    vals = ps.self_ns(s) if s else []
    return quantile(vals, 0.5) / 1e6 if vals else None
