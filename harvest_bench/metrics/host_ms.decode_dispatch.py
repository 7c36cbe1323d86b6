"""Median host time of a decode step's dispatch: the port's
``model.decode_step`` span under ``engine.step``, from the embedding to the
logits, the launches of every layer with no wait for the card. Read over
the window's unprofiled part (``harness.program_spans``)."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "host_ms.decode_dispatch")
    vals = ps.dispatch_ns(s) if s else []
    return quantile(vals, 0.5) / 1e6 if vals else None
