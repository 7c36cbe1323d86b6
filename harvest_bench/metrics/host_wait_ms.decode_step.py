"""Median host time of a decode step's pick: the port's ``engine.pick``
span under ``engine.step``, the pick and the tokens' copy to the host,
which waits for the card to finish the step. A faster host raises it.
Read over the window's unprofiled part (``harness.program_spans``)."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "host_wait_ms.decode_step")
    vals = ps.wait_ns(s) if s else []
    return quantile(vals, 0.5) / 1e6 if vals else None
