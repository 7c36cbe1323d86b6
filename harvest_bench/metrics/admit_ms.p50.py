"""Median host time of one ``add()`` in the window: from the call to the
first token on the host (the admission's prefill at batch 1, the graft into
the slot and the first pick), without the wait behind the admissions ahead
of it in the same gap, which the time to first token holds."""
from harvest_bench.harness.stats import quantile


def read(run):
    if not run.window.admit_s:
        return None
    return 1e3 * quantile(run.window.admit_s, 0.5)
