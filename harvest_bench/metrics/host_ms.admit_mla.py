"""Median, over the window's admissions, of the host time inside MLA's
prefill: an admission's ``model.mla_prefill`` spans (one a layer) summed,
in ms. Against the admission's device time it shows whether allocating
the layers' multi-GiB score tensors holds the host inside attention. Read
over the window's unprofiled part (``harness.program_spans``); None where
the port has no such span."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "host_ms.admit_mla")
    if s is None:
        return None
    vals = [sum(m.end - m.start for m in layers)
            for layers in (s.kids(a, "model.mla_prefill") for a in s.named("engine.admit"))
            if layers]
    return quantile(vals, 0.5) / 1e6 if vals else None
