"""Median, over the window's admissions, of the float32 attention scores
that one MLA layer materialises at prefill: the ``score_bytes`` count of
an admission's ``model.mla_prefill`` spans (one a layer, each the same
B*H*S*S*4), in GiB. A prefill that never holds the whole score matrix
would read towards 0. Read over the window's unprofiled part
(``harness.program_spans``); None where the port has no such span."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "mla_score_gib.admit")
    if s is None:
        return None
    vals = []
    for admit in s.named("engine.admit"):
        layers = [m.counts["score_bytes"] for m in s.kids(admit, "model.mla_prefill")
                  if m.counts and "score_bytes" in m.counts]
        if layers:
            vals.append(max(layers))
    return quantile(vals, 0.5) / 2 ** 30 if vals else None
