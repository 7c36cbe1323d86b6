"""Share, in %, of the decode steps whose dispatch replayed the port's CUDA
graphs: the ``model.decode_step`` spans under ``engine.step`` in the
window's unprofiled part (``harness.program_spans``) whose ``graphed``
count is 1. A port whose spans carry no ``graphed`` count (one from before
its decode graphs) gives nothing to read."""
import sys

from harvest_bench.harness import program_spans as ps


def read(run):
    s = ps.part(run, "decode_graph_share")
    if not s:
        return None
    steps = s.under("engine.step", "model.decode_step")
    flags = [r.counts["graphed"] for r in steps if r.counts and "graphed" in r.counts]
    if not flags:
        print("decode_graph_share: no decode step counts graphed: not read", file=sys.stderr)
        return None
    return 100.0 * sum(f == 1 for f in flags) / len(steps)
