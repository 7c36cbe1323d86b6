"""Share, in %, of the MLA prefills at admission that ran the port's
``mla_prefill_attention`` kernel: the ``model.mla_prefill`` spans under
``engine.admit`` in the window's unprofiled part (``harness.program_spans``)
whose ``kernel`` count is 1. A span without the count ran the plain einsum,
which materialises the scores. None where the part holds no such span."""
import sys

from harvest_bench.harness import program_spans as ps


def read(run):
    s = ps.part(run, "mla_kernel_share")
    if s is None:
        return None
    layers = s.under("engine.admit", "model.mla_prefill")
    if not layers:
        print("mla_kernel_share: no MLA prefill under an admission: not read", file=sys.stderr)
        return None
    return 100.0 * sum(1 for r in layers if r.counts and r.counts.get("kernel") == 1) / len(layers)
