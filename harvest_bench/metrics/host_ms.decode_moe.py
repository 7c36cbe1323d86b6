"""Median, over decode steps, of the host time of the step's MoE layers:
the port's ``model.moe`` spans inside the step's dispatch, summed per step.
Read over the window's unprofiled part (``harness.program_spans``)."""
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.stats import quantile


def read(run):
    s = ps.part(run, "host_ms.decode_moe")
    vals = ps.moe_ns(s) if s else []
    return quantile(vals, 0.5) / 1e6 if vals else None
