"""Model FLOPs of every token served in the window (``harness.work.
ModelFlops``: each admission's prefill and each decoded token, at its
context, from the configuration) over the window's seconds and the card's
bf16 peak, 989e12 FLOP/s: the whole step's share of the chip's peak."""
from harvest_bench.harness.work import PEAK_FLOPS_BF16


def read(run):
    if not run.cuda or run.window.seconds <= 0:
        return None
    return 100.0 * run.window.flops.total / (run.window.seconds * PEAK_FLOPS_BF16)
