"""Share of the rows that the admissions' ``moe_gmm`` launches compute which
carry a token: the port's counts on its ``model.moe`` spans under
``engine.admit``, the picks (``rows``) over the buffer's rows at the static
worst case (``rows_launched``), summed. Read over the window's unprofiled
part (``harness.program_spans``)."""
from harvest_bench.harness import program_spans as ps


def read(run):
    s = ps.part(run, "moe_gmm_row_use.admit")
    return ps.row_use(s) if s else None
