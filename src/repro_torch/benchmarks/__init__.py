"""Benchmarks of the port, run as modules (``python -m
repro_torch.benchmarks.<name>``); they write under ``results/BENCH_torch_*``
and never over a result file of ``repro``'s benchmarks."""
